"""Index configuration (counterpart of ``spfresh_tpu/index/config.py``).

Same schema, keys, defaults and ``validate()`` as the JAX package, so a
``Config.to_dict()`` from either package loads in the other.  ``yaml`` is
imported only inside ``from_file``: the GPU machine may not have it.

The one key the port keeps for format compatibility but does not act on:
``search.engine`` (the port has one search pipeline: the slab rerank
kernel on CUDA, its plain version on the CPU).  ``build_sample_rows``
(the out-of-core build: a sample fit, then streamed passes of
``build_tile_rows`` rows, default 65,536, over a host corpus),
``storage_dtype: int8`` (residual IVF-SQ8) and the ``search.query_wire``
values ``bfloat16`` and ``int8`` act as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from spfresh_tpu_torch.clustering.hierarchical import ClusteringParams, canonical_init
from spfresh_tpu_torch.ops.distances import canonical_metric


@dataclasses.dataclass
class SearchConfig:
    nprobe: Optional[int] = None  # None -> nprobe = k (reference behavior)
    prune_factor: Optional[float] = None  # e.g. 1.2 for reference-style pruning
    query_batch_size: int = 4096
    engine: str = "auto"
    # Spare member slots per posting slab (pad headroom for live inserts).
    slab_growth_slots: int = 16
    query_wire: Optional[str] = None

    def validate(self) -> None:
        if self.query_wire not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(
                "search.query_wire must be None, 'float32', 'bfloat16', "
                "or 'int8'"
            )
        if self.slab_growth_slots < 0:
            raise ValueError("search.slab_growth_slots must be >= 0")
        if self.nprobe is not None and self.nprobe <= 0:
            raise ValueError("search.nprobe must be > 0")
        if self.prune_factor is not None and self.prune_factor < 1.0:
            raise ValueError("search.prune_factor must be >= 1.0")
        if self.query_batch_size <= 0:
            raise ValueError("search.query_batch_size must be > 0")
        if self.engine not in ("auto", "pallas", "xla"):
            raise ValueError("search.engine must be 'auto', 'pallas', or 'xla'")


@dataclasses.dataclass
class Config:
    distance_metric: str = "Euclidean"
    initialization_method: str = "Random"
    initial_k: int = 4
    output_path: str = "data"
    data_file: Optional[str] = None
    desired_cluster_size: Optional[int] = None  # None -> round(0.18 * n)
    rng_seed: Optional[int] = None
    replication: str = "final"
    max_replicas: int = 4
    boundary_threshold: float = 1.1
    replica_overflow: float = 1.25
    max_split_ways: int = 8
    # None = AUTO: lambda 0.5 on Euclidean, off otherwise.
    soar_lambda: Optional[float] = None
    storage_dtype: str = "float32"  # or "bfloat16" or "int8"
    build_sample_rows: Optional[int] = None
    build_tile_rows: Optional[int] = None
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)

    _TOP_KEYS = frozenset({
        "output_path", "data_file", "storage_dtype",
        "build_sample_rows", "build_tile_rows",
    })
    _CP_KEYS = frozenset({
        "distance_metric", "initialization_method", "initial_k",
        "desired_cluster_size", "rng_seed", "replication", "max_replicas",
        "boundary_threshold", "replica_overflow", "max_split_ways",
        "soar_lambda",
    })
    _SC_KEYS = frozenset({
        "nprobe", "prune_factor", "query_batch_size", "engine",
        "slab_growth_slots", "query_wire",
    })

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        raw = dict(raw or {})
        cp = dict(raw.pop("clustering_params", {}) or {})
        sc = dict(raw.pop("search", {}) or {})
        for name, got, ok in (
            ("config", raw.keys(), cls._TOP_KEYS),
            ("clustering_params", cp.keys(), cls._CP_KEYS),
            ("search", sc.keys(), cls._SC_KEYS),
        ):
            unknown = sorted(set(got) - ok)
            if unknown:
                raise ValueError(
                    f"unknown {name} key(s) {unknown}; valid: {sorted(ok)}"
                )
        cfg = cls(
            distance_metric=cp.get("distance_metric", "Euclidean"),
            initialization_method=cp.get("initialization_method", "Random"),
            initial_k=int(cp.get("initial_k", 4)),
            output_path=raw.get("output_path", "data"),
            data_file=raw.get("data_file"),
            desired_cluster_size=cp.get("desired_cluster_size"),
            rng_seed=cp.get("rng_seed"),
            replication=cp.get("replication", "final"),
            max_replicas=int(cp.get("max_replicas", 4)),
            boundary_threshold=float(cp.get("boundary_threshold", 1.1)),
            replica_overflow=float(cp.get("replica_overflow", 1.25)),
            max_split_ways=int(cp.get("max_split_ways", 8)),
            soar_lambda=(
                float(cp["soar_lambda"])
                if cp.get("soar_lambda") is not None
                else None
            ),
            storage_dtype=raw.get("storage_dtype", "float32"),
            build_sample_rows=(
                int(raw["build_sample_rows"])
                if raw.get("build_sample_rows") is not None
                else None
            ),
            build_tile_rows=(
                int(raw["build_tile_rows"])
                if raw.get("build_tile_rows") is not None
                else None
            ),
            search=SearchConfig(
                nprobe=sc.get("nprobe"),
                prune_factor=sc.get("prune_factor"),
                query_batch_size=int(sc.get("query_batch_size", 4096)),
                engine=sc.get("engine", "auto"),
                slab_growth_slots=int(sc.get("slab_growth_slots", 16)),
                query_wire=sc.get("query_wire"),
            ),
        )
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "Config":
        import yaml

        with open(path, "r") as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw or {})

    def validate(self) -> None:
        canonical_metric(self.distance_metric)
        canonical_init(self.initialization_method)
        if self.initial_k <= 0:
            raise ValueError("initial_k must be greater than 0")
        if self.desired_cluster_size is not None and self.desired_cluster_size <= 0:
            raise ValueError("desired_cluster_size must be greater than 0")
        if self.storage_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                "storage_dtype must be 'float32', 'bfloat16' or 'int8'"
            )
        if self.soar_lambda is not None:
            if self.soar_lambda < 0:
                raise ValueError("soar_lambda must be >= 0")
            if self.soar_lambda and canonical_metric(self.distance_metric) != "Euclidean":
                raise ValueError("soar_lambda requires the Euclidean metric")
        if self.build_sample_rows is not None and self.build_sample_rows <= 0:
            raise ValueError("build_sample_rows must be greater than 0")
        if self.build_tile_rows is not None and self.build_tile_rows <= 0:
            raise ValueError("build_tile_rows must be greater than 0")
        self.search.validate()

    def to_clustering_params(self) -> ClusteringParams:
        return ClusteringParams(
            metric=canonical_metric(self.distance_metric),
            initialization_method=canonical_init(self.initialization_method),
            desired_cluster_size=self.desired_cluster_size,
            initial_k=self.initial_k,
            rng_seed=self.rng_seed,
            replication=self.replication,
            max_replicas=self.max_replicas,
            boundary_threshold=self.boundary_threshold,
            replica_overflow=self.replica_overflow,
            max_split_ways=self.max_split_ways,
            # None = auto: SOAR on for Euclidean builds, off for L1/Linf.
            soar_lambda=(
                self.soar_lambda
                if self.soar_lambda is not None
                else (
                    0.5
                    if canonical_metric(self.distance_metric) == "Euclidean"
                    else None
                )
            ),
            # Non-f32 storage builds from the bf16-rounded corpus, as the
            # JAX package does (its bf16 corpus wire).
            wire_dtype=(
                "bfloat16" if self.storage_dtype != "float32" else None
            ),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "clustering_params": {
                "distance_metric": self.distance_metric,
                "initialization_method": self.initialization_method,
                "initial_k": self.initial_k,
                "desired_cluster_size": self.desired_cluster_size,
                "rng_seed": self.rng_seed,
                "replication": self.replication,
                "max_replicas": self.max_replicas,
                "boundary_threshold": self.boundary_threshold,
                "replica_overflow": self.replica_overflow,
                "max_split_ways": self.max_split_ways,
                "soar_lambda": self.soar_lambda,
            },
            "output_path": self.output_path,
            "data_file": self.data_file,
            "storage_dtype": self.storage_dtype,
            "build_sample_rows": self.build_sample_rows,
            "build_tile_rows": self.build_tile_rows,
            "search": {
                "nprobe": self.search.nprobe,
                "prune_factor": self.search.prune_factor,
                "query_batch_size": self.search.query_batch_size,
                "engine": self.search.engine,
                "slab_growth_slots": self.search.slab_growth_slots,
                "query_wire": self.search.query_wire,
            },
        }
