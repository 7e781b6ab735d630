"""Build/load façade (counterpart of ``spfresh_tpu/index/builder.py``,
single device).

``build`` runs clustering -> posting lists -> (optional) save, with the
reference's balance cap default ``desired_cluster_size = round(0.18 * n)``
unless the config overrides it.  Everything runs on the builder's
``device`` (default ``"cuda"``).  In-core, the clustering phase's device
corpus is handed to the index so the first search view packs its slabs on
the device.  With ``Config.build_sample_rows`` set the build is out-of-core
(``clustering.outofcore``): the corpus (an ndarray or an ``np.memmap``)
stays on the host, and the postings stay lazy views over it.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from spfresh_tpu_torch.clustering.hierarchical import HierarchicalClustering
from spfresh_tpu_torch.clustering.outofcore import DEFAULT_TILE_ROWS, OutOfCoreResult, fit_outofcore
from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from spfresh_tpu_torch.index.config import Config
from spfresh_tpu_torch.index.spann import SpannIndex
from spfresh_tpu_torch.utils.profiling import PhaseTimer

log = logging.getLogger(__name__)


class SpannIndexBuilder:
    def __init__(self, config: Config | str, device: torch.device | str = DEFAULT_DEVICE):
        self.config = Config.from_file(config) if isinstance(config, str) else config
        self.config.validate()
        self.device = resolve_device(device)
        self.data: Optional[np.ndarray] = None
        self.outofcore: Optional[OutOfCoreResult] = None

    def with_data(self, data) -> "SpannIndexBuilder":
        self.data = np.asarray(data, dtype=np.float32)
        if self.data.ndim != 2:
            raise ValueError(f"data must be 2-d, got shape {self.data.shape}")
        return self

    def build(self, dim: Optional[int] = None, save: bool = True) -> SpannIndex:
        """Cluster, create the posting lists, and save unless ``save`` is
        False.  ``dim`` is an optional check of the data's width."""
        if self.data is None:
            raise ValueError("no data provided; call with_data() first")
        n, d = self.data.shape
        if dim is not None and dim != d:
            raise ValueError(f"data dimension {d} does not match requested dim {dim}")
        params = self.config.to_clustering_params()
        if params.desired_cluster_size is None:
            params.desired_cluster_size = max(1, int(round(0.18 * n)))
        if self.config.build_sample_rows is not None:
            return self._build_outofcore(params, save)
        log.info(
            "building SPANN index: n=%d d=%d k=%d cap=%d metric=%s device=%s",
            n, d, params.initial_k, params.desired_cluster_size, params.metric, self.device,
        )
        hc = HierarchicalClustering(params, self.data, device=self.device).fit()
        index = SpannIndex(self.config, device=self.device)
        index.build_profile = {name: total for name, total, _ in hc._timer.totals()}
        # Float storage keeps the caller's exact corpus on the host (the saved
        # f32 bytes must not degrade to the bf16 grid); the device corpus
        # carries the build's rounding, which bf16 storage re-applies
        # idempotently.  int8 storage quantizes residuals, so the host
        # postings take the clusterer's rounded mirror, as in the JAX
        # package: a view packed from the host then equals one packed from
        # the device corpus.
        host_src = hc._host_data if self.config.storage_dtype == "int8" else self.data
        index.create_posting_lists(hc.clusters, host_src, corpus_dev=hc.data)
        if save:
            index.save(self.config.output_path)
        return index

    def _build_outofcore(self, params, save: bool) -> SpannIndex:
        """Sample fit on the device, two streamed passes over the host
        corpus; the index's postings are lazy views over that corpus, so it
        never holds a stored-x copy of it.  The fit's result (clusters,
        base assignment, sample size, splits) stays on ``self.outofcore``."""
        tile_rows = self.config.build_tile_rows or DEFAULT_TILE_ROWS
        n, d = self.data.shape
        log.info("building SPANN index out-of-core: n=%d d=%d sample=%d tile=%d device=%s",
                 n, d, self.config.build_sample_rows, tile_rows, self.device)
        timer = PhaseTimer(self.device)
        self.outofcore = fit_outofcore(params, self.data, self.config.build_sample_rows,
                                       tile_rows=tile_rows, timer=timer, device=self.device)
        index = SpannIndex(self.config, device=self.device)
        index.build_profile = {name: total for name, total, _ in timer.totals()}
        index.create_posting_lists(self.outofcore.clusters, self.data, lazy_host=True)
        if save:
            index.save(self.config.output_path)
        return index

    def load(self, dim: Optional[int] = None) -> SpannIndex:
        index = SpannIndex.load(self.config.output_path, self.config, device=self.device)
        if dim is not None and index.dim != dim:
            raise ValueError(f"loaded index dim {index.dim} does not match requested dim {dim}")
        return index
