"""Build/load façade (counterpart of ``spfresh_tpu/index/builder.py``).

``build`` runs clustering -> posting lists -> (optional) save, with the
reference's balance cap default ``desired_cluster_size = round(0.18 * n)``
unless the config overrides it.  Everything runs on the builder's
``device`` (default ``"cuda"``), or, with ``devices``, data-sharded over a
list of device entries (``_resolve_devices``; the counterpart of the JAX
package's ``mesh``), with the clusters of a single-device build; the index
then lives on the first entry.  In-core, the clustering phase's device
corpus is handed to the index so the first search view packs its slabs on
the device (a device list hands the first entry's full copy in the
``"replicated"`` corpus layout, nothing in the ``"sharded"`` one).  With
``Config.build_sample_rows`` set the build is out-of-core
(``clustering.outofcore``, its streamed passes dealt over ``devices``):
the corpus (an ndarray or an ``np.memmap``) stays on the host, and the
postings stay lazy views over it.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from spfresh_tpu_torch.clustering.hierarchical import HierarchicalClustering
from spfresh_tpu_torch.clustering.outofcore import DEFAULT_TILE_ROWS, OutOfCoreResult, fit_outofcore
from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device, resolve_entries
from spfresh_tpu_torch.index.config import Config
from spfresh_tpu_torch.index.spann import SpannIndex
from spfresh_tpu_torch.utils.profiling import PhaseTimer

log = logging.getLogger(__name__)


def _resolve_devices(devices) -> Optional[List[torch.device]]:
    """The build's device list: None; ``"auto"`` (every CUDA device when
    there are more than one, else None); an int k (the first k CUDA
    devices; raises if fewer are visible); or a list of entries (an entry
    may repeat a device).  None or a single entry means the single-device
    path."""
    if devices is None:
        return None
    if isinstance(devices, str):
        if devices != "auto":
            raise ValueError(f"devices must be None, 'auto', an int or a list; got {devices!r}")
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(count)] if count > 1 else None
    if isinstance(devices, int):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices > count:
            raise ValueError(f"devices={devices} CUDA devices requested, {count} available")
        return [torch.device("cuda", i) for i in range(devices)] if devices > 0 else None
    return resolve_entries(devices)


class SpannIndexBuilder:
    def __init__(self, config: Config | str, device: torch.device | str = DEFAULT_DEVICE,
                 devices=None, corpus_layout: str = "sharded"):
        """``devices`` (see ``_resolve_devices``): build over a device list;
        its first entry takes the place of ``device``.  ``corpus_layout``
        (device lists only): ``"sharded"`` keeps n/S corpus rows an entry,
        ``"replicated"`` a full copy on each and hands the first one to the
        index's view pack."""
        if corpus_layout not in ("sharded", "replicated"):
            raise ValueError(f"unknown corpus_layout {corpus_layout!r}")
        self.config = Config.from_file(config) if isinstance(config, str) else config
        self.config.validate()
        self.devices = _resolve_devices(devices)
        if self.devices is not None:
            device = self.devices[0]
            if len(self.devices) == 1:
                self.devices = None
        self.device = resolve_device(device)
        self.corpus_layout = corpus_layout
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
            "building SPANN index: n=%d d=%d k=%d cap=%d metric=%s device=%s entries=%d",
            n, d, params.initial_k, params.desired_cluster_size, params.metric, self.device,
            len(self.devices) if self.devices else 1,
        )
        hc = HierarchicalClustering(params, self.data, device=self.device, devices=self.devices,
                                    corpus_layout=self.corpus_layout).fit()
        index = SpannIndex(self.config, device=self.device)
        index.build_profile = {name: total for name, total, _ in hc._timer.totals()}
        # Float storage keeps the caller's exact corpus on the host (the saved
        # f32 bytes must not degrade to the bf16 grid); the device corpus
        # carries the build's rounding, which bf16 storage re-applies
        # idempotently.  int8 storage quantizes residuals, so the host
        # postings take the clusterer's rounded mirror, as in the JAX
        # package: a view packed from the host then equals one packed from
        # the device corpus.
        # A row-sharded corpus has no full copy anywhere (hc.data is None):
        # the view pack then stages from the host.
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
        log.info("building SPANN index out-of-core: n=%d d=%d sample=%d tile=%d device=%s "
                 "entries=%d", n, d, self.config.build_sample_rows, tile_rows, self.device,
                 len(self.devices) if self.devices else 1)
        timer = PhaseTimer(self.device)
        self.outofcore = fit_outofcore(params, self.data, self.config.build_sample_rows,
                                       tile_rows=tile_rows, timer=timer, device=self.device,
                                       devices=self.devices)
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
