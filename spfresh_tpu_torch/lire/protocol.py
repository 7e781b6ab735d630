"""LIRE update protocol — the front stage of SPFresh updates (counterpart
of ``spfresh_tpu/lire/protocol.py``; the Rust reference's ``protocol.rs``
with its stubs completed).

insert/delete are synchronous appends/tombstones plus *real* maintenance
scheduling: ``schedule_maintenance`` submits Split/Merge/GC to the background
pipeline (the reference's is a no-op stub, protocol.rs:114-118) and
``get_nearby_postings`` returns the actual nearest postings by centroid
distance (stubbed empty in the reference, protocol.rs:139-143).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from spfresh_tpu_torch.lire.operations import (
    Merge,
    Reassign,
    Split,
    _dist,
)
from spfresh_tpu_torch.lire.pipeline import TwoStagePipeline
from spfresh_tpu_torch.lire.storage import LireStorage
from spfresh_tpu_torch.ops.distances import pairwise_distance
from spfresh_tpu_torch.utils import metrics

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LireConfig:
    """Mirror of LireConfig (protocol.rs:11-31) — same defaults."""

    max_partition_size: int = 10_000
    min_partition_size: int = 1_000
    nearby_posting_count: int = 64
    gc_threshold: float = 0.3


@dataclasses.dataclass
class UpdateResult:
    """Mirror of UpdateResult (protocol.rs:35-42)."""

    vectors_reassigned: int
    partitions_affected: List[int]
    version: int


class LireProtocol:
    """Mirror of LireProtocol (protocol.rs:51-143)."""

    #: Below this posting count the (C, d) mat-vec runs in numpy; above it
    #: the scan runs on ``device`` through ``ops.distances.pairwise_distance``
    #: (the device pays one centroid upload per TOPOLOGY change, not per op).
    DEVICE_ROUTE_MIN_C = 8192

    def __init__(
        self,
        storage: LireStorage,
        config: Optional[LireConfig] = None,
        pipeline: Optional[TwoStagePipeline] = None,
        metric: str = "Euclidean",
        device: torch.device | str = DEFAULT_DEVICE,
    ):
        self.storage = storage
        self.config = config or LireConfig()
        self.pipeline = pipeline
        self.metric = metric
        self.device = resolve_device(device)
        self._route_cache = None  # (topology_gen, pids, cents_np, cents_dev)

    # -- updates (protocol.rs:65-99) ---------------------------------------

    def insert(self, vector: np.ndarray, vector_id: int, posting_id: Optional[int] = None) -> UpdateResult:
        from spfresh_tpu_torch.lire.storage import LireStorageError

        vector = np.asarray(vector, np.float32).reshape(-1)
        routed = posting_id is None
        for _ in range(8):
            if posting_id is None:
                posting_id = self.find_nearest_partition(vector)
                if posting_id is None:
                    raise ValueError("no postings exist; build an index first")
            try:
                version = self.storage.store_vector(posting_id, vector_id, vector)
                break
            except LireStorageError:
                if not routed:
                    raise
                # The routed-to posting was retired by a concurrent background
                # split/merge between routing and the append (storage refuses
                # to resurrect it as an orphan) — re-route to the CURRENT
                # nearest partition and retry.
                posting_id = None
        else:
            raise LireStorageError(
                "insert: nearest partition kept being retired; giving up"
            )
        metrics.inc("lire.insert")
        if self.needs_split(posting_id):
            self.schedule_maintenance(Split(posting_id))
        return UpdateResult(0, [posting_id], version)

    def delete(self, vector_id: int, posting_id: int) -> UpdateResult:
        version = self.storage.mark_deleted(posting_id, vector_id)
        metrics.inc("lire.delete")
        if self.needs_merge(posting_id):
            merge = self._plan_merge(posting_id)
            if merge is not None:
                self.schedule_maintenance(merge)
        if self.storage.needs_garbage_collection(posting_id, self.config.gc_threshold):
            self.storage.collect_garbage(posting_id)
        return UpdateResult(0, [posting_id], version)

    def _plan_merge(self, posting_id: int):
        """Merge op for an undersized posting, or None.  The target is the
        nearest partition that can absorb it without exceeding
        max_partition_size (an unbounded merge would mint a posting that
        immediately re-splits)."""
        budget = self.config.max_partition_size - self.storage.get_vector_count(
            posting_id
        )
        target = self._nearest_other_partition(posting_id, max_count=budget)
        if target is None:
            return None
        return Merge(posting_id, target, max_size=self.config.max_partition_size)

    # -- triggers (protocol.rs:102-111) ------------------------------------

    def needs_split(self, posting_id: int) -> bool:
        return self.storage.get_vector_count(posting_id) > self.config.max_partition_size

    def needs_merge(self, posting_id: int) -> bool:
        return self.storage.get_vector_count(posting_id) < self.config.min_partition_size

    # -- maintenance (real, not the reference's no-op stub) ----------------

    def schedule_maintenance(self, op) -> bool:
        """Submit an op to the background stage; returns False when no
        pipeline is attached or an op on the same partition is already in
        flight (every insert past the threshold would otherwise enqueue a
        duplicate Split that fails once the first one retires the posting)."""
        if self.pipeline is None or not self.pipeline.is_running:
            log.debug("no running pipeline; %s not scheduled", type(op).__name__)
            return False
        from spfresh_tpu_torch.lire.pipeline import PartitionStatus

        affected = op.get_affected_partitions()
        for pid in affected:
            if self.pipeline.get_partition_status(pid) == PartitionStatus.PROCESSING:
                # Don't silently drop pending maintenance: the trigger (the
                # insert/delete that crossed the threshold) may never
                # re-fire.  The in-flight op's completion surfaces these as
                # NEEDS_MAINTENANCE for the repair loop.
                self.pipeline.defer_recheck(affected)
                return False
        self.pipeline.submit_task(op)
        return True

    # -- partition lookup (protocol.rs:121-136) ----------------------------

    def _router(self):
        """Packed routing view, cached per storage TOPOLOGY generation:
        steady-state inserts/deletes/tombstones never rebuild it (only
        posting creation/retirement and centroid moves bump the
        generation).  The device copy uploads once per topology change and
        serves the (C, d) scans when C is large."""
        gen, pids, cents = self.storage.centroid_matrix()
        rc = self._route_cache
        if rc is None or rc[0] != gen:
            dev = None
            if len(pids) >= self.DEVICE_ROUTE_MIN_C:
                dev = torch.from_numpy(np.ascontiguousarray(cents, np.float32)).to(self.device)
            rc = (gen, pids, cents, dev)
            self._route_cache = rc
        return rc

    def _route_dists(self, query_vec: np.ndarray, snap) -> np.ndarray:
        """(C,) centroid distances for one query, device-scanned at large C.

        ``snap`` is the caller's ``_router()`` snapshot: taking a fresh one
        here raced concurrent topology changes — a pipeline split landing
        between the caller's snapshot and this scan grew the centroid
        matrix, so ``argmin(d)`` could index one past the caller's ``pids``
        (caught by the threaded stress suite as an IndexError on insert)."""
        _, pids, cents, dev = snap
        if dev is not None:
            q = torch.from_numpy(np.ascontiguousarray(query_vec[None, :], np.float32))
            return pairwise_distance(q.to(self.device), dev, self.metric).cpu().numpy()[0]
        return _dist(self.metric, cents, query_vec[None, :])

    def find_nearest_partition(self, vector: np.ndarray) -> Optional[int]:
        snap = self._router()
        _, pids, _, _ = snap
        if len(pids) == 0:
            return None
        d = self._route_dists(np.asarray(vector, np.float32), snap)
        return int(pids[int(np.argmin(d))])

    def _nearest_other_partition(
        self, posting_id: int, max_count: Optional[int] = None
    ) -> Optional[int]:
        from spfresh_tpu_torch.lire.storage import LireStorageError

        try:
            me = self.storage.get_posting_centroid(posting_id)
        except LireStorageError:
            return None
        snap = self._router()
        _, pids, _, _ = snap
        if len(pids) == 0 or (len(pids) == 1 and int(pids[0]) == posting_id):
            return None
        d = self._route_dists(me, snap)
        d = np.where(pids == posting_id, np.inf, d)
        if max_count is None:
            return int(pids[int(np.argmin(d))])
        for i in np.argsort(d, kind="stable"):
            pid = int(pids[int(i)])
            if pid == posting_id or not np.isfinite(d[int(i)]):
                continue
            if self.storage.get_vector_count(pid) <= max_count:
                return pid
        return None

    def get_nearby_postings(self, posting_id: int, count: Optional[int] = None) -> List[int]:
        """K nearest postings by centroid distance (real impl of the stub at
        protocol.rs:139-143) — the Reassign candidate set after split/merge."""
        from spfresh_tpu_torch.lire.storage import LireStorageError

        count = count or self.config.nearby_posting_count
        try:
            me = self.storage.get_posting_centroid(posting_id)
        except LireStorageError:
            return []
        snap = self._router()
        _, pids, _, _ = snap
        if len(pids) == 0:
            return []
        d = self._route_dists(me, snap)
        d = np.where(pids == posting_id, np.inf, d)
        order = np.argsort(d, kind="stable")
        out = []
        for i in order:
            if not np.isfinite(d[int(i)]):
                break
            out.append(int(pids[int(i)]))
            if len(out) >= count:
                break
        return out
