"""LazySpFreshIndex — SPFresh live updates on a DISK-backed index
(counterpart of ``spfresh_tpu/lire/lazy_fresh.py``).

``SpFreshIndex`` mirrors every posting into RAM; this facade serves the
same insert/delete/search/maintenance surface over the lazy memory
hierarchy (the SPFresh paper's actual deployment shape — the SSD tier the
Rust reference left unfinished):

    device — centroid matrix (routing tier)
    RAM    — delta overlay only (appends, tombstones, split successors)
    disk   — the packed CSR base, immutable between compactions

Updates flow through the SAME LIRE protocol, two-stage pipeline, and
Split/Merge/Reassign operations as the in-RAM index — the storage engine
(:class:`PackedLireStorage`) is the only moving part, and search stays
live because :class:`LazySpannIndex` patches staged slabs against the
overlay per batch.  ``compact()`` folds the overlay back into a fresh
packed base once it has grown past taste.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE
from spfresh_tpu_torch.index.config import Config
from spfresh_tpu_torch.index.lazy import LazySpannIndex
from spfresh_tpu_torch.lire.operations import LireContext, Reassign, Split
from spfresh_tpu_torch.lire.packed_storage import PackedLireStorage
from spfresh_tpu_torch.lire.pipeline import TaskOutcome, TwoStagePipeline
from spfresh_tpu_torch.lire.protocol import LireConfig, LireProtocol
from spfresh_tpu_torch.lire.storage import LireStorageError
from spfresh_tpu_torch.utils import metrics

log = logging.getLogger(__name__)


class LazySpFreshIndex:
    """Live insert/delete via LIRE over a disk-resident packed index."""

    def __init__(
        self,
        directory: str,
        config: Optional[Config] = None,
        lire_config: Optional[LireConfig] = None,
        start_pipeline: bool = True,
        reassign_after_split: bool = True,
        reassign_nearby: int = 8,
        prefetch_threads: Optional[int] = None,
        device: torch.device | str = DEFAULT_DEVICE,
    ):
        self.storage = PackedLireStorage(directory, auto_create_postings=False)
        self.lazy = LazySpannIndex(
            directory,
            config=config,
            prefetch_threads=prefetch_threads,
            overlay=self.storage,
            device=device,
        )
        self.device = self.lazy.device
        self.metric = self.lazy.metric
        self.dim = self.lazy.dim
        self.lire_config = lire_config or LireConfig()
        self.reassign_after_split = reassign_after_split
        self.reassign_nearby = reassign_nearby
        # No facade lock: thread-safety delegates to the storage engine's
        # single lock (every mutator and the search staging go through it);
        # the in-RAM sibling needs its own lock only for its MIRROR state.
        ctx = LireContext(
            storage=self.storage,
            alloc_posting_id=self.storage.allocate_posting_id,
            metric=self.metric,
        )
        self.pipeline = TwoStagePipeline(ctx, on_complete=self._after_op)
        self.protocol = LireProtocol(
            self.storage, self.lire_config, self.pipeline, self.metric, device=self.device
        )
        if start_pipeline:
            self.pipeline.start()

    # -- routing -------------------------------------------------------------

    def _nearest_postings(self, vectors: np.ndarray) -> np.ndarray:
        """Batch-route vectors to their nearest live posting through the
        protocol's routing cache (``LireProtocol._router``, one snapshot per
        topology generation): past ``DEVICE_ROUTE_MIN_C`` postings one
        device scan per batch, below it a host scan."""
        gen, pids, cents, dev = self.protocol._router()
        if len(pids) == 0:
            raise ValueError("no postings exist; build an index first")
        if dev is None:
            # Below DEVICE_ROUTE_MIN_C the protocol's own policy routes on
            # the host: a scan numpy does in ms beats an upload per batch.
            from spfresh_tpu_torch.lire.operations import _dist

            D = _dist(self.metric, vectors[:, None, :], cents[None, :, :])
        else:
            from spfresh_tpu_torch.ops.distances import pairwise_distance

            q = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev.device)
            D = pairwise_distance(q, dev, self.metric).cpu().numpy()
        return pids[np.argmin(D, axis=1)]

    # -- updates --------------------------------------------------------------

    def insert(self, vector: np.ndarray, vector_id: int) -> int:
        """Insert one vector; search-visible immediately (the overlay patch
        rides the next staged batch).  Returns its version stamp."""
        vector = np.asarray(vector, np.float32).reshape(-1)
        res = self.protocol.insert(vector, int(vector_id))
        return res.version

    def insert_batch(self, vectors: np.ndarray, vector_ids) -> List[int]:
        """Batched insert: one device routing scan + ONE storage/WAL append
        for the whole batch."""
        vectors = np.asarray(vectors, np.float32)
        vector_ids = np.asarray(vector_ids, np.int64)
        nearest = self._nearest_postings(vectors)
        try:
            versions = self.storage.store_vectors_multi(nearest, vector_ids, vectors)
        except LireStorageError:
            # A destination was retired between routing and the append —
            # re-route each vector to its CURRENT nearest partition.
            versions = [
                self.protocol.insert(v, int(vid)).version
                for v, vid in zip(vectors, vector_ids)
            ]
            return versions
        metrics.inc("lire.insert", len(versions))
        for pid in np.unique(nearest):
            if self.protocol.needs_split(int(pid)):
                self.protocol.schedule_maintenance(Split(int(pid)))
        return list(versions)

    def delete(self, vector_id: int, posting_id: Optional[int] = None) -> List[int]:
        """Tombstone a vector everywhere it lives (replicas included).

        Re-resolves until no live copy remains (bounded rounds, like
        ``delete_batch``): one ``mark_deleted`` kills ONE entry per posting,
        and a posting can briefly hold two copies of a vid (replicas from
        different sources reassigned into one destination before the
        move-collapse landed), or a background op can re-home a copy
        between the reverse-index read and the tombstone."""
        vid = int(vector_id)
        versions = []
        if posting_id is not None:
            # Explicit-posting form: delete that one copy only.
            res = self.protocol.delete(vid, int(posting_id))
            return [res.version]
        for _ in range(8):
            pids = self.storage.postings_of(vid)
            if not pids:
                break
            for pid in pids:
                try:
                    res = self.protocol.delete(vid, int(pid))
                except LireStorageError:
                    # Copy moved / posting retired between the reverse-index
                    # read and the tombstone: the NEXT round re-resolves.
                    # (An earlier version broke out when a whole round
                    # missed — under continuous background splits that
                    # raised KeyError for a vector that still existed.)
                    continue
                versions.append(res.version)
        if self.storage.postings_of(vid):
            # Success REQUIRES an empty reverse index: returning while a
            # copy still lives (it moved during the final round) would let
            # a 'deleted' vector keep serving.  Tombstoned entries cannot
            # resurrect (pinned moves, live-only split carries), so a
            # caller retry converges.
            raise LireStorageError(
                f"vector {vector_id} kept moving during delete; retry"
            )
        if not versions:
            raise KeyError(f"vector {vector_id} not found in any live posting")
        return versions

    def delete_batch(self, vector_ids) -> int:
        """Tombstone many vectors: one storage batch per touched posting.
        Returns how many of the requested ids had a live copy.

        Maintenance (merge/GC) is scheduled AFTER every tombstone lands: a
        merge kicked off mid-loop runs concurrently and can carry a
        not-yet-tombstoned replica into a successor the loop's snapshot
        never sees.  A final re-resolve pass retires copies that background
        ops (from BEFORE this call) moved while the loop ran."""
        requested = [int(v) for v in vector_ids]
        deleted: set = set()
        pending = set(requested)
        touched: set = set()
        # Re-resolve until stable: each round tombstones every live copy the
        # reverse index knows; copies a concurrent move re-homes between
        # rounds get caught by the next round.
        for _ in range(4):
            by_pid = {}
            for vid in pending:
                for pid in self.storage.postings_of(vid):
                    by_pid.setdefault(int(pid), []).append(vid)
            if not by_pid:
                break
            for pid, vids in sorted(by_pid.items()):
                try:
                    hit_ids, _ = self.storage.mark_deleted_batch(pid, vids)
                except LireStorageError:
                    continue  # retired mid-round: next round re-resolves
                if hit_ids:
                    deleted.update(hit_ids)
                    touched.add(pid)
                    metrics.inc("lire.delete", len(hit_ids))
            # Only ids with NO remaining live copy leave the pending set.
            # A zero-hit round is NOT terminal (same rule as the RAM tier):
            # a copy re-homed between this round's resolve and its tombstone
            # is still live — the next round's fresh resolve catches it.
            pending = {
                vid for vid in pending if self.storage.postings_of(vid)
            }
            if not pending:
                break
        for pid in sorted(touched):
            if not self.storage.has_posting(pid):
                continue
            if self.protocol.needs_merge(pid):
                merge = self.protocol._plan_merge(pid)
                if merge is not None:
                    self.protocol.schedule_maintenance(merge)
            if self.storage.needs_garbage_collection(
                pid, self.lire_config.gc_threshold
            ):
                self.storage.collect_garbage(pid)
        return len(deleted)

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int, **kw) -> Tuple[np.ndarray, np.ndarray]:
        return self.lazy.search(queries, k, **kw)

    @property
    def num_clusters(self) -> int:
        return len(self.storage.posting_ids())

    # -- background maintenance hooks -----------------------------------------

    def _after_op(self, outcome: TaskOutcome) -> None:
        if outcome.error is not None or outcome.result is None:
            return
        op, result = outcome.op, outcome.result
        # No search mirror to sync — the lazy index reads storage directly.
        self._recheck_successors(result)
        # After a split, boundary vectors near the new postings may belong
        # elsewhere now: schedule Reassign (SPFresh semantics).
        if isinstance(op, Split) and self.reassign_after_split and result.new_postings:
            candidates: List[int] = list(result.new_postings)
            for pid in result.new_postings:
                candidates.extend(
                    self.protocol.get_nearby_postings(pid, self.reassign_nearby)
                )
            candidates = sorted(set(candidates))
            vectors: List[Tuple[int, int, int]] = []
            for pid in result.new_postings:
                if not self.storage.has_posting(pid):
                    continue
                ids, _, vers = self.storage.get_posting(pid)
                vectors.extend((int(i), pid, int(v)) for i, v in zip(ids, vers))
            if vectors and len(candidates) > 1:
                self.protocol.schedule_maintenance(Reassign(vectors, candidates))

    def _recheck_successors(self, result) -> None:
        """One oversized batch can push a split's halves past the threshold
        themselves (only one Split is scheduled per batch), and a merge
        result can still be undersized — successors get the same threshold
        check their trigger would have given them."""
        for pid in result.new_postings:
            if not self.storage.has_posting(pid):
                continue
            if self.protocol.needs_split(pid):
                self.protocol.schedule_maintenance(Split(pid))
            # Deliberately NO needs_merge here: merging a split's halves
            # right back (or chaining merges off a merge result) ping-pongs
            # with the split trigger — undersized postings wait for the
            # next delete on them, like the reference's trigger model.

    # -- maintenance / repair --------------------------------------------------

    def repair(self) -> int:
        """Re-check partitions stuck in NEEDS_MAINTENANCE (same self-heal
        loop as :meth:`SpFreshIndex.repair`)."""
        from spfresh_tpu_torch.lire.pipeline import PartitionStatus

        with self.pipeline._status_lock:
            flagged = [
                pid
                for pid, st in self.pipeline._status.items()
                if st == PartitionStatus.NEEDS_MAINTENANCE
            ]
        for pid in flagged:
            if not self.storage.has_posting(pid):
                self.pipeline._set_status(pid, PartitionStatus.READY)
                continue
            if self.protocol.needs_split(pid):
                self.protocol.schedule_maintenance(Split(pid))
            elif self.protocol.needs_merge(pid):
                merge = self.protocol._plan_merge(pid)
                if merge is not None:
                    self.protocol.schedule_maintenance(merge)
                else:
                    self.pipeline._set_status(pid, PartitionStatus.READY)
            else:
                self.pipeline._set_status(pid, PartitionStatus.READY)
        return len(flagged)

    def flush(self, repair_rounds: int = 3) -> None:
        """Drain background maintenance, self-healing flagged partitions."""
        if not self.pipeline.is_running:
            return
        self.pipeline.drain()
        from spfresh_tpu_torch.lire.pipeline import PartitionStatus

        for _ in range(max(0, repair_rounds)):
            with self.pipeline._status_lock:
                flagged = any(
                    st == PartitionStatus.NEEDS_MAINTENANCE
                    for st in self.pipeline._status.values()
                )
            if not flagged:
                break
            self.repair()
            self.pipeline.drain()

    def compact(self) -> None:
        """Fold the overlay into a fresh packed base and re-open the lazy
        index's mmaps over it.  Call when ``storage.overlay_rows()`` has
        grown past taste — searches before/after are equivalent.

        The write gate makes the (storage.compact, reload_base) pair atomic
        w.r.t. concurrent searches: without it, a search between the two
        would patch pre-compact base slabs with the post-compact (empty)
        overlay, transiently resurrecting folded-in tombstones and dropping
        folded-in appends."""
        self.flush()
        with self.lazy._gate.write():
            self.storage.compact()
            self.lazy._reload_base_locked()

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        if self.pipeline.is_running:
            self.flush()
            self.pipeline.stop()
        self.lazy.close()
        self.storage.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
