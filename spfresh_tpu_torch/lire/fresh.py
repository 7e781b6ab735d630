"""SpFreshIndex — SPANN search + LIRE in-place updates (counterpart of
``spfresh_tpu/lire/fresh.py``).

The Rust reference's LIRE layer is a dead subsystem: nothing in its
``SpannIndex`` calls it (SURVEY.md section 2.9/5, quirk 5).  This class
completes the integration it intended:

    insert  -> append to nearest posting (+ background Split when oversized,
               then Reassign of boundary vectors near the split)
    delete  -> tombstone (+ background Merge when undersized, GC when stale)
    search  -> unchanged SPANN probe/rerank over a snapshot that refreshes
               lazily after updates — no full rebuilds (the SPFresh promise).

Single id space: index cluster ids == storage posting ids.  The background
pipeline mutates storage; mirror callbacks keep the index's centroid matrix
and packed posting snapshot in sync under a lock.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from spfresh_tpu_torch.index.spann import SpannIndex
from spfresh_tpu_torch.lire.operations import LireContext, Reassign, Split
from spfresh_tpu_torch.lire.pipeline import TaskOutcome, TwoStagePipeline
from spfresh_tpu_torch.lire.protocol import LireConfig, LireProtocol
from spfresh_tpu_torch.lire.storage import LireStorage
from spfresh_tpu_torch.ops.distances import pairwise_distance
from spfresh_tpu_torch.utils import metrics
from spfresh_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)


class SpFreshIndex:
    """A SpannIndex with live insert/delete via the LIRE protocol."""

    def __init__(
        self,
        index: SpannIndex,
        storage_path: str,
        lire_config: Optional[LireConfig] = None,
        start_pipeline: bool = True,
        reassign_after_split: bool = True,
        reassign_nearby: int = 8,
    ):
        if index.dim is None:
            raise ValueError("index has no data")
        self.index = index
        self.lire_config = lire_config or LireConfig()
        self.reassign_after_split = reassign_after_split
        self.reassign_nearby = reassign_nearby
        self._lock = threading.RLock()
        self._centroid_cache = None  # (gen, pids, device matrix) for routing
        # auto_create OFF: an insert racing a background split must NOT
        # resurrect the retired posting as an unsearchable orphan — the
        # protocol catches the storage error and re-routes.
        self.storage = LireStorage(storage_path, index.dim, auto_create_postings=False)

        # Import existing postings into storage (fresh storage only).
        imported = not self.storage.posting_ids() and bool(index.postings)
        if imported:
            for cid in sorted(index.postings):
                ids, vecs = index.postings[cid]
                self.storage.import_posting(cid, ids, vecs, index.centroids[cid])
        elif self.storage.posting_ids():
            # Storage is the durable truth on reopen: rebuild the mirror.
            self._sync_mirror(self.storage.posting_ids(), retired=set(index.postings) - set(self.storage.posting_ids()))
        # The id allocator must clear every pid storage knows (background
        # splits minted ids past the saved manifest's next_cluster_id): a
        # colliding allocation would let atomic_replace silently overwrite
        # a live posting.
        index._next_cluster_id = max(
            index._next_cluster_id,
            max(self.storage.posting_ids(), default=-1) + 1,
        )

        # id -> set of postings holding it (replicas from the initial build).
        self._id_map: Dict[int, Set[int]] = {}
        for pid in self.storage.posting_ids():
            # A fresh import holds exactly the index's ids: skip the re-read.
            ids = index.postings[pid][0] if imported else self.storage.get_posting(pid)[0]
            self._map_add_many(ids, pid)
        if self._id_map:
            self.index.note_multiplicity(max(len(s) for s in self._id_map.values()))

        ctx = LireContext(
            storage=self.storage,
            alloc_posting_id=self._alloc_posting_id,
            on_posting_created=self._on_posting_created,
            on_posting_retired=self._on_posting_retired,
            metric=index.metric,
        )
        self.pipeline = TwoStagePipeline(ctx, on_complete=self._after_op)
        self.protocol = LireProtocol(
            self.storage, self.lire_config, self.pipeline, index.metric, device=index.device
        )
        if start_pipeline:
            self.pipeline.start()

    # -- id allocation / mirror callbacks ----------------------------------

    def _map_add(self, vid: int, pid: int) -> None:
        """Record vid living in pid; replica growth (boundary-closure splits,
        reassign windows) feeds the index's dedup-bound hint so search's
        duplicate suppression stays exact between full view packs."""
        s = self._id_map.setdefault(int(vid), set())
        s.add(pid)
        if len(s) > 1:
            self.index.note_multiplicity(len(s))

    def _map_add_many(self, ids, pid: int) -> None:
        """``_map_add`` for every id of ``ids``, with one multiplicity
        report (the largest)."""
        most = 1
        m = self._id_map
        for vid in np.asarray(ids).tolist():
            s = m.get(vid)
            if s is None:
                m[vid] = {pid}
            else:
                s.add(pid)
                most = max(most, len(s))
        if most > 1:
            self.index.note_multiplicity(most)

    def _alloc_posting_id(self) -> int:
        with self._lock:
            cid = self.index._next_cluster_id
            self.index._next_cluster_id += 1
            return cid

    def _on_posting_created(self, pid: int, centroid: np.ndarray) -> None:
        with self._lock:
            # Snapshot INSIDE the mirror lock: reading storage before taking
            # it lets a concurrent foreground delete's mirror update be
            # overwritten by this (then-stale) snapshot.
            ids, vecs, _ = self.storage.get_posting(pid)
            self.index.replace_posting(pid, ids, vecs, centroid)
            self._map_add_many(ids, pid)

    def _on_posting_retired(self, pid: int) -> None:
        with self._lock:
            entry = self.index.postings.get(pid)
            self.index.remove_cluster(pid)
            if entry is not None:
                # O(posting) not O(total ids): sweep only the ids the
                # retired posting held (a per-split full-map sweep is
                # O(total ids)).
                for i in entry[0].tolist():
                    s = self._id_map.get(i)
                    if s is not None:
                        s.discard(pid)
            else:  # mirror entry already gone: conservative full sweep
                for s in self._id_map.values():
                    s.discard(pid)

    def _sync_mirror(self, pids, retired: Set[int] = frozenset()) -> None:
        with self._lock:
            for pid in retired:
                self.index.remove_cluster(pid)
            for pid in pids:
                if self.storage.has_posting(pid):
                    ids, vecs, _ = self.storage.get_posting(pid)
                    self.index.replace_posting(
                        pid, ids, vecs, self.storage.get_posting_centroid(pid)
                    )

    # -- updates -----------------------------------------------------------

    def insert(self, vector: np.ndarray, vector_id: int) -> int:
        """Insert one vector; returns its version stamp."""
        vector = np.asarray(vector, np.float32).reshape(-1)
        res = self.protocol.insert(vector, vector_id)
        pid = res.partitions_affected[0]
        with self._lock:
            entry = self.index.postings.get(pid)
            # Skip the mirror append when a background op's sync already
            # included the new vector (it reads storage, where the append
            # landed first) — but still record the id->posting mapping: a
            # Reassign's ``_after_op`` refreshes the mirror (``_sync_mirror``)
            # BEFORE its own map pass, and a delete landing in that window
            # saw an empty map and raised KeyError for a live vector.
            if entry is not None:
                if not (entry[0] == int(vector_id)).any():
                    ids, vecs = entry
                    self.index.replace_posting(
                        pid,
                        np.append(ids, np.int64(vector_id)),
                        np.concatenate([vecs, vector[None, :]]),
                    )
                self._map_add(int(vector_id), pid)
            # else: a background split retired ``pid`` after the storage
            # append; the split's version guard re-read the posting including
            # this vector, and the successor callbacks mirrored it already.
        return res.version

    def insert_batch(self, vectors: np.ndarray, vector_ids) -> List[int]:
        """Batched insert: one device centroid scan + ONE storage append for
        the whole batch (regardless of how many postings it lands in), then
        grouped mirror appends — the shape the padded view's append fast path
        turns into a single row-level scatter."""
        from spfresh_tpu_torch.lire.operations import Split
        from spfresh_tpu_torch.lire.storage import LireStorageError

        vectors = np.asarray(vectors, np.float32)
        vector_ids = np.asarray(vector_ids, np.int64)
        with span("lire.insert", len(vector_ids)):
            nearest, _ = self._nearest_postings(vectors)
            try:
                versions = self.storage.store_vectors_multi(nearest, vector_ids, vectors)
            except LireStorageError:
                # A destination was retired by a concurrent background op between
                # routing and the append: fall back to per-vector protocol
                # inserts, which re-route to the CURRENT nearest partition.
                with span("lire.insert.fallback", len(vector_ids)):
                    versions = []
                    affected: Set[int] = set()
                    with self._lock:
                        for v, vid in zip(vectors, vector_ids):
                            res = self.protocol.insert(v, int(vid))
                            versions.append(res.version)
                            affected.update(res.partitions_affected)
                            for p in res.partitions_affected:
                                self._map_add(int(vid), p)
                    # Sync where the re-routes LANDED (a retired original
                    # re-routes to a successor that is not in ``nearest``),
                    # plus any original that is still live.
                    affected.update(nearest.tolist())
                    self._sync_mirror(affected & set(self.storage.posting_ids()))
                    return versions
            # Mirror the appends group-by-group (no storage re-read).
            order = np.argsort(nearest, kind="stable")
            bounds = np.searchsorted(nearest[order], np.unique(nearest))
            groups = np.split(order, bounds[1:]) if len(bounds) else []
            for grp in groups:
                if len(grp) == 0:
                    continue
                pid = int(nearest[grp[0]])
                with self._lock:
                    entry = self.index.postings.get(pid)
                    if entry is not None:
                        # Same guard single insert() has: a background op's
                        # mirror sync may already include these vids (it reads
                        # storage, where the batch append landed first) —
                        # appending again would duplicate them in the mirror.
                        fresh_m = ~np.isin(vector_ids[grp], entry[0])
                        g2 = grp[fresh_m]
                        if len(g2):
                            self.index.replace_posting(
                                pid,
                                np.concatenate([entry[0], vector_ids[g2]]),
                                np.concatenate([entry[1], vectors[g2]]),
                            )
                    for vid in vector_ids[grp]:
                        self._map_add(int(vid), pid)
                if self.protocol.needs_split(pid):
                    self.protocol.schedule_maintenance(Split(pid))
            return list(versions)

    def delete(self, vector_id: int, posting_id: Optional[int] = None) -> List[int]:
        """Tombstone a vector everywhere it lives (boundary replicas
        included); returns the versions of the affected tombstones."""
        with self._lock:
            pids = (
                [posting_id]
                if posting_id is not None
                else sorted(self._id_map.get(int(vector_id), ()))
            )
        if not pids and posting_id is None:
            # The map can lag storage by one background-callback window
            # (e.g. a sync that mirrored this vid before its map pass ran):
            # the storage reverse index is the truth — same resolution the
            # lazy tier and delete_batch use.
            pids = sorted(self.storage.postings_of(int(vector_id)))
        if not pids:
            raise KeyError(f"vector {vector_id} not found")
        from spfresh_tpu_torch.lire.storage import LireStorageError

        versions = []
        if posting_id is not None:
            # Explicit-posting form: delete that one copy only.
            res = self.protocol.delete(int(vector_id), int(posting_id))
            self._mirror_remove(int(vector_id), int(posting_id))
            return [res.version]
        # Re-resolve until no live copy remains (bounded rounds): one
        # mark_deleted kills ONE entry per posting — a posting can briefly
        # hold two copies of a vid (replicas reassigned into one destination
        # before the move-collapse landed), and background ops can re-home
        # copies between the map read and the tombstone.
        for rnd in range(8):
            cur = (
                pids if rnd == 0
                else sorted(self.storage.postings_of(int(vector_id)))
            )
            if not cur:
                break
            for pid in cur:
                try:
                    res = self.protocol.delete(int(vector_id), pid)
                except LireStorageError:
                    # Copy moved / posting retired mid-round: the next round
                    # re-resolves (a round with zero hits is NOT terminal —
                    # under continuous splits it raised KeyError for a
                    # vector that still existed).
                    continue
                versions.append(res.version)
                self._mirror_remove(int(vector_id), pid)
        if self.storage.postings_of(int(vector_id)):
            # Success REQUIRES an empty reverse index (see lazy_fresh.delete).
            raise LireStorageError(
                f"vector {vector_id} kept moving during delete; retry"
            )
        if not versions:
            raise KeyError(f"vector {vector_id} not found in any live posting")
        # SUCCESS: storage holds no live copy anywhere — but the MIRROR can
        # still serve one.  A round whose tombstone lost (map said pid, the
        # copy had already been moved out by a background Reassign whose
        # ``_after_op`` sync has not landed yet) took the LireStorageError
        # path above and SKIPPED its _mirror_remove — leaving the pre-move
        # mirror copy serving until that sync arrives.  Any mirror copy is
        # stale by definition now; sweep the residual map entries.  (Caught
        # by the threaded stress loop: delete() returned, storage=[], yet
        # searches kept returning the vid from the pre-move posting.)
        with self._lock:
            for pid in sorted(self._id_map.get(int(vector_id), set())):
                self._mirror_remove(int(vector_id), pid)
        return versions

    def _mirror_remove(self, vector_id: int, pid: int) -> None:
        with self._lock:
            if pid in self.index.postings:
                ids, vecs = self.index.postings[pid]
                keep = ids != int(vector_id)
                self.index.replace_posting(pid, ids[keep], vecs[keep])
            self._id_map.get(int(vector_id), set()).discard(pid)

    def delete_batch(self, vector_ids) -> int:
        """Tombstone many vectors (replicas included): one storage batch and
        one mirror refresh per touched posting instead of per-vector file
        writes.  Returns how many of the requested ids had a live copy."""
        from spfresh_tpu_torch.lire.storage import LireStorageError

        requested = [int(v) for v in vector_ids]
        with span("lire.delete", len(requested)):
            deleted: Set[int] = set()
            pending: Set[int] = set(requested)
            touched: Set[int] = set()
            # Re-resolve until stable, and schedule maintenance only AFTER the
            # tombstones land: a merge kicked off mid-loop runs concurrently and
            # can carry a not-yet-tombstoned replica into a successor the loop's
            # snapshot never sees (the copy then stays searchable forever).
            for round_ in range(4):
                by_pid: Dict[int, List[int]] = {}
                with self._lock:
                    for vid in pending:
                        pids = (
                            (self._id_map.get(vid) or self.storage.postings_of(vid))
                            if round_ == 0
                            else self.storage.postings_of(vid)
                        )
                        for pid in pids:
                            by_pid.setdefault(int(pid), []).append(vid)
                if not by_pid:
                    break
                for pid, vids in sorted(by_pid.items()):
                    try:
                        with span("lire.delete.storage", len(vids)):
                            hit_ids, _ = self.storage.mark_deleted_batch(pid, vids)
                    except LireStorageError:
                        continue  # retired mid-round: next round re-resolves
                    if not hit_ids:
                        continue
                    deleted.update(hit_ids)
                    touched.add(pid)
                    metrics.inc("lire.delete", len(hit_ids))
                    with self._lock, span("lire.delete.mirror", len(hit_ids)):
                        if pid in self.index.postings:
                            ids, vecs = self.index.postings[pid]
                            keep = ~np.isin(ids, hit_ids)
                            self.index.replace_posting(pid, ids[keep], vecs[keep])
                        for vid in hit_ids:
                            self._id_map.get(vid, set()).discard(pid)
                pending = {
                    vid for vid in pending if self.storage.postings_of(vid)
                }
                # A zero-hit round is NOT terminal (same rule delete() earned
                # from the stress suite): with a stale round-0 map pid the
                # tombstone misses, yet re-resolution finds the copy LIVE at
                # its post-move home — breaking on ``not hit_any`` returned 0
                # while the vector kept serving.  Rounds are bounded; pending
                # is resolved fresh from storage each one.
                if not pending:
                    break
            # Same stale-mirror sweep as delete(): a round-0 stale map pid whose
            # batch tombstone found nothing (the copy had already been moved out
            # by a background Reassign whose _after_op sync has not landed) kept
            # its pre-move MIRROR copy serving.  Once a vid has no live copy in
            # storage, any mirror copy is stale by definition.
            with self._lock, span("lire.delete.mirror", len(deleted)):
                for vid in deleted:
                    if self.storage.postings_of(vid):
                        continue  # still live elsewhere (racing mover): not stale
                    for pid in sorted(self._id_map.get(vid, set())):
                        self._mirror_remove(vid, pid)
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

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int, **kw) -> Tuple[np.ndarray, np.ndarray]:
        # index.search refreshes the view's tensors in place; under the lock
        # no background mirror update interleaves with that write, and the
        # view is read only by this thread (CUDA work stays in stream order).
        with span("lire.search.lock"):
            self._lock.acquire()
        try:
            return self.index.search(queries, k, **kw)
        finally:
            self._lock.release()

    def _nearest_postings(self, vectors: np.ndarray):
        """Route vectors to their nearest posting using a centroid-only
        cache on ``index.device`` — packing the full posting view per insert
        batch would move hundreds of MB just to read a few-MB centroid
        matrix."""
        with self._lock:
            gen = self.index._gen
            cache = self._centroid_cache
            if cache is None or cache[0] != gen:
                pids = sorted(self.index.centroids)
                mat = torch.from_numpy(
                    np.stack([self.index.centroids[p] for p in pids]).astype(np.float32)
                ).to(self.index.device)
                cache = (gen, pids, mat)
                self._centroid_cache = cache
        _, pids, mat = cache
        q = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(mat.device)
        D = pairwise_distance(q, mat, self.index.metric).cpu().numpy()
        rows = np.argmin(D, axis=1)
        return (
            np.array([pids[int(r)] for r in rows]),
            D[np.arange(len(rows)), rows],
        )

    # -- background maintenance hooks --------------------------------------

    def _after_op(self, outcome: TaskOutcome) -> None:
        if outcome.error is not None or outcome.result is None:
            return
        op, result = outcome.op, outcome.result
        # Reassign mutates postings without retiring them: resync those.
        if isinstance(op, Reassign):
            # ONE critical section for the mirror refresh AND the map pass
            # (RLock nests): with them split, a foreground insert could
            # observe the refreshed mirror, skip its own map add, and leave
            # a live vector invisible to delete() until the map pass landed.
            with self._lock:
                self._sync_mirror(
                    [p for p in op.get_affected_partitions() if self.storage.has_posting(p)]
                )
                for pid in op.get_affected_partitions():
                    if not self.storage.has_posting(pid):
                        continue
                    ids, _, _ = self.storage.get_posting(pid)
                    self._map_add_many(ids, pid)
            return
        # Successor threshold re-check: one oversized batch can push a
        # split's halves past the threshold themselves, and a merge result
        # can still be undersized (only the TRIGGERING posting was checked).
        for pid in result.new_postings:
            if not self.storage.has_posting(pid):
                continue
            if self.protocol.needs_split(pid):
                self.protocol.schedule_maintenance(Split(pid))
            # Deliberately NO needs_merge here: merging a split's halves
            # right back (or chaining merges off a merge result) ping-pongs
            # with the split trigger — undersized postings wait for the
            # next delete on them, like the reference's trigger model.
        # After a successful split, boundary vectors near the two new
        # postings may belong elsewhere now — schedule Reassign (SPFresh
        # semantics; the reference never got here).
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
                vectors.extend(zip(ids.tolist(), [pid] * len(ids), vers.tolist()))
            if vectors and len(candidates) > 1:
                self.protocol.schedule_maintenance(Reassign(vectors, candidates))

    # -- maintenance / repair ----------------------------------------------

    def repair(self) -> int:
        """Re-run maintenance on partitions stuck in NEEDS_MAINTENANCE.

        The reference marks failed partitions and stops there (SURVEY.md
        section 5, "Failure detection": a soft flag with no repair loop).
        Here the repair pass re-checks each flagged partition against the
        split/merge thresholds and re-schedules the appropriate op; healthy
        partitions are simply cleared back to READY.  Returns the number of
        partitions inspected."""
        from spfresh_tpu_torch.lire.operations import Split
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

    # -- lifecycle ---------------------------------------------------------

    def flush(self, repair_rounds: int = 3) -> None:
        """Wait for all scheduled background maintenance to finish, then
        SELF-HEAL: partitions flagged NEEDS_MAINTENANCE (typically version-
        conflict casualties of concurrent foreground writes) are re-checked
        and their maintenance re-scheduled, up to ``repair_rounds`` times.
        After flush, remaining flags are persistent faults, not transients."""
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

    def close(self) -> None:
        if self.pipeline.is_running:
            self.flush()
            self.pipeline.stop()
        self.storage.flush()  # fold the update WAL into the posting logs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
