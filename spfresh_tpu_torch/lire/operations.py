"""LIRE rebalance operations — Split / Merge / Reassign (counterpart of
``spfresh_tpu/lire/operations.py``; the Rust reference's
``operations.rs`` with its quirk 5 fixed).

The reference's ops compute their results and then drop them — ``execute``
never persists (operations.rs:86-101,184-199).  Here each op is completed
with real SPFresh semantics:

* **Split** (operations.rs:9-121): seeds = first vector + farthest vector
  (:33-58), boundary-closure 2-way assignment (:61-82), then two *new*
  postings are persisted, medoid centroids computed, and the old posting
  retired — atomically, with optimistic version validation so a concurrent
  insert retries the split instead of losing data.
* **Merge** (operations.rs:125-219): union of two postings (tombstone-aware,
  newest version wins per id), centroid = member nearest the mean
  (:152-180 computes the mean; we take the medoid for SPANN consistency),
  persisted as a new posting; both sources retired.
* **Reassign** (operations.rs:223-315): per-vector argmin over candidate
  posting centroids (:253-276); vectors that moved since scheduling (version
  token, :230) are skipped — optimistic concurrency, not locks.

Distance math runs in numpy on the host: sizes here are bounded by
max_partition_size.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from spfresh_tpu_torch.lire.storage import LireStorage, LireStorageError

_BOUNDARY_THRESHOLD = 1.1  # same closure rule as the clustering engine


class LireOperationError(Exception):
    """Split/Merge/Reassign failure (LireError parity, lire/mod.rs:19-30)."""


class SplitError(LireOperationError):
    """LireError::Split parity."""


class MergeError(LireOperationError):
    """LireError::Merge parity."""


class ReassignError(LireOperationError):
    """LireError::Reassign parity."""


@dataclasses.dataclass
class LireContext:
    """Execution context handed to operations by the pipeline.

    ``alloc_posting_id`` hands out fresh posting ids;
    ``on_posting_created`` / ``on_posting_retired`` let the owning index keep
    its centroid matrix and search mirror in sync.
    """

    storage: LireStorage
    alloc_posting_id: Callable[[], int]
    on_posting_created: Callable[[int, np.ndarray], None] = lambda pid, c: None
    on_posting_retired: Callable[[int], None] = lambda pid: None
    metric: str = "Euclidean"


def _dist(metric: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Host-side metric for op-sized work: x (..., d), y (..., d) -> (...)."""
    diff = x.astype(np.float32) - y.astype(np.float32)
    if metric == "Euclidean":
        return np.sum(diff * diff, axis=-1)
    if metric == "Manhattan":
        return np.sum(np.abs(diff), axis=-1)
    return np.max(np.abs(diff), axis=-1)


def _medoid(metric: str, vecs: np.ndarray) -> np.ndarray:
    mean = vecs.mean(axis=0, dtype=np.float32)
    return vecs[int(np.argmin(_dist(metric, vecs, mean[None, :])))]


@dataclasses.dataclass
class OperationResult:
    """Completed-op summary (UpdateResult sibling, protocol.rs:35-42)."""

    vectors_moved: int
    new_postings: List[int]
    retired_postings: List[int]

    @property
    def affected_partitions(self) -> List[int]:
        return sorted(set(self.new_postings) | set(self.retired_postings))


class PartitionOperation:
    """Trait parity (operations.rs:317-322)."""

    def validate(self, ctx: LireContext) -> None:
        raise NotImplementedError

    def execute(self, ctx: LireContext) -> OperationResult:
        raise NotImplementedError

    def get_affected_partitions(self) -> List[int]:
        raise NotImplementedError

    def is_stale(self, ctx: LireContext) -> bool:
        """True when the op's source posting(s) were retired by an EARLIER
        maintenance op between scheduling and execution (splits/merges
        remove their sources).  A stale op is obsolete, not failed — the
        successor postings were threshold-checked when they were created —
        so the pipeline skips it instead of flagging NEEDS_MAINTENANCE."""
        return False

    def stale_survivors(self, ctx: LireContext) -> List[int]:
        """Affected partitions that STILL EXIST when the op goes stale.

        The "successors were threshold-checked" rationale of ``is_stale``
        only covers the retired posting(s).  A survivor (e.g. a Merge source
        whose target was retired) keeps whatever condition triggered the op
        — the pipeline re-flags survivors NEEDS_MAINTENANCE so the repair
        loop re-checks thresholds, instead of silently dropping pending
        maintenance."""
        return []


@dataclasses.dataclass
class Split(PartitionOperation):
    posting_id: int
    max_retries: int = 5

    def get_affected_partitions(self) -> List[int]:
        return [self.posting_id]

    def validate(self, ctx: LireContext) -> None:
        if not ctx.storage.has_posting(self.posting_id):
            raise SplitError(f"split: posting {self.posting_id} does not exist")
        if ctx.storage.get_vector_count(self.posting_id) < 2:
            raise SplitError("split: need at least 2 vectors")

    def is_stale(self, ctx: LireContext) -> bool:
        return not ctx.storage.has_posting(self.posting_id)

    def execute(self, ctx: LireContext) -> OperationResult:
        self.validate(ctx)
        metric = ctx.metric
        for _ in range(self.max_retries):
            version = ctx.storage.get_posting_version(self.posting_id)
            ids, vecs, vers = ctx.storage.get_posting(self.posting_id)
            if len(ids) < 2:
                raise SplitError("split: posting shrank below 2 vectors")
            # Seeds: first + farthest (operations.rs:33-58).
            c1 = vecs[0]
            d1 = _dist(metric, vecs, c1[None, :])
            c2 = vecs[int(np.argmax(d1))]
            d2 = _dist(metric, vecs, c2[None, :])
            best2 = d2 < d1  # ties to the first seed
            cc = float(_dist(metric, c1, c2))
            m1 = ~best2 | (best2 & (d1 < _BOUNDARY_THRESHOLD * d2) & (cc >= d1))
            m2 = best2 | (~best2 & (d2 < _BOUNDARY_THRESHOLD * d1) & (cc >= d2))
            # Guaranteed progress on duplicate-heavy postings (SURVEY quirk
            # 6), and a hard overlap cap: on tight clusters the closure can
            # admit most vectors into BOTH halves, and cascaded splits (a
            # successor re-split because one oversized batch blew past 2x
            # the threshold) would then compound replication multiplicatively
            # — the same blowup the build layer's single capped replica pass
            # exists to avoid.  1.25 mirrors Config.replica_overflow.
            if (
                m1.all() or m2.all() or not m1.any() or not m2.any()
                or int(m1.sum()) + int(m2.sum()) > int(np.ceil(1.25 * len(ids)))
            ):
                order = np.argsort(d1, kind="stable")
                half = (len(ids) + 1) // 2
                m1 = np.zeros(len(ids), bool)
                m1[order[:half]] = True
                m2 = ~m1
            p1, p2 = ctx.alloc_posting_id(), ctx.alloc_posting_id()
            new = [
                (p1, ids[m1], vecs[m1], _medoid(metric, vecs[m1])),
                (p2, ids[m2], vecs[m2], _medoid(metric, vecs[m2])),
            ]
            if ctx.storage.atomic_replace([self.posting_id], [version], new):
                for pid, _, _, cent in new:
                    ctx.on_posting_created(pid, cent)
                ctx.on_posting_retired(self.posting_id)
                return OperationResult(
                    vectors_moved=int(len(ids)),
                    new_postings=[p1, p2],
                    retired_postings=[self.posting_id],
                )
            # A concurrent insert advanced the version: retry on fresh data.
        raise SplitError(
            f"split: posting {self.posting_id} kept changing; giving up after {self.max_retries} retries"
        )


@dataclasses.dataclass
class Merge(PartitionOperation):
    """``max_size``: upper bound on the merged posting (the protocol passes
    max_partition_size) — without it a merge can mint a posting that
    immediately needs a split, ping-ponging with the split trigger."""

    posting_id: int
    target_id: int
    max_size: Optional[int] = None
    max_retries: int = 5

    def get_affected_partitions(self) -> List[int]:
        return [self.posting_id, self.target_id]

    def is_stale(self, ctx: LireContext) -> bool:
        return not (
            ctx.storage.has_posting(self.posting_id)
            and ctx.storage.has_posting(self.target_id)
        )

    def stale_survivors(self, ctx: LireContext) -> List[int]:
        # A still-existing source may still be undersized; a still-existing
        # target lost nothing but a re-check is cheap and repair() clears
        # healthy partitions straight back to READY.
        return [
            p
            for p in (self.posting_id, self.target_id)
            if ctx.storage.has_posting(p)
        ]

    def validate(self, ctx: LireContext) -> None:
        if self.posting_id == self.target_id:
            raise MergeError("merge: cannot merge a posting with itself")
        for pid in (self.posting_id, self.target_id):
            if not ctx.storage.has_posting(pid):
                raise MergeError(f"merge: posting {pid} does not exist")

    def execute(self, ctx: LireContext) -> OperationResult:
        self.validate(ctx)
        metric = ctx.metric
        for _ in range(self.max_retries):
            v_a = ctx.storage.get_posting_version(self.posting_id)
            v_b = ctx.storage.get_posting_version(self.target_id)
            ids_a, vecs_a, ver_a = ctx.storage.get_posting(self.posting_id)
            ids_b, vecs_b, ver_b = ctx.storage.get_posting(self.target_id)
            ids = np.concatenate([ids_a, ids_b])
            vecs = (
                np.concatenate([vecs_a, vecs_b])
                if len(ids)
                else np.empty((0, ctx.storage.dim), np.float32)
            )
            vers = np.concatenate([ver_a, ver_b])
            # Dedup by id, newest version wins (a vector may transiently exist
            # in both during reassignment).
            keep: Dict[int, int] = {}
            for i, (vid, vv) in enumerate(zip(ids, vers)):
                j = keep.get(int(vid))
                if j is None or vers[j] < vv:
                    keep[int(vid)] = i
            sel = sorted(keep.values())
            ids, vecs = ids[sel], vecs[sel]
            if self.max_size is not None and len(ids) > self.max_size:
                raise MergeError(
                    f"merge: {self.posting_id}+{self.target_id} would hold "
                    f"{len(ids)} vectors > max {self.max_size}"
                )
            if len(ids) == 0:
                # Both sources fully tombstoned: retire them WITHOUT minting
                # a successor — an empty posting with a zero centroid would
                # pollute routing forever (nothing ever deletes from it, so
                # no trigger could merge or GC it away).
                if ctx.storage.atomic_replace(
                    [self.posting_id, self.target_id], [v_a, v_b], []
                ):
                    ctx.on_posting_retired(self.posting_id)
                    ctx.on_posting_retired(self.target_id)
                    return OperationResult(
                        vectors_moved=0,
                        new_postings=[],
                        retired_postings=[self.posting_id, self.target_id],
                    )
                continue  # version moved: retry on fresh data
            centroid = _medoid(metric, vecs)
            pid = ctx.alloc_posting_id()
            ok = ctx.storage.atomic_replace(
                [self.posting_id, self.target_id],
                [v_a, v_b],
                [(pid, ids, vecs, centroid)],
            )
            if ok:
                ctx.on_posting_created(pid, centroid)
                ctx.on_posting_retired(self.posting_id)
                ctx.on_posting_retired(self.target_id)
                return OperationResult(
                    vectors_moved=int(len(ids)),
                    new_postings=[pid],
                    retired_postings=[self.posting_id, self.target_id],
                )
        raise MergeError(
            f"merge: postings {self.posting_id},{self.target_id} kept changing"
        )


@dataclasses.dataclass
class Reassign(PartitionOperation):
    """Move boundary vectors to their truly-nearest posting.

    vectors: (vector_id, current_posting_id, version) triples — the version is
    the optimistic token (operations.rs:230); a vector whose posting no longer
    holds it live is skipped.  candidate_postings: posting ids whose centroids
    compete for the vector.
    """

    vectors: List[Tuple[int, int, int]]
    candidate_postings: List[int]

    def get_affected_partitions(self) -> List[int]:
        return sorted({p for _, p, _ in self.vectors} | set(self.candidate_postings))

    def validate(self, ctx: LireContext) -> None:
        if not self.candidate_postings:
            raise ReassignError("reassign: no candidate postings")

    def execute(self, ctx: LireContext) -> OperationResult:
        """Batched: each source posting is snapshot once, destinations are
        chosen in one vectorized argmin, and storage sees one append per
        destination + one tombstone batch per source (the per-vector form
        paid one file open+write per moved vector — thousands of tiny writes
        after a big split).

        Commit is ``storage.move_vectors`` — append-at-dst + EXACT-entry
        tombstone-at-src under ONE storage lock, pinned to the planned entry
        version: a vector whose src entry changed since planning (concurrent
        foreground insert or delete) is skipped, never clobbered or
        resurrected."""
        self.validate(ctx)
        metric = ctx.metric
        cands = [
            p for p in self.candidate_postings if ctx.storage.has_posting(p)
        ]
        if not cands:
            raise ReassignError("reassign: no live candidate postings")
        cents = np.stack([ctx.storage.get_posting_centroid(p) for p in cands])

        by_src: Dict[int, List[Tuple[int, Optional[int]]]] = {}
        for vid, cur_pid, token in self.vectors:
            by_src.setdefault(cur_pid, []).append((int(vid), token))

        # Plan: (dst, vid, entry_version, src) for every vector to move.
        planned: List[Tuple[int, int, int, int]] = []
        for src, items in by_src.items():
            if not ctx.storage.has_posting(src):
                continue  # split/merged away; its successor owns the vectors
            try:
                ids, vecs, vers = ctx.storage.get_posting(src)
            except LireStorageError:
                continue
            pos = {int(i): j for j, i in enumerate(ids)}
            sel: List[Tuple[int, int]] = []
            for vid, token in items:
                j = pos.get(vid)
                if j is None:
                    continue  # moved or deleted since scheduling
                if token is not None and vers[j] != token:
                    continue  # optimistic-concurrency skip
                sel.append((vid, j))
            if not sel:
                continue
            V = vecs[[j for _, j in sel]]
            D = _dist(metric, V[:, None, :], cents[None, :, :])  # (m, C)
            best = np.argmin(D, axis=1)
            for (vid, j), b in zip(sel, best):
                dst = cands[int(b)]
                if dst != src:
                    planned.append((dst, vid, int(vers[j]), src))

        # Commit: one atomic pinned move per (src, dst) pair.
        by_pair: Dict[Tuple[int, int], List[int]] = {}
        for i, (dst, _, _, src) in enumerate(planned):
            by_pair.setdefault((src, dst), []).append(i)
        moved = 0
        for (src, dst), idxs in sorted(by_pair.items()):
            vids = [planned[i][1] for i in idxs]
            evs = [planned[i][2] for i in idxs]
            try:
                moved_ids, _ = ctx.storage.move_vectors(src, dst, vids, evs)
            except LireStorageError:
                continue  # src or dst retired mid-op: leave vectors in place
            moved += len(moved_ids)
        return OperationResult(
            vectors_moved=moved,
            new_postings=[],
            retired_postings=[],
        )
