"""LIRE versioned posting storage (counterpart of
``spfresh_tpu/lire/storage.py``, a port-owned copy of the same on-disk
format: a store written by either package opens in the other).  It mirrors
the Rust reference's ``storage.rs``, with its quirk 4 fixed.

The reference intended versioned, SSD-backed, multi-vector postings with
tombstones and a GC signal, but ``store_vector`` overwrites the posting file
with only the newest vector while ``mark_deleted`` reads it back as a HashMap
(storage.rs:111-117 vs :142-143) — the format was never finished.  Here the
design is completed the SPFresh way:

* per-posting **append-only log** of fixed-size records (add / delete ops),
  so inserts are O(1) appends, not whole-file rewrites;
* a global monotonic version counter (AtomicU64 parity, storage.rs:35) stamps
  every op — the optimistic-concurrency token used by Reassign;
* per-posting metadata (version, live count, centroid) mirrored in memory
  under a lock and persisted (storage.rs:25-30);
* GC compacts a log in place once deleted/total exceeds the threshold
  (needs_garbage_collection, storage.rs:199-225).

Host-side component by design — this is the disk/RAM tier of the memory
hierarchy (HBM holds only centroids + the packed search snapshot).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
from typing import Dict, List, Tuple

import numpy as np

def _fsync_dir(path: str) -> None:
    """fsync a DIRECTORY: file fsyncs alone do not make renames/unlinks
    durable across power loss — without this, a lost WAL unlink after a
    durable compaction swap would replay pre-compact records onto the new
    base on reopen (double-applied mutations)."""
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)



_LOG_MAGIC = b"SPFLOG1\x00"
_WAL_MAGIC = b"SPFWAL1\x00"
_OP_ADD = 1
_OP_DEL = 2

# Fold the WAL back into the per-posting logs past this many records.
_WAL_COMPACT_RECORDS = 200_000


class RoutingTierMixin:
    """Topology-generation centroid cache shared by the storage engines.

    The router contract (`protocol._router`, `LazySpannIndex._refresh_overlay`)
    depends on both engines behaving identically; subclasses provide
    ``_lock``, ``dim``, ``_topology_gen``/``_cent_matrix_cache`` attributes
    and the two hooks below."""

    def _live_pids_locked(self):
        raise NotImplementedError

    def _centroid_of_locked(self, pid: int) -> np.ndarray:
        raise NotImplementedError

    def _bump_topology_locked(self) -> None:
        self._topology_gen += 1
        self._cent_matrix_cache = None

    def topology_gen(self) -> int:
        with self._lock:
            return self._topology_gen

    def centroid_matrix(self):
        """(gen, pids (C,) int64, centroids (C, d) f32) — the packed router
        view, cached per topology generation.  Rebuilt (one vectorized stack
        under the lock) only when a posting was created/retired or a centroid
        moved; every steady-state op reads the cache.  Callers must treat the
        arrays as immutable."""
        with self._lock:
            cm = self._cent_matrix_cache
            if cm is None or cm[0] != self._topology_gen:
                pids = np.array(sorted(self._live_pids_locked()), np.int64)
                # np.array of equal-length rows: np.stack's result, 2.5x
                # faster at 10k postings.
                cents = (
                    np.array([self._centroid_of_locked(p) for p in pids.tolist()], np.float32)
                    if len(pids)
                    else np.empty((0, self.dim), np.float32)
                )
                cm = (
                    self._topology_gen, pids,
                    cents.astype(np.float32, copy=False),
                )
                self._cent_matrix_cache = cm
            return cm


class LireStorageError(Exception):
    """Storage-phase error (LireError::Storage parity, lire/mod.rs:19-30)."""


@dataclasses.dataclass
class PostingMetadata:
    """Mirror of PostingMetadata (storage.rs:25-30)."""

    version: int
    vector_count: int  # live (non-deleted) vectors
    centroid: np.ndarray


class _Posting:
    """In-memory materialization of one posting log."""

    __slots__ = ("ids", "vectors", "versions", "deleted")

    def __init__(self, dim: int):
        self.ids: List[int] = []
        self.vectors: List[np.ndarray] = []
        self.versions: List[int] = []
        self.deleted: List[bool] = []

    def live_count(self) -> int:
        return sum(not d for d in self.deleted)


class LireStorage(RoutingTierMixin):
    """Mirror of LireStorage (storage.rs:33-37) with a working format.

    ``auto_create_postings`` controls whether an append to an unknown posting
    id creates it (the reference's behavior, storage.rs:99-109).  Index-backed
    deployments must pass False: with a concurrent background Split, an
    auto-created posting silently resurrects a just-retired partition as an
    orphan that exists in storage but not in the search index — the caller
    should catch :class:`LireStorageError` and re-route to the current
    nearest partition instead.
    """

    def __init__(self, base_path: str, dim: int, auto_create_postings: bool = True):
        self.base_path = str(base_path)
        self.dim = int(dim)
        self.auto_create_postings = bool(auto_create_postings)
        self._postings_dir = os.path.join(self.base_path, "postings")
        self._meta_dir = os.path.join(self.base_path, "metadata")
        os.makedirs(self._postings_dir, exist_ok=True)
        os.makedirs(self._meta_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._current_version = 0
        # Topology generation: bumped whenever the posting SET or a centroid
        # changes (create/retire/centroid update).  Steady-state appends and
        # tombstones do NOT bump it, so the packed centroid matrix below is
        # cached across them — routing an insert is O(1) host work instead of
        # an O(C) per-call snapshot rebuild.
        self._topology_gen = 0
        self._cent_matrix_cache = None
        self._postings: Dict[int, _Posting] = {}
        self._metadata: Dict[int, PostingMetadata] = {}
        # Reverse index: vector_id -> posting ids holding a LIVE copy.  Kept
        # exact under the lock so lookups never degrade to a full-store scan.
        self._id_index: Dict[int, set] = {}
        self._record_size = 1 + 8 + 8 + 4 * self.dim
        # Update WAL: inserts/tombstones append ONE record batch to a shared
        # log instead of touching one file per posting (a 512-vector batch
        # scattered over 300 postings was 600 small writes).  Folded back into the per-posting logs at compaction points
        # (size threshold, atomic_replace, GC, flush/close, reopen).
        self._wal_path = os.path.join(self.base_path, "wal.log")
        self._wal_records = 0
        self._wal_pids: set = set()
        self._recover_journal()
        self._load_all()

    def _live_pids_locked(self):
        return self._postings

    def _centroid_of_locked(self, pid: int) -> np.ndarray:
        return self._metadata[pid].centroid

    # -- paths -------------------------------------------------------------

    def _log_path(self, posting_id: int) -> str:
        return os.path.join(self._postings_dir, f"posting_{posting_id}.log")

    def _meta_path(self, posting_id: int) -> str:
        return os.path.join(self._meta_dir, f"posting_{posting_id}_meta.bin")

    # -- core ops ----------------------------------------------------------

    def _next_version(self) -> int:
        # fetch_add parity (storage.rs:91); caller must hold self._lock.
        self._current_version += 1
        return self._current_version

    # -- update WAL ----------------------------------------------------------

    def _del_payload(self, entry_version: int) -> bytes:
        """DEL records stash the tombstoned ENTRY's version in the first 8
        payload bytes so replay tombstones the exact copy (an id deleted and
        re-inserted must not have its newest copy killed instead)."""
        zeros = np.zeros(self.dim, "<f4").tobytes()
        if len(zeros) < 8:
            return zeros  # degrade to newest-live matching at tiny dims
        return struct.pack("<q", entry_version) + zeros[8:]

    @staticmethod
    def _parse_del_payload(payload: bytes) -> int:
        if len(payload) < 8:
            return 0
        return struct.unpack("<q", payload[:8])[0]

    def _wal_append_locked(self, entries) -> None:
        """One file append for a whole update batch.  entries: iterable of
        (op, pid, vid, version, vec_f32 | entry_version_for_DEL)."""
        new = not os.path.exists(self._wal_path)
        buf = bytearray()
        if new:
            buf += _WAL_MAGIC + struct.pack("<i", self.dim)
        for op, pid, vid, version, extra in entries:
            buf += struct.pack("<Bqqq", op, pid, vid, version)
            if op == _OP_DEL:
                buf += self._del_payload(int(extra or 0))
            else:
                buf += np.ascontiguousarray(extra, "<f4").tobytes()
            self._wal_records += 1
            self._wal_pids.add(pid)
        with open(self._wal_path, "ab") as f:
            f.write(bytes(buf))

    def _compact_wal_locked(self) -> None:
        """Fold the WAL into the per-posting logs: rewrite each touched
        posting's log (tmp+rename, so a crash leaves it whole), persist its
        metadata, then remove the WAL last.  A crash before the removal just
        replays the WAL idempotently on top of the new logs."""
        if not self._wal_pids and not os.path.exists(self._wal_path):
            return
        for pid in sorted(self._wal_pids):
            if pid in self._postings:
                self._rewrite_log(pid)
                self._save_metadata(pid)
        if os.path.exists(self._wal_path):
            os.remove(self._wal_path)
        self._wal_records = 0
        self._wal_pids = set()

    def _maybe_compact_locked(self) -> None:
        if self._wal_records >= _WAL_COMPACT_RECORDS:
            self._compact_wal_locked()

    def flush(self) -> None:
        """Fold pending WAL records into the per-posting logs."""
        with self._lock:
            self._compact_wal_locked()

    def _replay_wal(self) -> None:
        """Replay the WAL over the loaded posting logs.  Idempotent: an ADD
        whose (posting, version) is already present is skipped (the crash-
        during-compaction case), and a DEL with no live target is a no-op."""
        if not os.path.exists(self._wal_path):
            return
        seen: Dict[int, set] = {
            pid: set(p.versions) for pid, p in self._postings.items()
        }
        with open(self._wal_path, "rb") as f:
            magic = f.read(8)
            if len(magic) == 8 and magic != _WAL_MAGIC:
                raise LireStorageError(f"{self._wal_path}: bad WAL magic {magic!r}")
            dim_raw = f.read(4)
            if len(magic) < 8 or len(dim_raw) < 4:
                # Torn HEADER (power loss during the very first append):
                # nothing durable — remove so the next append rewrites it
                # (same policy as the packed tier's overlay WAL).
                f.close()
                os.remove(self._wal_path)
                return
            (dim,) = struct.unpack("<i", dim_raw)
            if dim != self.dim:
                raise LireStorageError(f"{self._wal_path}: dim {dim} != {self.dim}")
            head = struct.Struct("<Bqqq")
            while True:
                raw = f.read(head.size)
                if len(raw) < head.size:
                    break  # torn tail write
                op, pid, vid, version = head.unpack(raw)
                payload = f.read(4 * self.dim)
                if len(payload) < 4 * self.dim:
                    break
                self._wal_records += 1
                self._wal_pids.add(pid)
                self._current_version = max(self._current_version, version)
                p = self._postings.get(pid)
                if op == _OP_ADD:
                    if p is None:
                        p = self._postings[pid] = _Posting(self.dim)
                        seen[pid] = set()
                    if version in seen[pid]:
                        continue  # already folded into the log
                    seen[pid].add(version)
                    p.ids.append(vid)
                    p.vectors.append(np.frombuffer(payload, "<f4").copy())
                    p.versions.append(version)
                    p.deleted.append(False)
                    self._id_index.setdefault(int(vid), set()).add(pid)
                elif op == _OP_DEL and p is not None:
                    try:
                        self._tombstone_locked(
                            p, pid, vid, self._parse_del_payload(payload)
                        )
                    except LireStorageError:
                        pass  # already folded / double-applied: no-op

    def store_vector(self, posting_id: int, vector_id: int, vector: np.ndarray) -> int:
        """Append a vector; returns its version stamp (storage.rs:85-123)."""
        vector = np.asarray(vector, np.float32).reshape(-1)
        if vector.shape[0] != self.dim:
            raise LireStorageError(
                f"vector dim {vector.shape[0]} != storage dim {self.dim}"
            )
        with self._lock:
            p = self._postings.get(posting_id)
            if p is None:
                if not self.auto_create_postings:
                    raise LireStorageError(
                        f"posting {posting_id} does not exist (auto-create disabled; "
                        "it may have been retired by a concurrent split/merge)"
                    )
                p = self._postings[posting_id] = _Posting(self.dim)
            version = self._next_version()
            p.ids.append(int(vector_id))
            p.vectors.append(vector)
            p.versions.append(version)
            p.deleted.append(False)
            self._id_index.setdefault(int(vector_id), set()).add(posting_id)
            meta = self._metadata.get(posting_id)
            if meta is None:
                # Centroid bootstraps from the first vector (storage.rs:106);
                # ops/maintenance refresh it later.
                meta = self._metadata[posting_id] = PostingMetadata(
                    version, 1, vector.copy()
                )
                self._bump_topology_locked()
            else:
                meta.version = version
                meta.vector_count += 1
            self._wal_append_locked(
                [(_OP_ADD, posting_id, int(vector_id), version, vector)]
            )
            self._maybe_compact_locked()
        return version

    def store_vectors(self, posting_id: int, vector_ids, vectors: np.ndarray) -> List[int]:
        """Batched append: one lock acquisition, one log-file open, one
        metadata write for the whole batch (store_vector pays a file
        open+write per vector — measured 53 inserts/s vs thousands here)."""
        vectors = np.asarray(vectors, np.float32)
        vectors = (
            vectors.reshape(len(vector_ids), -1)
            if len(vector_ids)
            else vectors.reshape(0, self.dim)
        )
        if vectors.shape[1] != self.dim:
            raise LireStorageError(
                f"vector dim {vectors.shape[1]} != storage dim {self.dim}"
            )
        versions: List[int] = []
        with self._lock:
            p = self._postings.get(posting_id)
            if p is None:
                if not self.auto_create_postings:
                    raise LireStorageError(
                        f"posting {posting_id} does not exist (auto-create disabled; "
                        "it may have been retired by a concurrent split/merge)"
                    )
                p = self._postings[posting_id] = _Posting(self.dim)
            meta = self._metadata.get(posting_id)
            entries = []
            for vid, vec in zip(vector_ids, vectors):
                version = self._next_version()
                versions.append(version)
                p.ids.append(int(vid))
                p.vectors.append(vec)
                p.versions.append(version)
                p.deleted.append(False)
                self._id_index.setdefault(int(vid), set()).add(posting_id)
                entries.append((_OP_ADD, posting_id, int(vid), version, vec))
            self._wal_append_locked(entries)
            if meta is None:
                self._metadata[posting_id] = PostingMetadata(
                    versions[-1] if versions else self._next_version(),
                    len(p.ids),
                    vectors[0].copy() if len(vectors) else np.zeros(self.dim, np.float32),
                )
                self._bump_topology_locked()
            else:
                meta.version = versions[-1] if versions else meta.version
                meta.vector_count += len(versions)
            self._maybe_compact_locked()
        return versions

    def _tombstone_locked(
        self, p: "_Posting", posting_id: int, vector_id: int,
        entry_version: int = 0,
    ) -> int:
        """Tombstone a copy of ``vector_id`` and fix the reverse index:
        the entry with ``entry_version`` when given (exact replay), else the
        newest live copy.  Caller holds the lock; raises if no target exists.
        Returns the tombstoned entry's stored version."""
        for i in range(len(p.ids) - 1, -1, -1):
            if p.ids[i] != vector_id or p.deleted[i]:
                continue
            if entry_version and p.versions[i] != entry_version:
                continue
            p.deleted[i] = True
            if not any(
                p.ids[j] == vector_id and not p.deleted[j]
                for j in range(len(p.ids))
            ):
                s = self._id_index.get(int(vector_id))
                if s is not None:
                    s.discard(posting_id)
                    if not s:
                        del self._id_index[int(vector_id)]
            return p.versions[i]
        raise LireStorageError(
            f"vector {vector_id} not found (or already deleted) in posting {posting_id}"
        )

    def store_vectors_multi(self, posting_ids, vector_ids, vectors: np.ndarray) -> List[int]:
        """Append a batch of vectors routed to ARBITRARY postings: one lock
        acquisition and ONE WAL append for the entire batch (the per-posting
        form still paid one file write per destination — ~300 writes for a
        512-insert batch spread over an index).  All destinations must exist
        when auto-create is off; unknown ones raise before anything lands."""
        vectors = np.asarray(vectors, np.float32)
        vectors = (
            vectors.reshape(len(vector_ids), -1)
            if len(vector_ids)
            else vectors.reshape(0, self.dim)
        )
        if vectors.shape[1] != self.dim:
            raise LireStorageError(
                f"vector dim {vectors.shape[1]} != storage dim {self.dim}"
            )
        versions: List[int] = []
        with self._lock:
            missing = {
                int(pid) for pid in posting_ids if pid not in self._postings
            }
            if missing and not self.auto_create_postings:
                raise LireStorageError(
                    f"postings {sorted(missing)} do not exist (auto-create "
                    "disabled; they may have been retired by a concurrent "
                    "split/merge)"
                )
            entries = []
            touched = set()
            for pid, vid, vec in zip(posting_ids, vector_ids, vectors):
                pid, vid = int(pid), int(vid)
                p = self._postings.get(pid)
                if p is None:
                    p = self._postings[pid] = _Posting(self.dim)
                version = self._next_version()
                versions.append(version)
                p.ids.append(vid)
                p.vectors.append(vec)
                p.versions.append(version)
                p.deleted.append(False)
                self._id_index.setdefault(vid, set()).add(pid)
                entries.append((_OP_ADD, pid, vid, version, vec))
                touched.add(pid)
                meta = self._metadata.get(pid)
                if meta is None:
                    self._metadata[pid] = PostingMetadata(version, 1, vec.copy())
                    self._bump_topology_locked()
                else:
                    meta.version = version
                    meta.vector_count += 1
            self._wal_append_locked(entries)
            self._maybe_compact_locked()
        return versions

    def move_vectors(self, src: int, dst: int, vector_ids, entry_versions):
        """Atomically move vectors ``src`` -> ``dst``, pinned to their
        planned entry versions: under ONE lock each (vid, entry_version)
        still live at src is appended to dst and its EXACT src entry
        tombstoned.  A vector whose src entry changed since planning
        (concurrent insert appended a newer copy, or a delete tombstoned
        it) is skipped — a background Reassign can neither clobber a
        foreground update nor resurrect a deleted vector.  Returns
        (moved_ids, append_versions)."""
        with self._lock:
            ps = self._postings.get(int(src))
            pd = self._postings.get(int(dst))
            if ps is None:
                raise LireStorageError(f"posting {src} does not exist")
            if pd is None:
                raise LireStorageError(f"posting {dst} does not exist")
            moved: List[int] = []
            versions: List[int] = []
            entries = []
            for vid, ev in zip(vector_ids, entry_versions):
                vid, ev = int(vid), int(ev)
                j = None
                for i in range(len(ps.ids) - 1, -1, -1):
                    if (
                        ps.ids[i] == vid
                        and not ps.deleted[i]
                        and ps.versions[i] == ev
                    ):
                        j = i
                        break
                if j is None:
                    continue  # entry changed since planning: skip
                # COLLAPSE: if dst already holds a live copy of vid (one it
                # had before, or one appended earlier in THIS call —
                # replicas of one vid from different sources reassigned to
                # the same destination), do not append a duplicate — just
                # retire the src copy.  Two live copies of one vid in ONE
                # posting would strand one of them past a single delete.
                dst_has = any(
                    pd.ids[i2] == vid and not pd.deleted[i2]
                    for i2 in range(len(pd.ids))
                )
                if dst_has:
                    ev2 = self._tombstone_locked(
                        ps, int(src), vid, entry_version=ev
                    )
                    v_del = self._next_version()
                    entries.append((_OP_DEL, int(src), vid, v_del, ev2))
                    moved.append(vid)
                    versions.append(v_del)
                    continue
                vec = ps.vectors[j].copy()
                v_add = self._next_version()
                pd.ids.append(vid)
                pd.vectors.append(vec)
                pd.versions.append(v_add)
                pd.deleted.append(False)
                self._id_index.setdefault(vid, set()).add(int(dst))
                entries.append((_OP_ADD, int(dst), vid, v_add, vec))
                ev2 = self._tombstone_locked(ps, int(src), vid, entry_version=ev)
                v_del = self._next_version()
                entries.append((_OP_DEL, int(src), vid, v_del, ev2))
                moved.append(vid)
                versions.append(v_add)
            if moved:
                md = self._metadata[int(dst)]
                md.version = versions[-1]
                md.vector_count += len(moved)
                ms = self._metadata[int(src)]
                ms.version = self._current_version
                ms.vector_count -= len(moved)
                self._wal_append_locked(entries)
                self._maybe_compact_locked()
        return moved, versions

    def mark_deleted(self, posting_id: int, vector_id: int) -> int:
        """Tombstone a vector (storage.rs:126-173); returns the version."""
        with self._lock:
            p = self._postings.get(posting_id)
            if p is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            entry_v = self._tombstone_locked(p, posting_id, vector_id)
            version = self._next_version()
            meta = self._metadata[posting_id]
            meta.version = version
            meta.vector_count -= 1
            self._wal_append_locked(
                [(_OP_DEL, posting_id, int(vector_id), version, entry_v)]
            )
            self._maybe_compact_locked()
        return version

    def mark_deleted_batch(
        self, posting_id: int, vector_ids
    ) -> Tuple[List[int], List[int]]:
        """Batched tombstones: one lock acquisition, one log-file open, one
        metadata write for the whole batch (Reassign moves thousands of
        vectors after a big split — per-vector file ops were the
        bottleneck).  Unknown/already-deleted ids are skipped; returns
        (hit_ids, versions) for the tombstones actually written."""
        versions: List[int] = []
        with self._lock:
            p = self._postings.get(posting_id)
            if p is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            hit_ids: List[int] = []
            entry_vs: List[int] = []
            for vid in vector_ids:
                try:
                    entry_vs.append(self._tombstone_locked(p, posting_id, int(vid)))
                except LireStorageError:
                    continue
                hit_ids.append(int(vid))
                versions.append(self._next_version())
            if not hit_ids:
                return [], []
            self._wal_append_locked(
                [(_OP_DEL, posting_id, vid, version, ev)
                 for vid, version, ev in zip(hit_ids, versions, entry_vs)]
            )
            meta = self._metadata[posting_id]
            meta.version = versions[-1]
            meta.vector_count -= len(hit_ids)
            self._maybe_compact_locked()
        return hit_ids, versions

    def get_posting(
        self, posting_id: int, include_deleted: bool = False
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, vectors, versions) — live entries only unless asked."""
        with self._lock:
            p = self._postings.get(posting_id)
            if p is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            sel = range(len(p.ids)) if include_deleted else [
                i for i, d in enumerate(p.deleted) if not d
            ]
            ids = np.array([p.ids[i] for i in sel], np.int64)
            vecs = (
                np.array([p.vectors[i] for i in sel], np.float32)
                if len(ids)
                else np.empty((0, self.dim), np.float32)
            )
            vers = np.array([p.versions[i] for i in sel], np.int64)
        return ids, vecs, vers

    def posting_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._postings)

    def postings_of(self, vector_id: int) -> List[int]:
        """Posting ids holding a live copy of ``vector_id`` — O(1) reverse
        lookup (replaces the full-store scan the update path needed when its
        own map went stale under concurrent maintenance)."""
        with self._lock:
            return sorted(self._id_index.get(int(vector_id), ()))

    def has_posting(self, posting_id: int) -> bool:
        with self._lock:
            return posting_id in self._postings

    def _unindex_posting_locked(self, posting_id: int) -> None:
        p = self._postings.get(posting_id)
        if p is None:
            return
        for vid, dead in zip(p.ids, p.deleted):
            if dead:
                continue
            s = self._id_index.get(int(vid))
            if s is not None:
                s.discard(posting_id)
                if not s:
                    del self._id_index[int(vid)]

    def delete_posting(self, posting_id: int) -> None:
        """Retire a posting entirely (used by completed Split/Merge)."""
        with self._lock:
            # Fold the WAL first: stale WAL records must not resurrect the
            # retired posting on the next reopen.
            self._compact_wal_locked()
            self._unindex_posting_locked(posting_id)
            self._postings.pop(posting_id, None)
            self._metadata.pop(posting_id, None)
            self._bump_topology_locked()
            for path in (self._log_path(posting_id), self._meta_path(posting_id)):
                if os.path.exists(path):
                    os.remove(path)

    def get_vector_count(self, posting_id: int) -> int:
        """Live count (storage.rs get_vector_count semantics)."""
        with self._lock:
            meta = self._metadata.get(posting_id)
            return meta.vector_count if meta else 0

    def get_posting_version(self, posting_id: int) -> int:
        """storage.rs:188-196."""
        with self._lock:
            meta = self._metadata.get(posting_id)
            if meta is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            return meta.version

    def current_version(self) -> int:
        with self._lock:
            return self._current_version

    def import_posting(
        self, posting_id: int, ids: np.ndarray, vectors: np.ndarray, centroid: np.ndarray
    ) -> None:
        """Bulk-load an existing posting (index adoption path): one lock
        acquisition and one log write for the whole list."""
        ids = np.asarray(ids, np.int64)
        vectors = np.asarray(vectors, np.float32)
        vectors = (
            vectors.reshape(len(ids), -1) if len(ids) else vectors.reshape(0, self.dim)
        )
        with self._lock:
            if posting_id in self._postings:
                raise LireStorageError(f"posting {posting_id} already exists")
            self._compact_wal_locked()
            p = self._new_posting_locked(posting_id, ids, vectors)
            version = self._current_version if p.ids else self._next_version()
            self._postings[posting_id] = p
            self._metadata[posting_id] = PostingMetadata(
                version, len(p.ids), np.asarray(centroid, np.float32).copy()
            )
            self._bump_topology_locked()
            self._rewrite_log(posting_id)
            self._save_metadata(posting_id)

    def _new_posting_locked(self, posting_id: int, ids, vectors) -> "_Posting":
        """A posting of live entries stamped with consecutive versions, as
        one append at a time would stamp them, entered in the reverse
        index.  The rows are views of one private copy.  Caller holds the
        lock and stores the posting."""
        p = _Posting(self.dim)
        n = len(ids)
        first = self._current_version + 1
        self._current_version += n
        p.ids = np.asarray(ids, np.int64).tolist()
        p.vectors = list(np.array(vectors, np.float32).reshape(n, self.dim)) if n else []
        p.versions = list(range(first, first + n))
        p.deleted = [False] * n
        for vid in p.ids:
            self._id_index.setdefault(vid, set()).add(posting_id)
        return p

    def atomic_replace(
        self,
        old_ids: List[int],
        expected_versions: List[int],
        new_postings: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]],
    ) -> bool:
        """Atomically retire ``old_ids`` and create ``new_postings``
        [(pid, ids, vectors, centroid), ...] — the commit point of Split and
        Merge.  Fails (returns False) if any old posting's version moved past
        ``expected_versions``, i.e. a concurrent insert/delete landed after
        the op read its snapshot; the op then retries on fresh data.  All
        mutations happen under the storage lock, so inserts serialize against
        the swap.

        Crash safety (write-ahead ordering): a journal recording the intent
        is written first, then the NEW generation's logs/metadata, and the
        old generation's files are removed last.  A crash at any point leaves
        exactly one complete generation on disk — :meth:`_recover_journal`
        rolls the swap forward (all new logs present) or back (otherwise) on
        the next open.  Removing the old files first would lose their
        vectors to a crash mid-swap."""
        with self._lock:
            for pid, expect in zip(old_ids, expected_versions):
                meta = self._metadata.get(pid)
                if meta is None or meta.version != expect:
                    return False
            # 0. Fold the WAL: the swap's crash story assumes the per-posting
            #    logs are the whole truth for the old generation.
            self._compact_wal_locked()
            # 1. Journal the intent (tmp + rename, so it is atomic itself;
            #    the directory fsync inside _write_journal makes the rename
            #    durable across power loss, ordering it before step 2).
            self._write_journal(
                {"old": [int(p) for p in old_ids],
                 "new": [int(p) for p, _, _, _ in new_postings]}
            )
            # 2. Write the new generation (each log lands via tmp+rename, so
            #    an existing log file is always complete).
            for pid, ids, vecs, centroid in new_postings:
                p = self._new_posting_locked(pid, ids, vecs)
                version = self._current_version if p.ids else self._next_version()
                self._postings[pid] = p
                self._metadata[pid] = PostingMetadata(
                    version, len(p.ids), np.asarray(centroid, np.float32).copy()
                )
                self._rewrite_log(pid)
                self._save_metadata(pid)
            # New-generation renames durable BEFORE the old files go: the
            # recovery predicate is 'all new logs exist => roll forward'.
            _fsync_dir(self.base_path)
            # 3. Retire the old generation last.
            for pid in old_ids:
                self._unindex_posting_locked(pid)
                self._postings.pop(pid, None)
                self._metadata.pop(pid, None)
                for path in (self._log_path(pid), self._meta_path(pid)):
                    if os.path.exists(path):
                        os.remove(path)
            self._bump_topology_locked()
            _fsync_dir(self.base_path)  # removals durable before the journal
            self._clear_journal()
        return True

    # -- swap journal --------------------------------------------------------

    @property
    def _journal_path(self) -> str:
        return os.path.join(self.base_path, "replace.journal")

    def _write_journal(self, intent: dict) -> None:
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(intent, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._journal_path)
        _fsync_dir(self.base_path)  # rename durable across power loss

    def _clear_journal(self) -> None:
        if os.path.exists(self._journal_path):
            os.remove(self._journal_path)

    def _recover_journal(self) -> None:
        """Finish or roll back an atomic_replace interrupted by a crash.
        Called before logs are loaded: if every NEW posting log exists the
        swap is rolled forward (remove the old generation); otherwise rolled
        back (remove any partial new files).  Log files are written via
        tmp+rename, so existence implies completeness."""
        if not os.path.exists(self._journal_path):
            return
        try:
            with open(self._journal_path) as f:
                intent = json.load(f)
            new, old = intent.get("new", []), intent.get("old", [])
        except Exception:
            os.remove(self._journal_path)
            return
        complete = all(os.path.exists(self._log_path(p)) for p in new)
        doomed = old if complete else new
        for pid in doomed:
            for path in (self._log_path(pid), self._meta_path(pid)):
                if os.path.exists(path):
                    os.remove(path)
        os.remove(self._journal_path)

    # -- GC ----------------------------------------------------------------

    def needs_garbage_collection(self, posting_id: int, threshold: float) -> bool:
        """deleted/total > threshold (storage.rs:199-225)."""
        with self._lock:
            p = self._postings.get(posting_id)
            if p is None or not p.ids:
                return False
            dead = sum(p.deleted)
            return dead / len(p.ids) > threshold

    def collect_garbage(self, posting_id: int) -> int:
        """Compact the log: drop tombstoned entries.  Returns #reclaimed."""
        with self._lock:
            p = self._postings.get(posting_id)
            if p is None:
                return 0
            keep = [i for i, d in enumerate(p.deleted) if not d]
            reclaimed = len(p.ids) - len(keep)
            if reclaimed == 0:
                return 0
            # Fold the WAL first: compaction drops tombstoned ADD versions,
            # and a stale WAL replay would otherwise resurrect them.
            self._compact_wal_locked()
            p.ids = [p.ids[i] for i in keep]
            p.vectors = [p.vectors[i] for i in keep]
            p.versions = [p.versions[i] for i in keep]
            p.deleted = [False] * len(keep)
            self._rewrite_log(posting_id)
        return reclaimed

    # -- centroids ---------------------------------------------------------

    def get_posting_centroid(self, posting_id: int) -> np.ndarray:
        """storage.rs:239-247."""
        with self._lock:
            meta = self._metadata.get(posting_id)
            if meta is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            return meta.centroid.copy()

    def update_posting_centroid(self, posting_id: int, centroid: np.ndarray) -> None:
        """storage.rs:250-259."""
        centroid = np.asarray(centroid, np.float32).reshape(-1)
        with self._lock:
            meta = self._metadata.get(posting_id)
            if meta is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            meta.centroid = centroid.copy()
            self._bump_topology_locked()
            self._save_metadata(posting_id)

    # -- persistence -------------------------------------------------------

    def _rewrite_log(self, posting_id: int) -> None:
        """Write the posting's log whole (tmp + rename): every entry as an
        ADD record (op u8, id i64, version i64, vector f32 x dim, packed
        little-endian), then one DEL record per tombstone, built as one
        record array each."""
        p = self._postings[posting_id]
        path = self._log_path(posting_id)
        tmp = path + ".tmp"
        n = len(p.ids)
        rec = np.dtype([("op", "u1"), ("vid", "<i8"), ("ver", "<i8"),
                        ("vec", "<f4", (self.dim,))])
        adds = np.zeros(n, rec)
        adds["op"] = _OP_ADD
        adds["vid"] = p.ids
        adds["ver"] = p.versions
        if n:
            adds["vec"] = np.array(p.vectors, np.float32)
        dead = [i for i in range(n) if p.deleted[i]]
        with open(tmp, "wb") as f:
            f.write(_LOG_MAGIC + struct.pack("<i", self.dim))
            f.write(adds.tobytes())
            # Tombstones last, so a reload reconstructs the deleted flags
            # (WAL compaction rewrites postings that still carry tombstones);
            # each names its exact entry version.
            for i in dead:
                f.write(struct.pack("<Bqq", _OP_DEL, p.ids[i], p.versions[i]))
                f.write(self._del_payload(p.versions[i]))
        os.replace(tmp, path)

    def _save_metadata(self, posting_id: int) -> None:
        meta = self._metadata[posting_id]
        tmp = self._meta_path(posting_id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<qqi", meta.version, meta.vector_count, self.dim))
            f.write(np.ascontiguousarray(meta.centroid, "<f4").tobytes())
        os.replace(tmp, self._meta_path(posting_id))

    def _load_all(self) -> None:
        """Reload every posting log, replay the update WAL on top, and
        reconstruct metadata (storage.rs:46-65).  Counts and versions are
        recomputed from the replayed state — the meta files can be stale
        relative to the WAL; only the centroid is authoritative there."""
        if not os.path.isdir(self._postings_dir):
            return
        for name in sorted(os.listdir(self._postings_dir)):
            if not (name.startswith("posting_") and name.endswith(".log")):
                continue
            pid = int(name[len("posting_") : -len(".log")])
            self._load_log(pid)
        self._replay_wal()
        for pid in self._postings:
            p = self._postings[pid]
            live = [i for i, dd in enumerate(p.deleted) if not dd]
            cent = None
            mp = self._meta_path(pid)
            if os.path.exists(mp):
                with open(mp, "rb") as f:
                    _, _, dim = struct.unpack("<qqi", f.read(20))
                    cent = np.frombuffer(f.read(4 * dim), "<f4").copy()
            if cent is None:
                cent = p.vectors[live[0]].copy() if live else np.zeros(self.dim, np.float32)
            self._metadata[pid] = PostingMetadata(
                max(p.versions, default=0), len(live), cent
            )
        # Leave a clean state behind: fold whatever the WAL held.
        self._compact_wal_locked()

    def _load_log(self, posting_id: int) -> None:
        path = self._log_path(posting_id)
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != _LOG_MAGIC:
                raise LireStorageError(f"{path}: bad log magic {magic!r}")
            (dim,) = struct.unpack("<i", f.read(4))
            if dim != self.dim:
                raise LireStorageError(f"{path}: dim {dim} != storage dim {self.dim}")
            p = _Posting(self.dim)
            rec_head = struct.Struct("<Bqq")
            while True:
                head = f.read(rec_head.size)
                if not head:
                    break
                if len(head) < rec_head.size:
                    break  # torn tail write: ignore the partial record
                op, vid, version = rec_head.unpack(head)
                payload = f.read(4 * self.dim)
                if len(payload) < 4 * self.dim:
                    break
                if op == _OP_ADD:
                    p.ids.append(vid)
                    p.vectors.append(np.frombuffer(payload, "<f4").copy())
                    p.versions.append(version)
                    p.deleted.append(False)
                elif op == _OP_DEL:
                    entry_v = self._parse_del_payload(payload)
                    for i in range(len(p.ids) - 1, -1, -1):
                        if p.ids[i] != vid or p.deleted[i]:
                            continue
                        if entry_v and p.versions[i] != entry_v:
                            continue
                        p.deleted[i] = True
                        break
                self._current_version = max(self._current_version, version)
            self._postings[posting_id] = p
            for vid, dead in zip(p.ids, p.deleted):
                if not dead:
                    self._id_index.setdefault(int(vid), set()).add(posting_id)
