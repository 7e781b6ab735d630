"""Packed-base LIRE storage — live updates for disk-scale indexes
(counterpart of ``spfresh_tpu/lire/packed_storage.py``, a copy owned by the
port: its packed base, ``overlay.wal`` and compaction files are
byte-compatible with the JAX package's, in both directions).

``LireStorage`` materializes every posting in RAM plus one log file per
posting: the right shape for 1M-scale indexes, the wrong one for a corpus
larger than host RAM.  This engine implements the SAME duck-typed interface
(everything ``LireProtocol`` / the rebalance ops / the two-stage pipeline
call) over the memory hierarchy the lazy serving path already uses
(reference memory model: spann_index.rs:169 "lazy design"; SPFresh's SSD
tier, SURVEY.md §5):

    disk  — the packed CSR file written by ``SpannIndex.save`` (immutable,
            mmap'd; the bulk of the corpus never enters RAM)
    RAM   — a per-posting DELTA overlay: appended vectors, tombstoned entry
            versions, split/merge successor postings; plus every centroid
            (the routing tier)
    WAL   — ONE ordered append-only log of every mutation; replay over the
            unchanged base reconstructs the overlay exactly on reopen

Version scheme: base entry at packed row ``r`` has version ``r + 1``
(globally unique — rows are disjoint across postings); the monotonic
counter starts past the last row, so every live mutation stamps a version
no base entry can collide with.  Tombstones name their exact entry version,
same as ``LireStorage``'s DEL payload.

Split/Merge commit (``atomic_replace``) writes its RETIRE/NEW/ADD records
inside a WAL *transaction* (BEGIN/END markers): a torn tail never applies a
partial swap — replay discards an unterminated transaction, leaving the old
generation intact (the same guarantee ``LireStorage`` gets from its intent
journal + tmp-rename file swaps).

``compact()`` folds base + overlay into a fresh packed CSR (streamed one
posting at a time — peak RAM stays O(posting), not O(corpus)), swaps the
three index files via an intent journal + tmp-rename, and truncates the
WAL.  Until then the WAL is the durable form of the overlay.  Durability
contract: mutators flush to the OS page cache before returning (process-
crash durable); ``flush()`` fsyncs the WAL and ``compact()`` fsyncs its
tmp files BEFORE the intent journal becomes durable, so power loss never
rolls forward incomplete files (group-commit semantics).
"""

from __future__ import annotations

import gzip
import json
import os
import struct
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from spfresh_tpu_torch.lire.storage import (
    LireStorageError,
    PostingMetadata,
    RoutingTierMixin,
    _fsync_dir,
)

_WAL_MAGIC = b"SPFPWAL1"
_OP_ADD = 1
_OP_DEL = 2
_OP_NEW = 3      # create posting; payload = centroid
_OP_RETIRE = 4   # retire posting
_OP_CENT = 5     # centroid update; payload = centroid
_OP_SHADOW = 6   # GC: base rows materialized into the overlay at this point
_OP_TXN_BEGIN = 7
_OP_TXN_END = 8

_JOURNAL = "compact.journal"


class _Delta:
    """Overlay state for one posting.  ``shadowed`` postings (GC'd base
    postings and all split/merge successors) live entirely in the add
    lists; otherwise the add lists extend the immutable base rows."""

    __slots__ = ("add_ids", "add_vecs", "add_versions", "dead", "dead_base",
                 "shadowed")

    def __init__(self, shadowed: bool = False):
        self.add_ids: List[int] = []
        self.add_vecs: List[np.ndarray] = []
        self.add_versions: List[int] = []
        self.dead: Set[int] = set()          # tombstoned ENTRY versions
        self.dead_base: Optional[np.ndarray] = None  # bool mask over base rows
        self.shadowed = shadowed


class PackedLireStorage(RoutingTierMixin):
    """LIRE storage over a packed CSR base + RAM delta overlay + WAL."""

    def __init__(self, directory: str, auto_create_postings: bool = False):
        from spfresh_tpu_torch.index.spann import CENTROIDS_FILE, MANIFEST, PACKED_FILE
        from spfresh_tpu_torch.index.posting_store import read_packed_postings

        self.directory = str(directory)
        self._packed_path = os.path.join(self.directory, PACKED_FILE)
        self._cent_path = os.path.join(self.directory, CENTROIDS_FILE)
        self._manifest_path = os.path.join(self.directory, MANIFEST)
        self.auto_create_postings = bool(auto_create_postings)
        self._lock = threading.RLock()
        self._recover_compaction()
        with open(self._manifest_path) as f:
            self._manifest = json.load(f)
        if self._manifest["layout"] != "packed":
            raise LireStorageError("PackedLireStorage requires the 'packed' layout")
        self.dim = int(self._manifest["dim"])
        cids, offsets, ids, vectors = read_packed_postings(self._packed_path, mmap=True)
        self._cids = np.asarray(cids)
        self._offsets = np.asarray(offsets)
        self._base_ids = ids          # mmap (P,) int64
        self._base_vecs = vectors     # mmap (P, dim) f32
        self._base_idx: Dict[int, int] = {int(c): i for i, c in enumerate(self._cids)}
        self._base_rows = int(self._offsets[-1]) if len(self._offsets) else 0
        with gzip.open(self._cent_path, "rb") as f:
            cent = np.load(f)
        self._overlay: Dict[int, _Delta] = {}
        # Retired postings' last live content: a concurrent search whose
        # routing snapshot predates a split/merge commit must see the OLD
        # posting's vectors, not emptiness (its successors are not in that
        # search's centroid matrix).  Freed at compaction.
        self._retired_snaps: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._live: Set[int] = set(self._base_idx)
        self._meta: Dict[int, PostingMetadata] = {}
        for pid, i in self._base_idx.items():
            s, e = int(self._offsets[i]), int(self._offsets[i + 1])
            self._meta[pid] = PostingMetadata(max(e, 1), e - s, cent[i].astype(np.float32))
        self._current_version = self._base_rows
        self._next_pid = max(
            int(self._manifest.get("next_cluster_id", 0)),
            max(self._base_idx, default=-1) + 1,
        )
        self._topology_gen = 0
        self._cent_matrix_cache = None
        # Reverse index: overlay adds are exact; base lookups go through a
        # lazily built sorted permutation of the mmap'd id column (binary
        # search — no O(corpus) python dict at DEEP scale).
        self._id_delta: Dict[int, Set[int]] = {}
        self._base_order: Optional[np.ndarray] = None
        self._base_ids_sorted: Optional[np.ndarray] = None
        self._mult_hint = 1
        self._max_live = int((self._offsets[1:] - self._offsets[:-1]).max(initial=0))
        self._wal_path = os.path.join(self.directory, "overlay.wal")
        self._wal_records = 0
        self._wal_failed = False  # poison flag: see _check_writable
        self._record = struct.Struct("<Bqqq")
        self._payload_bytes = 4 * self.dim
        self._replay_wal()

    # -- versions / ids ------------------------------------------------------

    def _next_version(self) -> int:
        self._current_version += 1
        return self._current_version

    def current_version(self) -> int:
        with self._lock:
            return self._current_version

    def allocate_posting_id(self) -> int:
        with self._lock:
            pid = self._next_pid
            self._next_pid += 1
            return pid

    # -- topology / routing tier (RoutingTierMixin) ---------------------------

    def _live_pids_locked(self):
        return self._live

    def _centroid_of_locked(self, pid: int) -> np.ndarray:
        return self._meta[pid].centroid

    # -- WAL -----------------------------------------------------------------

    def _check_writable(self) -> None:
        if self._wal_failed:
            raise LireStorageError(
                "storage is read-only: a WAL write failed, so the in-RAM "
                "overlay may be ahead of the durable log — reopen the "
                "storage to recover the durable state"
            )

    def _wal_append_locked(self, records: Iterable[tuple]) -> None:
        """records: (op, pid, vid, version, payload_bytes|None)."""
        buf = bytearray()
        if not os.path.exists(self._wal_path):
            buf += _WAL_MAGIC + struct.pack("<i", self.dim)
        blank = b"\x00" * self._payload_bytes
        cnt = 0
        for op, pid, vid, version, payload in records:
            buf += self._record.pack(op, pid, vid, version)
            buf += payload if payload is not None else blank
            cnt += 1
        try:
            with open(self._wal_path, "ab") as f:
                f.write(bytes(buf))
                f.flush()  # page cache before return; fsync policy: flush()
        except OSError as e:
            # The caller already applied this batch to the RAM overlay; a
            # failed append (disk full, IO error) means RAM is now ahead of
            # the durable log.  POISON the storage: every further mutation
            # refuses before touching RAM, so the divergence stays bounded
            # to this one batch and a reopen recovers the durable state.
            self._wal_failed = True
            raise LireStorageError(
                f"WAL append failed ({e}); storage is now read-only — "
                "reopen to recover the durable state"
            ) from e
        self._wal_records += cnt

    def _vec_payload(self, vec: np.ndarray) -> bytes:
        return np.ascontiguousarray(vec, "<f4").tobytes()

    def _del_payload(self, entry_version: int) -> bytes:
        if self._payload_bytes < 8:
            return b"\x00" * self._payload_bytes
        return struct.pack("<q", entry_version) + b"\x00" * (self._payload_bytes - 8)

    @staticmethod
    def _parse_del_payload(payload: bytes) -> int:
        return struct.unpack("<q", payload[:8])[0] if len(payload) >= 8 else 0

    def _replay_wal(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            magic = f.read(8)
            if len(magic) < 8:
                # Torn HEADER: power loss during the very first append left
                # a partial (or empty) file — nothing is durable in it.
                # Remove it so the next append rewrites the header (appends
                # skip the header whenever the file exists).
                pass
            elif magic != _WAL_MAGIC:
                raise LireStorageError(f"{self._wal_path}: bad WAL magic {magic!r}")
            dim_raw = f.read(4)
            if len(magic) < 8 or len(dim_raw) < 4:
                f.close()
                os.remove(self._wal_path)
                return
            (dim,) = struct.unpack("<i", dim_raw)
            if dim != self.dim:
                raise LireStorageError(f"{self._wal_path}: dim {dim} != {self.dim}")
            txn: Optional[List[tuple]] = None
            while True:
                raw = f.read(self._record.size)
                if len(raw) < self._record.size:
                    break  # torn tail
                op, pid, vid, version = self._record.unpack(raw)
                payload = f.read(self._payload_bytes)
                if len(payload) < self._payload_bytes:
                    break
                self._wal_records += 1
                rec = (op, pid, vid, version, payload)
                if op == _OP_TXN_BEGIN:
                    txn = []
                    continue
                if op == _OP_TXN_END:
                    if txn is not None:
                        for r in txn:
                            self._apply_locked(*r)
                        txn = None
                    continue
                if txn is not None:
                    txn.append(rec)  # applied only if the END marker lands
                else:
                    self._apply_locked(*rec)
            # an unterminated transaction is discarded wholesale
        # Restore the multiplicity bound the live mutators maintained
        # (replay skips _note_multiplicity_locked): bound each replayed id
        # by its delta copies + ALL base rows with that id (dead ones too —
        # an overestimate is a safe dedup bound, an undercount is not).
        if self._id_delta:
            vids = np.fromiter(self._id_delta, np.int64, len(self._id_delta))
            deltas = np.fromiter(
                (len(s) for s in self._id_delta.values()),
                np.int64,
                len(self._id_delta),
            )
            self._ensure_base_order()
            lo = np.searchsorted(self._base_ids_sorted, vids, "left")
            hi = np.searchsorted(self._base_ids_sorted, vids, "right")
            m = int((deltas + (hi - lo)).max(initial=1))
            self._mult_hint = max(self._mult_hint, m)

    def _apply_locked(self, op, pid, vid, version, payload) -> None:
        """Apply one WAL record to the in-RAM overlay (replay path — the
        live mutators update state directly and only *write* records)."""
        self._current_version = max(self._current_version, version)
        self._next_pid = max(self._next_pid, pid + 1)
        if op == _OP_ADD:
            d = self._delta(pid, create=True)
            m = self._meta.get(pid)
            if m is None:  # auto-created posting: mirror _require_live
                m = self._meta[pid] = PostingMetadata(
                    version, 0, np.zeros(self.dim, np.float32)
                )
                self._live.add(pid)
                self._bump_topology_locked()
            d.add_ids.append(vid)
            d.add_vecs.append(np.frombuffer(payload, "<f4").copy())
            d.add_versions.append(version)
            self._id_delta.setdefault(vid, set()).add(pid)
            m.version = version
            m.vector_count += 1
            self._max_live = max(self._max_live, m.vector_count)
        elif op == _OP_DEL:
            m = self._meta.get(pid)
            if m is None:
                return
            try:
                self._tombstone_locked(pid, vid, self._parse_del_payload(payload))
            except LireStorageError:
                return
            m.version = version
            m.vector_count -= 1
        elif op == _OP_NEW:
            self._overlay[pid] = _Delta(shadowed=True)
            self._meta[pid] = PostingMetadata(
                version, 0, np.frombuffer(payload, "<f4").copy()
            )
            self._live.add(pid)
            self._bump_topology_locked()
        elif op == _OP_RETIRE:
            # Replay runs at open: no concurrent search can hold a pre-open
            # routing snapshot, so skip the serving snapshot.
            self._retire_locked(pid, snapshot=False)
        elif op == _OP_CENT:
            m = self._meta.get(pid)
            if m is not None:
                m.centroid = np.frombuffer(payload, "<f4").copy()
                m.version = version
                self._bump_topology_locked()
        elif op == _OP_SHADOW:
            self._shadow_locked(pid)

    # -- overlay helpers -----------------------------------------------------

    def _delta(self, pid: int, create: bool = False) -> Optional[_Delta]:
        d = self._overlay.get(pid)
        if d is None and create:
            # A pid with no live base rows (never in the base, or RETIRED —
            # recreating a retired pid must not resurrect its base rows)
            # lives entirely in the overlay.
            shadowed = pid not in self._base_idx or pid not in self._live
            d = self._overlay[pid] = _Delta(shadowed=shadowed)
        return d

    def _base_range(self, pid: int) -> Tuple[int, int]:
        i = self._base_idx[pid]
        return int(self._offsets[i]), int(self._offsets[i + 1])

    def _has_base(self, pid: int) -> bool:
        if pid not in self._base_idx:
            return False
        d = self._overlay.get(pid)
        return d is None or not d.shadowed

    def _dead_base_mask(self, pid: int, d: _Delta) -> np.ndarray:
        if d.dead_base is None:
            s, e = self._base_range(pid)
            d.dead_base = np.zeros(e - s, bool)
        return d.dead_base

    def _retire_locked(self, pid: int, snapshot: bool = True) -> None:
        if pid not in self._live:
            return
        if snapshot:
            ids, vecs, _ = self._live_entries_locked(pid)
            self._retired_snaps[pid] = (ids, vecs)
        d = self._overlay.pop(pid, None)
        if d is not None:
            for vid in d.add_ids:
                s = self._id_delta.get(vid)
                if s is not None:
                    s.discard(pid)
                    if not s:
                        del self._id_delta[vid]
        self._live.discard(pid)
        self._meta.pop(pid, None)
        self._bump_topology_locked()

    def _shadow_locked(self, pid: int) -> int:
        """Materialize the live BASE rows of ``pid`` into the overlay and
        drop tombstoned entries — GC for a base-resident posting.  Entry
        versions are preserved, so later DEL replays still resolve."""
        d = self._delta(pid, create=True)
        reclaimed = 0
        if self._has_base(pid):
            s, e = self._base_range(pid)
            mask = self._dead_base_mask(pid, d)
            keep = np.flatnonzero(~mask)
            reclaimed += int(mask.sum())
            base_ids = np.asarray(self._base_ids[s:e])
            base_vecs = np.asarray(self._base_vecs[s:e], np.float32)
            # Prepend in base order so newest-live tombstoning order holds.
            d.add_ids[:0] = [int(base_ids[i]) for i in keep]
            d.add_vecs[:0] = [base_vecs[i].copy() for i in keep]
            d.add_versions[:0] = [s + int(i) + 1 for i in keep]
            for i in keep:
                self._id_delta.setdefault(int(base_ids[i]), set()).add(pid)
            d.dead -= {s + i + 1 for i in range(e - s)}
            d.dead_base = None
            d.shadowed = True
        # Compact tombstoned overlay adds too.
        if d.dead:
            keep_j = [j for j, v in enumerate(d.add_versions) if v not in d.dead]
            reclaimed += len(d.add_ids) - len(keep_j)
            dropped = set(d.add_versions) & d.dead
            d.add_ids = [d.add_ids[j] for j in keep_j]
            d.add_vecs = [d.add_vecs[j] for j in keep_j]
            d.add_versions = [d.add_versions[j] for j in keep_j]
            d.dead -= dropped
        return reclaimed

    def _tombstone_locked(self, pid: int, vid: int, entry_version: int = 0) -> int:
        """Tombstone ``vid``'s entry with ``entry_version`` (exact) or its
        newest live copy in ``pid``; returns the tombstoned entry version."""
        d = self._delta(pid, create=True)
        for j in range(len(d.add_ids) - 1, -1, -1):
            v = d.add_versions[j]
            if d.add_ids[j] != vid or v in d.dead:
                continue
            if entry_version and v != entry_version:
                continue
            d.dead.add(v)
            self._unindex_if_gone_locked(pid, vid)
            return v
        if self._has_base(pid):
            s, e = self._base_range(pid)
            mask = self._dead_base_mask(pid, d)
            rows = np.flatnonzero(np.asarray(self._base_ids[s:e]) == vid)
            for i in rows[::-1]:
                v = s + int(i) + 1
                if mask[int(i)]:
                    continue
                if entry_version and v != entry_version:
                    continue
                mask[int(i)] = True
                d.dead.add(v)
                return v
        raise LireStorageError(
            f"vector {vid} not found (or already deleted) in posting {pid}"
        )

    def _unindex_if_gone_locked(self, pid: int, vid: int) -> None:
        d = self._overlay.get(pid)
        if d is None:
            return
        alive = any(
            d.add_ids[j] == vid and d.add_versions[j] not in d.dead
            for j in range(len(d.add_ids))
        )
        if not alive:
            s = self._id_delta.get(vid)
            if s is not None:
                s.discard(pid)
                if not s:
                    del self._id_delta[vid]

    # -- reverse index -------------------------------------------------------

    def _ensure_base_order(self) -> None:
        if self._base_order is None:
            order = np.argsort(np.asarray(self._base_ids), kind="stable")
            self._base_order = order.astype(
                np.int32 if self._base_rows < 2**31 else np.int64
            )
            self._base_ids_sorted = np.asarray(self._base_ids)[order]

    def _base_postings_of_locked(self, vid: int) -> List[int]:
        self._ensure_base_order()
        lo = np.searchsorted(self._base_ids_sorted, vid, "left")
        hi = np.searchsorted(self._base_ids_sorted, vid, "right")
        out = []
        for k in range(int(lo), int(hi)):
            row = int(self._base_order[k])
            i = int(np.searchsorted(self._offsets, row, "right")) - 1
            pid = int(self._cids[i])
            if pid not in self._live or not self._has_base(pid):
                continue
            d = self._overlay.get(pid)
            if d is not None and (row + 1) in d.dead:
                continue
            out.append(pid)
        return out

    def postings_of(self, vector_id: int) -> List[int]:
        vid = int(vector_id)
        with self._lock:
            out = set(self._base_postings_of_locked(vid))
            out.update(self._id_delta.get(vid, ()))
            return sorted(out)

    def _note_multiplicity_locked(self, vid: int) -> None:
        m = len(self._id_delta.get(vid, ())) + len(self._base_postings_of_locked(vid))
        if m > self._mult_hint:
            self._mult_hint = m

    def mult_hint(self) -> int:
        """Upper bound on live copies of any single id (search dedup bound)."""
        with self._lock:
            return self._mult_hint

    def max_live_len(self) -> int:
        """Upper bound on live entries in any posting (staging pad bound)."""
        with self._lock:
            return self._max_live

    # -- interface: appends --------------------------------------------------

    def _check_vecs(self, vector_ids, vectors) -> np.ndarray:
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
        return vectors

    def _append_locked(self, pid: int, vid: int, vec: np.ndarray, records) -> int:
        d = self._delta(pid, create=True)
        version = self._next_version()
        d.add_ids.append(vid)
        d.add_vecs.append(vec)
        d.add_versions.append(version)
        self._id_delta.setdefault(vid, set()).add(pid)
        records.append((_OP_ADD, pid, vid, version, self._vec_payload(vec)))
        m = self._meta[pid]
        m.version = version
        m.vector_count += 1
        self._max_live = max(self._max_live, m.vector_count)
        self._note_multiplicity_locked(vid)
        return version

    def _require_live(self, pids) -> None:
        missing = sorted({int(p) for p in pids} - self._live)
        if missing:
            if self.auto_create_postings:
                for pid in missing:
                    # Always overlay-only: a retired base pid must not
                    # resurrect its base rows.
                    self._overlay[pid] = _Delta(shadowed=True)
                    self._meta[pid] = PostingMetadata(
                        self._current_version, 0, np.zeros(self.dim, np.float32)
                    )
                    self._live.add(pid)
                self._bump_topology_locked()
            else:
                raise LireStorageError(
                    f"postings {missing} do not exist (auto-create disabled; "
                    "they may have been retired by a concurrent split/merge)"
                )

    def store_vector(self, posting_id: int, vector_id: int, vector: np.ndarray) -> int:
        vector = self._check_vecs([vector_id], vector)[0]
        with self._lock:
            self._check_writable()
            self._require_live([posting_id])
            records: List[tuple] = []
            version = self._append_locked(int(posting_id), int(vector_id), vector, records)
            self._wal_append_locked(records)
        return version

    def store_vectors(self, posting_id: int, vector_ids, vectors) -> List[int]:
        vectors = self._check_vecs(vector_ids, vectors)
        with self._lock:
            self._check_writable()
            self._require_live([posting_id])
            records: List[tuple] = []
            versions = [
                self._append_locked(int(posting_id), int(vid), vec, records)
                for vid, vec in zip(vector_ids, vectors)
            ]
            self._wal_append_locked(records)
        return versions

    def store_vectors_multi(self, posting_ids, vector_ids, vectors) -> List[int]:
        vectors = self._check_vecs(vector_ids, vectors)
        with self._lock:
            self._check_writable()
            self._require_live(posting_ids)
            records: List[tuple] = []
            versions = [
                self._append_locked(int(pid), int(vid), vec, records)
                for pid, vid, vec in zip(posting_ids, vector_ids, vectors)
            ]
            self._wal_append_locked(records)
        return versions

    # -- interface: tombstones ----------------------------------------------

    def mark_deleted(self, posting_id: int, vector_id: int) -> int:
        with self._lock:
            self._check_writable()
            if posting_id not in self._live:
                raise LireStorageError(f"posting {posting_id} does not exist")
            entry_v = self._tombstone_locked(int(posting_id), int(vector_id))
            version = self._next_version()
            m = self._meta[posting_id]
            m.version = version
            m.vector_count -= 1
            self._wal_append_locked(
                [(_OP_DEL, int(posting_id), int(vector_id), version,
                  self._del_payload(entry_v))]
            )
        return version

    def move_vectors(self, src: int, dst: int, vector_ids, entry_versions):
        """Atomic pinned move src -> dst under one lock — same contract as
        ``LireStorage.move_vectors`` (see there); the Reassign commit path."""
        with self._lock:
            self._check_writable()
            if int(src) not in self._live:
                raise LireStorageError(f"posting {src} does not exist")
            if int(dst) not in self._live:
                raise LireStorageError(f"posting {dst} does not exist")
            ids_s, vecs_s, vers_s = self._live_entries_locked(int(src))
            pos = {
                (int(v), int(vv)): i
                for i, (v, vv) in enumerate(zip(ids_s, vers_s))
            }
            moved: List[int] = []
            versions: List[int] = []
            records: List[tuple] = []
            for vid, ev in zip(vector_ids, entry_versions):
                # pop, not get: a duplicate (vid, entry_version) in the input
                # must be a no-op on its second occurrence — the entry is
                # already tombstoned by then, and letting _tombstone_locked
                # raise mid-batch would leave the dst append in RAM but out
                # of the WAL.
                i = pos.pop((int(vid), int(ev)), None)
                if i is None:
                    continue  # entry changed since planning (or dup): skip
                # COLLAPSE: if dst already holds a live copy of vid (from
                # before, or appended earlier in THIS call — replicas of one
                # vid reassigned from different sources to one destination),
                # retire the src copy without appending a duplicate.  Two
                # live copies in ONE posting would strand one of them past a
                # single delete.
                if int(dst) in self.postings_of(int(vid)):
                    ev2 = self._tombstone_locked(
                        int(src), int(vid), entry_version=int(ev)
                    )
                    v_del = self._next_version()
                    records.append(
                        (_OP_DEL, int(src), int(vid), v_del,
                         self._del_payload(ev2))
                    )
                    moved.append(int(vid))
                    versions.append(v_del)
                    continue
                v_add = self._append_locked(
                    int(dst), int(vid), np.asarray(vecs_s[i], np.float32),
                    records,
                )
                ev2 = self._tombstone_locked(
                    int(src), int(vid), entry_version=int(ev)
                )
                v_del = self._next_version()
                records.append(
                    (_OP_DEL, int(src), int(vid), v_del,
                     self._del_payload(ev2))
                )
                moved.append(int(vid))
                versions.append(v_add)
            if moved:
                ms = self._meta[int(src)]
                ms.version = self._current_version
                ms.vector_count -= len(moved)
                self._wal_append_locked(records)
        return moved, versions

    def mark_deleted_batch(self, posting_id: int, vector_ids) -> Tuple[List[int], List[int]]:
        with self._lock:
            self._check_writable()
            if posting_id not in self._live:
                raise LireStorageError(f"posting {posting_id} does not exist")
            hit_ids: List[int] = []
            versions: List[int] = []
            records: List[tuple] = []
            for vid in vector_ids:
                try:
                    entry_v = self._tombstone_locked(int(posting_id), int(vid))
                except LireStorageError:
                    continue
                version = self._next_version()
                hit_ids.append(int(vid))
                versions.append(version)
                records.append(
                    (_OP_DEL, int(posting_id), int(vid), version,
                     self._del_payload(entry_v))
                )
            if not hit_ids:
                return [], []
            self._wal_append_locked(records)
            m = self._meta[posting_id]
            m.version = versions[-1]
            m.vector_count -= len(hit_ids)
        return hit_ids, versions

    # -- interface: reads ----------------------------------------------------

    def _live_entries_locked(
        self, pid: int, include_deleted: bool = False
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        d = self._overlay.get(pid)
        parts_i: List[np.ndarray] = []
        parts_v: List[np.ndarray] = []
        parts_ver: List[np.ndarray] = []
        if self._has_base(pid):
            s, e = self._base_range(pid)
            ids = np.asarray(self._base_ids[s:e])
            vecs = np.asarray(self._base_vecs[s:e], np.float32)
            vers = np.arange(s + 1, e + 1, dtype=np.int64)
            if d is not None and d.dead_base is not None and not include_deleted:
                keep = ~d.dead_base
                ids, vecs, vers = ids[keep], vecs[keep], vers[keep]
            parts_i.append(ids.astype(np.int64))
            parts_v.append(vecs)
            parts_ver.append(vers)
        if d is not None and d.add_ids:
            sel = (
                range(len(d.add_ids))
                if include_deleted
                else [j for j, v in enumerate(d.add_versions) if v not in d.dead]
            )
            sel = list(sel)
            if sel:
                parts_i.append(np.array([d.add_ids[j] for j in sel], np.int64))
                parts_v.append(np.stack([d.add_vecs[j] for j in sel]).astype(np.float32))
                parts_ver.append(np.array([d.add_versions[j] for j in sel], np.int64))
        if not parts_i:
            return (
                np.empty(0, np.int64),
                np.empty((0, self.dim), np.float32),
                np.empty(0, np.int64),
            )
        return (
            np.concatenate(parts_i),
            np.concatenate(parts_v),
            np.concatenate(parts_ver),
        )

    def get_posting(self, posting_id: int, include_deleted: bool = False):
        with self._lock:
            if posting_id not in self._live:
                raise LireStorageError(f"posting {posting_id} does not exist")
            return self._live_entries_locked(int(posting_id), include_deleted)

    def stage_patch(self, posting_id: int):
        """Search-staging overlay for one posting, or None when the base
        slab is already exact.  Returns (mode, payload):

          ("replace", (ids (m,), vecs (m, d) f32)) — overlay-only/shadowed
          ("patch", (dead_base bool mask | None, add_ids, add_vecs))
        """
        with self._lock:
            if posting_id not in self._live:
                snap = self._retired_snaps.get(int(posting_id))
                if snap is not None:
                    # Retired mid-search: serve the pre-retire snapshot
                    # (successors are invisible to this search's routing).
                    return ("replace", snap)
                return ("replace", (np.empty(0, np.int64),
                                    np.empty((0, self.dim), np.float32)))
            d = self._overlay.get(posting_id)
            if d is None:
                return None
            if d.shadowed or not self._has_base(posting_id):
                ids, vecs, _ = self._live_entries_locked(int(posting_id))
                return ("replace", (ids, vecs))
            sel = [j for j, v in enumerate(d.add_versions) if v not in d.dead]
            add_ids = np.array([d.add_ids[j] for j in sel], np.int64)
            add_vecs = (
                np.stack([d.add_vecs[j] for j in sel]).astype(np.float32)
                if sel
                else np.empty((0, self.dim), np.float32)
            )
            mask = None
            if d.dead_base is not None and d.dead_base.any():
                mask = d.dead_base.copy()
            if mask is None and not len(add_ids):
                return None
            return ("patch", (mask, add_ids, add_vecs))

    def stage_patches(self, posting_ids) -> Dict[int, tuple]:
        """Batched :meth:`stage_patch` — ONE lock acquisition for a whole
        search batch's unique probed postings.  Postings whose base slab is
        already exact are absent from the result."""
        out: Dict[int, tuple] = {}
        with self._lock:
            for pid in posting_ids:
                pid = int(pid)
                if pid in out:
                    continue
                p = self.stage_patch(pid)
                if p is not None:
                    out[pid] = p
        return out

    def posting_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._live)

    def has_posting(self, posting_id: int) -> bool:
        with self._lock:
            return posting_id in self._live

    def get_vector_count(self, posting_id: int) -> int:
        with self._lock:
            m = self._meta.get(posting_id)
            return m.vector_count if m else 0

    def get_posting_version(self, posting_id: int) -> int:
        with self._lock:
            m = self._meta.get(posting_id)
            if m is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            return m.version

    def get_posting_centroid(self, posting_id: int) -> np.ndarray:
        with self._lock:
            m = self._meta.get(posting_id)
            if m is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            return m.centroid.copy()

    def update_posting_centroid(self, posting_id: int, centroid: np.ndarray) -> None:
        centroid = np.asarray(centroid, np.float32).reshape(-1)
        with self._lock:
            self._check_writable()
            m = self._meta.get(posting_id)
            if m is None:
                raise LireStorageError(f"posting {posting_id} does not exist")
            m.centroid = centroid.copy()
            version = self._next_version()
            m.version = version
            self._bump_topology_locked()
            self._wal_append_locked(
                [(_OP_CENT, int(posting_id), 0, version, self._vec_payload(centroid))]
            )

    # -- interface: lifecycle ops -------------------------------------------

    def import_posting(self, posting_id: int, ids, vectors, centroid) -> None:
        ids = np.asarray(ids, np.int64)
        vectors = self._check_vecs(ids, vectors)
        centroid = np.asarray(centroid, np.float32).reshape(-1)
        with self._lock:
            self._check_writable()
            if posting_id in self._live:
                raise LireStorageError(f"posting {posting_id} already exists")
            pid = int(posting_id)
            version = self._next_version()
            records: List[tuple] = [
                (_OP_TXN_BEGIN, 0, 0, 0, None),
                (_OP_NEW, pid, 0, version, self._vec_payload(centroid)),
            ]
            self._overlay[pid] = _Delta(shadowed=True)
            self._meta[pid] = PostingMetadata(version, 0, centroid.copy())
            self._live.add(pid)
            self._retired_snaps.pop(pid, None)
            self._next_pid = max(self._next_pid, pid + 1)
            for vid, vec in zip(ids, vectors):
                self._append_locked(pid, int(vid), vec, records)
            records.append((_OP_TXN_END, 0, 0, 0, None))
            self._bump_topology_locked()
            self._wal_append_locked(records)

    def delete_posting(self, posting_id: int) -> None:
        with self._lock:
            self._check_writable()
            if posting_id not in self._live:
                return
            version = self._next_version()
            self._wal_append_locked([(_OP_RETIRE, int(posting_id), 0, version, None)])
            self._retire_locked(int(posting_id))

    def atomic_replace(self, old_ids, expected_versions, new_postings) -> bool:
        """Retire ``old_ids`` and create ``new_postings`` atomically — all
        records ride ONE WAL transaction, so a crash either applies the
        whole swap on replay or none of it (BEGIN without END is
        discarded)."""
        with self._lock:
            self._check_writable()
            for pid, expect in zip(old_ids, expected_versions):
                m = self._meta.get(pid)
                if m is None or m.version != expect:
                    return False
            records: List[tuple] = [(_OP_TXN_BEGIN, 0, 0, 0, None)]
            for pid, ids, vecs, centroid in new_postings:
                pid = int(pid)
                centroid = np.asarray(centroid, np.float32).reshape(-1)
                version = self._next_version()
                records.append((_OP_NEW, pid, 0, version, self._vec_payload(centroid)))
                self._overlay[pid] = _Delta(shadowed=True)
                self._meta[pid] = PostingMetadata(version, 0, centroid.copy())
                self._live.add(pid)
                self._next_pid = max(self._next_pid, pid + 1)
                vecs = self._check_vecs(ids, vecs)
                for vid, vec in zip(ids, vecs):
                    self._append_locked(pid, int(vid), vec, records)
            for pid in old_ids:
                version = self._next_version()
                records.append((_OP_RETIRE, int(pid), 0, version, None))
                self._retire_locked(int(pid))
            records.append((_OP_TXN_END, 0, 0, 0, None))
            self._bump_topology_locked()
            self._wal_append_locked(records)
        return True

    # -- GC ------------------------------------------------------------------

    def needs_garbage_collection(self, posting_id: int, threshold: float) -> bool:
        with self._lock:
            if posting_id not in self._live:
                return False
            d = self._overlay.get(posting_id)
            dead = len(d.dead) if d is not None else 0
            total = len(d.add_ids) if d is not None else 0
            if self._has_base(posting_id):
                s, e = self._base_range(posting_id)
                total += e - s
            return total > 0 and dead / total > threshold

    def collect_garbage(self, posting_id: int) -> int:
        """Drop tombstoned entries.  A base-resident posting is SHADOWED
        (live base rows materialize into the overlay — logged, so replay
        reproduces it); physical disk space reclaims at ``compact()``."""
        with self._lock:
            self._check_writable()
            if posting_id not in self._live:
                return 0
            d = self._overlay.get(posting_id)
            if d is None or not d.dead:
                return 0
            version = self._next_version()
            self._wal_append_locked([(_OP_SHADOW, int(posting_id), 0, version, None)])
            return self._shadow_locked(int(posting_id))

    # -- flush / compaction --------------------------------------------------

    def flush(self) -> None:
        """fsync the WAL.  Mutators append + flush to the OS page cache
        before returning (durable against PROCESS crash); power-loss
        durability is at flush()/compact() boundaries — the same contract
        as a group-commit database.  Per-append fsync would serialize every
        insert behind a disk barrier; callers that need sync-per-op can
        call flush() per op."""
        with self._lock:
            if os.path.exists(self._wal_path):
                with open(self._wal_path, "ab") as f:
                    f.flush()
                    os.fsync(f.fileno())

    def overlay_rows(self) -> int:
        """Live rows resident in the RAM overlay (compaction heuristic)."""
        with self._lock:
            return sum(
                len(d.add_ids) - len(set(d.add_versions) & d.dead)
                for d in self._overlay.values()
            )

    def compact(self) -> None:
        """Fold base + overlay into a fresh packed CSR + centroids +
        manifest, then truncate the WAL.  Streamed one posting at a time —
        peak RAM stays O(posting).  Crash-safe: the three replacement files
        are fully written as ``.tmp`` first, an intent journal marks the
        swap, and recovery rolls the swap forward (tmps are complete by
        construction) before deleting the then-stale WAL."""
        with self._lock:
            self._check_writable()
            pids = sorted(self._live)
            counts = np.array(
                [self._meta[p].vector_count for p in pids], np.int64
            )
            offsets = np.zeros(len(pids) + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            P = int(offsets[-1])
            from spfresh_tpu_torch.index.posting_store import PACKED_MAGIC

            packed_tmp = self._packed_path + ".tmp"
            header = PACKED_MAGIC + struct.pack("<iqi", len(pids), P, self.dim)
            cids_b = np.ascontiguousarray(pids, "<i8").tobytes()
            offs_b = np.ascontiguousarray(offsets, "<i8").tobytes()
            ids_off = len(header) + len(cids_b) + len(offs_b)
            vec_off = ids_off + 8 * P
            with open(packed_tmp, "wb") as f:
                f.write(header + cids_b + offs_b)
                f.truncate(vec_off + 4 * P * self.dim)
                for i, pid in enumerate(pids):
                    ids, vecs, _ = self._live_entries_locked(pid)
                    if len(ids) != counts[i]:  # pragma: no cover - invariant
                        raise LireStorageError(
                            f"posting {pid}: live count drifted "
                            f"({len(ids)} != {counts[i]})"
                        )
                    f.seek(ids_off + 8 * int(offsets[i]))
                    f.write(np.ascontiguousarray(ids, "<i8").tobytes())
                    f.seek(vec_off + 4 * self.dim * int(offsets[i]))
                    f.write(np.ascontiguousarray(vecs, "<f4").tobytes())
                f.flush()
                os.fsync(f.fileno())
            cent_tmp = self._cent_path + ".tmp"
            cents = (
                np.stack([self._meta[p].centroid for p in pids])
                if pids
                else np.empty((0, self.dim), np.float32)
            )
            with gzip.open(cent_tmp, "wb") as f:
                np.save(f, cents.astype(np.float32))
            # gzip writes its trailer at close — sync the finished file.
            with open(cent_tmp, "rb") as f:
                os.fsync(f.fileno())
            manifest = dict(self._manifest)
            manifest.update(
                num_clusters=len(pids),
                cluster_ids=[int(p) for p in pids],
                next_cluster_id=int(self._next_pid),
            )
            if self._manifest.get("max_dup") is not None:
                # Upper bound stays valid post-compact: compaction only
                # drops entries, and the overlay's running hint covers every
                # id the update stream touched.
                manifest["max_dup"] = max(
                    int(self._manifest["max_dup"]), self._mult_hint
                )
            else:
                # LEGACY manifest (no save-time bound): the base's replica
                # multiplicity is unknown here — stamping max(1, hint)
                # would hand lazy opens a TOO-LOW dedup bound (duplicate
                # ids in one result row).  Leave the key absent; openers
                # fall back to the exact scan.
                manifest.pop("max_dup", None)
            man_tmp = self._manifest_path + ".tmp"
            with open(man_tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            journal = os.path.join(self.directory, _JOURNAL)
            jtmp = journal + ".tmp"
            # The recovery contract 'journal present => tmps complete' must
            # hold across POWER loss, not just process crash: every tmp is
            # fsynced above, the tmp DIRECTORY ENTRIES are fsynced before
            # the journal rename, and each namespace batch below is ordered
            # by a directory fsync.  Without the ordering, a filesystem
            # could persist the data renames + the journal unlink but LOSE
            # the WAL unlink — replaying pre-compact records onto the new
            # base on reopen (double-applied mutations).
            _fsync_dir(self.directory)  # tmp entries durable
            with open(jtmp, "w") as f:
                json.dump({"swap": True}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(jtmp, journal)
            _fsync_dir(self.directory)  # journal durable AFTER tmps
            os.replace(packed_tmp, self._packed_path)
            os.replace(cent_tmp, self._cent_path)
            os.replace(man_tmp, self._manifest_path)
            if os.path.exists(self._wal_path):
                os.remove(self._wal_path)
            _fsync_dir(self.directory)  # swap + WAL unlink durable
            os.remove(journal)
            _fsync_dir(self.directory)  # journal removal last
            # Reload the fresh base in place.
            self._reset_from_disk_locked()

    def _recover_compaction(self) -> None:
        """Roll an interrupted :meth:`compact` forward: journal present
        means every ``.tmp`` was completely written, so finish the renames
        and delete the (pre-compaction, now stale) WAL."""
        journal = os.path.join(self.directory, _JOURNAL)
        if not os.path.exists(journal):
            for tmp in (
                self._packed_path + ".tmp",
                self._cent_path + ".tmp",
                self._manifest_path + ".tmp",
                journal + ".tmp",
            ):
                if os.path.exists(tmp):  # crash BEFORE the journal: discard
                    os.remove(tmp)
            return
        for path in (self._packed_path, self._cent_path, self._manifest_path):
            if os.path.exists(path + ".tmp"):
                os.replace(path + ".tmp", path)
        wal = os.path.join(self.directory, "overlay.wal")
        if os.path.exists(wal):
            os.remove(wal)
        _fsync_dir(self.directory)  # roll-forward + WAL unlink durable
        os.remove(journal)
        _fsync_dir(self.directory)

    def _reset_from_disk_locked(self) -> None:
        from spfresh_tpu_torch.index.posting_store import read_packed_postings

        with open(self._manifest_path) as f:
            self._manifest = json.load(f)
        cids, offsets, ids, vectors = read_packed_postings(self._packed_path, mmap=True)
        self._cids = np.asarray(cids)
        self._offsets = np.asarray(offsets)
        self._base_ids = ids
        self._base_vecs = vectors
        self._base_idx = {int(c): i for i, c in enumerate(self._cids)}
        self._base_rows = int(self._offsets[-1]) if len(self._offsets) else 0
        with gzip.open(self._cent_path, "rb") as f:
            cent = np.load(f)
        self._overlay.clear()
        self._retired_snaps.clear()
        self._live = set(self._base_idx)
        self._meta = {}
        for pid, i in self._base_idx.items():
            s, e = int(self._offsets[i]), int(self._offsets[i + 1])
            self._meta[pid] = PostingMetadata(max(e, 1), e - s, cent[i].astype(np.float32))
        self._current_version = max(self._current_version, self._base_rows)
        self._id_delta.clear()
        self._base_order = None
        self._base_ids_sorted = None
        self._wal_records = 0
        self._bump_topology_locked()

    def close(self) -> None:
        """Release mmaps (the WAL already holds every mutation)."""
        # numpy memmaps release with the arrays; nothing buffered to sync.
