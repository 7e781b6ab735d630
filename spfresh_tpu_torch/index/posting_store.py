"""Posting-list persistence (counterpart of ``spfresh_tpu/index/posting_store.py``,
byte-compatible with it: an index saved by either package loads in the other).

Two layouts, both little-endian struct-of-arrays (ids block, then vectors):

* ``FileBasedPostingListStore`` — one file per cluster plus a JSON
  manifest, lazy reads.
* packed CSR helpers — a single file holding every posting list,
  mmap-friendly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"SPFPL1\x00\x00"
PACKED_MAGIC = b"SPFCSR1\x00"
MANIFEST_NAME = "cluster_ids.json"


@dataclasses.dataclass
class PointData:
    """Mirror of PointData (posting_lists.rs:7-11)."""

    point_id: int
    vector: np.ndarray


def _posting_path(base: str, cluster_id: int) -> str:
    # Path scheme parity: posting_list_{id}.bin (posting_lists.rs:42-45).
    return os.path.join(base, f"posting_list_{cluster_id}.bin")


def write_posting_file(path: str, ids: np.ndarray, vectors: np.ndarray) -> None:
    ids = np.ascontiguousarray(ids, dtype="<i8")
    vectors = np.ascontiguousarray(vectors, dtype="<f4")
    if vectors.ndim != 2 or ids.shape[0] != vectors.shape[0]:
        raise ValueError(f"bad posting shapes ids={ids.shape} vectors={vectors.shape}")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<ii", ids.shape[0], vectors.shape[1]))
        f.write(ids.tobytes())
        f.write(vectors.tobytes())


def read_posting_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a posting-list file (magic {magic!r})")
        count, dim = struct.unpack("<ii", f.read(8))
        ids = np.frombuffer(f.read(8 * count), dtype="<i8").copy()
        vectors = (
            np.frombuffer(f.read(4 * count * dim), dtype="<f4").reshape(count, dim).copy()
        )
    return ids, vectors


class PostingListStore:
    """Abstract store (trait parity: posting_lists.rs:13-24)."""

    def insert_posting_list(self, cluster_id: int, ids: np.ndarray, vectors: np.ndarray) -> None:
        raise NotImplementedError

    def get_posting_list(self, cluster_id: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def delete_posting_list(self, cluster_id: int) -> None:
        raise NotImplementedError

    def cluster_ids(self) -> List[int]:
        raise NotImplementedError


class FileBasedPostingListStore(PostingListStore):
    """One binary file per cluster + JSON manifest
    (parity: FileBasedPostingListStore, posting_lists.rs:26-129)."""

    def __init__(self, base_directory: str):
        self.base_directory = str(base_directory)
        os.makedirs(self.base_directory, exist_ok=True)
        self._cluster_ids: Dict[int, int] = {}  # id -> count

    def insert_posting_list(self, cluster_id: int, ids, vectors) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        vectors = np.asarray(vectors, dtype=np.float32)
        write_posting_file(_posting_path(self.base_directory, cluster_id), ids, vectors)
        self._cluster_ids[int(cluster_id)] = int(ids.shape[0])
        # The reference re-saves the manifest on every insert
        # (posting_lists.rs:90-95); we keep that durability behavior — the
        # manifest is tiny.
        self.save_manifest()

    def get_posting_list(self, cluster_id: int):
        path = _posting_path(self.base_directory, cluster_id)
        if not os.path.exists(path):
            return None
        return read_posting_file(path)

    def delete_posting_list(self, cluster_id: int) -> None:
        path = _posting_path(self.base_directory, cluster_id)
        if os.path.exists(path):
            os.remove(path)
        self._cluster_ids.pop(int(cluster_id), None)
        self.save_manifest()

    def cluster_ids(self) -> List[int]:
        return sorted(self._cluster_ids)

    def save_manifest(self) -> None:
        tmp = os.path.join(self.base_directory, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"cluster_ids": {str(k): v for k, v in self._cluster_ids.items()}}, f)
        os.replace(tmp, os.path.join(self.base_directory, MANIFEST_NAME))

    @classmethod
    def load_from_directory(cls, base_directory: str) -> "FileBasedPostingListStore":
        """Lazy open: reads only the manifest; vectors stay on disk
        (posting_lists.rs:115-129)."""
        store = cls(base_directory)
        path = os.path.join(base_directory, MANIFEST_NAME)
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)["cluster_ids"]
            store._cluster_ids = {int(k): int(v) for k, v in raw.items()}
        return store


# ---------------------------------------------------------------------------
# Packed CSR format — single file, mmap-friendly (HBM-resident fast path)
# ---------------------------------------------------------------------------


def write_packed_postings(
    path: str,
    cluster_ids: Sequence[int],
    offsets: np.ndarray,
    ids: np.ndarray,
    vectors: np.ndarray,
) -> None:
    """Layout: magic | C:i32 | P:i64 | dim:i32 | cluster_ids[C]:i64 |
    offsets[C+1]:i64 | ids[P]:i64 | vectors[P*dim]:f32."""
    cids = np.ascontiguousarray(cluster_ids, dtype="<i8")
    offsets = np.ascontiguousarray(offsets, dtype="<i8")
    ids = np.ascontiguousarray(ids, dtype="<i8")
    vectors = np.ascontiguousarray(vectors, dtype="<f4")
    C = cids.shape[0]
    P, dim = vectors.shape
    if offsets.shape[0] != C + 1 or ids.shape[0] != P or int(offsets[-1]) != P:
        raise ValueError("inconsistent CSR arrays")
    with open(path, "wb") as f:
        f.write(PACKED_MAGIC)
        f.write(struct.pack("<iqi", C, P, dim))
        # tofile, not tobytes: no whole-array byte copies (the vector block
        # is the corpus-scale one).
        cids.tofile(f)
        offsets.tofile(f)
        ids.tofile(f)
        vectors.tofile(f)


def write_packed_postings_streaming(
    path: str,
    cluster_ids: Sequence[int],
    offsets: np.ndarray,
    ids: np.ndarray,
    vec_blocks,
    dim: int,
) -> None:
    """Same layout as :func:`write_packed_postings`, but the vector region
    streams from an iterable of (m_i, dim) float32 blocks in cluster order —
    the full (P, dim) array never exists in RAM.  This is how a lazily
    materialized index (posting vectors backed by the build corpus) saves at
    corpus scale: peak memory is one posting's block, not
    replication x corpus."""
    cids = np.ascontiguousarray(cluster_ids, dtype="<i8")
    offsets = np.ascontiguousarray(offsets, dtype="<i8")
    ids = np.ascontiguousarray(ids, dtype="<i8")
    C = cids.shape[0]
    P = ids.shape[0]
    if offsets.shape[0] != C + 1 or int(offsets[-1]) != P:
        raise ValueError("inconsistent CSR arrays")
    with open(path, "wb") as f:
        f.write(PACKED_MAGIC)
        f.write(struct.pack("<iqi", C, P, dim))
        cids.tofile(f)
        offsets.tofile(f)
        ids.tofile(f)
        written = 0
        for blk in vec_blocks:
            blk = np.ascontiguousarray(blk, dtype="<f4")
            if blk.ndim != 2 or blk.shape[1] != dim:
                raise ValueError(f"vector block shape {blk.shape} != (*, {dim})")
            blk.tofile(f)
            written += blk.shape[0]
        if written != P:
            raise ValueError(f"streamed {written} vector rows, expected {P}")


def read_packed_postings(path: str, mmap: bool = True):
    """Returns (cluster_ids, offsets, ids, vectors).  With ``mmap=True`` the
    big blocks are memory-mapped (zero-copy open, pages fault in on use)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != PACKED_MAGIC:
            raise ValueError(f"{path}: not a packed postings file (magic {magic!r})")
        C, P, dim = struct.unpack("<iqi", f.read(16))
        header = 8 + 16
    cids_off = header
    offs_off = cids_off + 8 * C
    ids_off = offs_off + 8 * (C + 1)
    vec_off = ids_off + 8 * P
    if mmap:
        cids = np.memmap(path, dtype="<i8", mode="r", offset=cids_off, shape=(C,))
        offsets = np.memmap(path, dtype="<i8", mode="r", offset=offs_off, shape=(C + 1,))
        ids = np.memmap(path, dtype="<i8", mode="r", offset=ids_off, shape=(P,))
        vectors = np.memmap(path, dtype="<f4", mode="r", offset=vec_off, shape=(P, dim))
    else:
        with open(path, "rb") as f:
            f.seek(cids_off)
            cids = np.frombuffer(f.read(8 * C), dtype="<i8").copy()
            offsets = np.frombuffer(f.read(8 * (C + 1)), dtype="<i8").copy()
            ids = np.frombuffer(f.read(8 * P), dtype="<i8").copy()
            vectors = np.frombuffer(f.read(4 * P * dim), dtype="<f4").reshape(P, dim).copy()
    return cids, offsets, ids, vectors
