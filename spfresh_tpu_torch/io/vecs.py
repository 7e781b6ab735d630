"""fvecs / ivecs / bvecs readers and writers (counterpart of
``spfresh_tpu/io/vecs.py``, the Rust reference's ``main.rs`` readers).

Format: little-endian records of ``[dim: i32][payload: dim * elem]``, every
record of a file with the same dim.  Reads go through the disk tier's native
mmap reader (``spfresh_tpu_torch.native``, built at first use; a failed build
raises).  ``read_vecs_plain`` is the numpy version the tests hold it to.
"""

from __future__ import annotations

import os

import numpy as np

from spfresh_tpu_torch import native

_ELEM = {"f": ("<f4", 4), "i": ("<i4", 4), "b": ("<u1", 1)}


def read_vecs_plain(path: str, kind: str) -> np.ndarray:
    """Plain numpy reader: one ``np.fromfile`` and a strided view."""
    dtype, esize = _ELEM[kind]
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype="<i4", count=1)
    dim = int(head[0]) if head.size else 0
    if dim <= 0:
        raise ValueError(f"{path}: bad leading dimension {dim}")
    rec = 4 + dim * esize
    if size % rec != 0:
        raise ValueError(f"{path}: size {size} not a multiple of record size {rec}")
    n = size // rec
    raw = np.fromfile(path, dtype=np.uint8).reshape(n, rec)
    dims = raw[:, :4].view("<i4").ravel()
    if not (dims == dim).all():
        raise ValueError(f"{path}: inconsistent record dimensions")
    return np.ascontiguousarray(raw[:, 4:].view(dtype).reshape(n, dim))


def read_fvecs(path: str) -> np.ndarray:
    """(n, d) float32."""
    return native.read_vecs_native(path, "f")


def read_ivecs(path: str) -> np.ndarray:
    """(n, k) int32 (ground-truth files)."""
    return native.read_vecs_native(path, "i")


def read_bvecs(path: str) -> np.ndarray:
    """(n, d) uint8 (SIFT1B-style)."""
    return native.read_vecs_native(path, "b")


def _write_vecs(path: str, arr: np.ndarray, dtype: str) -> None:
    arr = np.ascontiguousarray(arr)
    n, d = arr.shape
    out = np.empty((n, 4 + d * np.dtype(dtype).itemsize), np.uint8)
    out[:, :4] = np.full((n, 1), d, "<i4").view(np.uint8).reshape(n, 4)
    out[:, 4:] = arr.astype(dtype).view(np.uint8).reshape(n, -1)
    out.tofile(path)


def write_fvecs(path: str, arr: np.ndarray) -> None:
    _write_vecs(path, np.asarray(arr, np.float32), "<f4")


def write_ivecs(path: str, arr: np.ndarray) -> None:
    _write_vecs(path, np.asarray(arr, np.int32), "<i4")


def write_bvecs(path: str, arr: np.ndarray) -> None:
    _write_vecs(path, np.asarray(arr, np.uint8), "<u1")
