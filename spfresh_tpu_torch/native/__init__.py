"""ctypes bindings for the disk tier's native host runtime (counterpart of
``spfresh_tpu/native/``; a copy owned by the port of its C++ source,
``src/spfresh_native.cpp``, with the same C ABI).

The library is built at first use with::

    g++ -O3 -std=c++17 -fPIC -Wall -Wextra -pthread -shared \\
        -o build/native/libspfresh_native_<hash>.so src/spfresh_native.cpp

and cached under ``build/native/`` in the checkout, keyed by a hash of the
source and the flags, as ``ops/_build.py`` caches the kernels.  A failed
build raises; nothing falls back to Python.  ``index.lazy._gather_plain``
is the plain version of the padded gather that the tests hold this one to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "spfresh_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libspfresh_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the cached one is missing; return its path.
    Raises ``RuntimeError`` when the compiler is missing or fails."""
    out = _library_path()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the disk tier's native reader needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.spf_version.restype = c.c_char_p
    lib.spf_csr_open.restype = c.c_void_p
    lib.spf_csr_open.argtypes = [c.c_char_p]
    lib.spf_csr_close.argtypes = [c.c_void_p]
    lib.spf_csr_num_clusters.argtypes = [c.c_void_p]
    lib.spf_csr_num_clusters.restype = c.c_int32
    lib.spf_csr_num_points.argtypes = [c.c_void_p]
    lib.spf_csr_num_points.restype = c.c_int64
    lib.spf_csr_dim.argtypes = [c.c_void_p]
    lib.spf_csr_dim.restype = c.c_int32
    lib.spf_csr_cluster_ids.argtypes = [c.c_void_p]
    lib.spf_csr_cluster_ids.restype = c.POINTER(c.c_int64)
    lib.spf_csr_offsets.argtypes = [c.c_void_p]
    lib.spf_csr_offsets.restype = c.POINTER(c.c_int64)
    lib.spf_csr_posting.argtypes = [
        c.c_void_p, c.c_int32,
        c.POINTER(c.POINTER(c.c_int64)), c.POINTER(c.POINTER(c.c_float)),
    ]
    lib.spf_csr_posting.restype = c.c_int64
    gather_args = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int32, c.c_int32,
        c.POINTER(c.c_float), c.POINTER(c.c_int64), c.POINTER(c.c_int32),
    ]
    lib.spf_csr_gather_padded.argtypes = gather_args
    lib.spf_csr_gather_padded.restype = c.c_int32
    lib.spf_csr_gather_async.argtypes = gather_args
    lib.spf_csr_gather_async.restype = c.c_void_p
    lib.spf_csr_gather_join.argtypes = [c.c_void_p]
    lib.spf_csr_gather_join.restype = c.c_int32
    lib.spf_vecs_shape.argtypes = [c.c_char_p, c.c_int32, c.POINTER(c.c_int32)]
    lib.spf_vecs_shape.restype = c.c_int64
    lib.spf_vecs_read.argtypes = [c.c_char_p, c.c_int32, c.c_void_p]
    lib.spf_vecs_read.restype = c.c_int32


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


class _MmapView(np.ndarray):
    """ndarray view into the reader's mmap that keeps the reader alive (an
    explicit ``close()`` still invalidates it; see ``NativeCsr.posting``)."""

    _keepalive = None


def _view_with_owner(arr: np.ndarray, owner) -> np.ndarray:
    v = arr.view(_MmapView)
    v._keepalive = owner
    return v


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeCsr:
    """mmap'd packed-postings reader (zero-copy per-posting views)."""

    def __init__(self, path: str):
        self._lib = library()
        self._h = self._lib.spf_csr_open(str(path).encode())
        if not self._h:
            raise ValueError(f"{path}: not a packed postings file")
        self.num_clusters = self._lib.spf_csr_num_clusters(self._h)
        self.num_points = self._lib.spf_csr_num_points(self._h)
        self.dim = self._lib.spf_csr_dim(self._h)

    def cluster_ids(self) -> np.ndarray:
        p = self._lib.spf_csr_cluster_ids(self._h)
        return np.ctypeslib.as_array(p, shape=(self.num_clusters,)).copy()

    def posting(self, index: int):
        """(ids, vectors) zero-copy views of the posting at ``index``.  The
        views hold a reference to this reader, so dropping the reader while
        they live is safe; an explicit ``close()`` invalidates them."""
        ids_p = ctypes.POINTER(ctypes.c_int64)()
        vec_p = ctypes.POINTER(ctypes.c_float)()
        n = self._lib.spf_csr_posting(self._h, index, ctypes.byref(ids_p), ctypes.byref(vec_p))
        if n < 0:
            raise IndexError(index)
        if n == 0:
            return np.empty(0, np.int64), np.empty((0, self.dim), np.float32)
        ids = _view_with_owner(np.ctypeslib.as_array(ids_p, shape=(int(n),)), self)
        vecs = _view_with_owner(np.ctypeslib.as_array(vec_p, shape=(int(n), self.dim)), self)
        return ids, vecs

    def _buffers(self, indices, pad: int):
        indices = np.ascontiguousarray(indices, np.int32)
        m = len(indices)
        return (indices, np.empty((m, pad, self.dim), np.float32), np.empty((m, pad), np.int64),
                np.empty((m,), np.int32))

    def gather_padded(self, indices: np.ndarray, pad: int):
        """Stage the postings ``indices`` into a fresh (m, pad, dim) slab
        batch: (vecs f32 zero-padded, ids int64 (-1 padded), lens int32)."""
        indices, vecs, ids, lens = self._buffers(indices, pad)
        rc = self._lib.spf_csr_gather_padded(
            self._h, _ptr(indices, ctypes.c_int32), len(indices), pad,
            _ptr(vecs, ctypes.c_float), _ptr(ids, ctypes.c_int64), _ptr(lens, ctypes.c_int32))
        if rc != 0:
            raise IndexError("bad posting index in gather")
        return vecs, ids, lens

    def gather_padded_async(self, indices: np.ndarray, pad: int) -> "AsyncGather":
        """Start ``gather_padded`` on a background native thread; ``join()``
        the returned job when the slabs are needed."""
        indices, vecs, ids, lens = self._buffers(indices, pad)
        job = self._lib.spf_csr_gather_async(
            self._h, _ptr(indices, ctypes.c_int32), len(indices), pad,
            _ptr(vecs, ctypes.c_float), _ptr(ids, ctypes.c_int64), _ptr(lens, ctypes.c_int32))
        return AsyncGather(self._lib, job, vecs, ids, lens)

    def close(self):
        if self._h:
            self._lib.spf_csr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AsyncGather:
    """An in-flight native staging job; owns its output buffers."""

    def __init__(self, lib, job, vecs, ids, lens):
        self._lib = lib
        self._job = job
        self._out = (vecs, ids, lens)

    def join(self):
        if self._job:
            rc = self._lib.spf_csr_gather_join(self._job)
            self._job = None
            if rc != 0:
                raise IndexError("bad posting index in async gather")
        return self._out

    def __del__(self):
        try:
            self.join()
        except Exception:
            pass


_ELEM_SIZE = {"f": 4, "i": 4, "b": 1}
_DTYPE = {"f": np.float32, "i": np.int32, "b": np.uint8}


def read_vecs_native(path: str, kind: str = "f") -> np.ndarray:
    """(n, dim) array of an fvecs (``"f"``), ivecs (``"i"``) or bvecs
    (``"b"``) file, read through the library's mmap reader."""
    os.stat(path)  # FileNotFoundError for a missing file
    lib = library()
    dim = ctypes.c_int32()
    n = lib.spf_vecs_shape(str(path).encode(), _ELEM_SIZE[kind], ctypes.byref(dim))
    if n < 0:
        raise ValueError(f"{path}: not a valid vecs file")
    out = np.empty((int(n), int(dim.value)), _DTYPE[kind])
    rc = lib.spf_vecs_read(str(path).encode(), _ELEM_SIZE[kind],
                           out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{path}: vecs read failed (rc={rc})")
    return out
