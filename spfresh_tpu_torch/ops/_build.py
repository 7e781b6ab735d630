"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them at once, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu      # each, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/kernels/libspfresh_kernels_<hash>.so <tmp>/*.o

The library is built at first use and cached under ``build/kernels/`` in the
checkout, keyed by a hash of the sources and flags, so a fresh checkout
builds everything the first time a kernel launches.  No PyTorch headers
are included: the build takes seconds, not minutes.  A failed build raises;
there is no fallback.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspfresh_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels if the cached library is missing; return its path."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, src.stem + ".o") for src in sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
              for src, obj in zip(sources(), objs)])
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
            os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.spf_rerank.argtypes = [
        p, p, p,             # queries (or centered queries), scales, vectors3d
        p, p, p,             # schedule: order, items, totals
        p,                   # out
        i, i, i,             # P = Q * nprobe, item slots, resident blocks
        i, i, i,             # nprobe, pad, d_pad
        i, i,                # metric, slab dtype (0 f32, 1 bf16, 2 int8)
        p,                   # stream
    ]
    lib.spf_rerank.restype = i
    lib.spf_rerank_geometry.argtypes = [i, i, ctypes.POINTER(i)]  # d_pad, slab dtype, out[7]
    lib.spf_rerank_geometry.restype = i
    # d_pad, slab dtype, metric, out: resident blocks
    lib.spf_rerank_prepare.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.spf_rerank_prepare.restype = i
    lib.spf_rerank_schedule.argtypes = [
        p, p, p, p,          # rows, order, items, totals
        p, p,                # workspace: hist, offs (Cpad + 1 each)
        i, i,                # P = Q * nprobe, Cpad
        p,                   # stream
    ]
    lib.spf_rerank_schedule.restype = i
    lib.spf_rerank_int8mxu.argtypes = [
        p, p, p,             # qcodes, qscale, qnorm2
        p, p, p,             # codesT3d, norms2, scales
        p, p, p,             # schedule: order, items, totals
        p,                   # out
        i, i, i,             # P = Q * nprobe, item slots, resident blocks
        i, i,                # d, pad
        p,                   # stream
    ]
    lib.spf_rerank_int8mxu.restype = i
    lib.spf_rerank_int8mxu_geometry.argtypes = [i, i, ctypes.POINTER(i)]  # d, pad, out[8]
    lib.spf_rerank_int8mxu_geometry.restype = i
    lib.spf_rerank_int8mxu_prepare.argtypes = [i, i, ctypes.POINTER(i)]  # d, pad, out: blocks
    lib.spf_rerank_int8mxu_prepare.restype = i
    lib.spf_window_scan.argtypes = [
        p, p, p,             # caug, qaug, out
        p,                   # scratch: spf_window_scan_scratch bytes
        i, i, i,             # Q, Cpad, d_pad
        i,                   # bf16 rank (else 3xTF32)
        p,                   # stream
    ]
    lib.spf_window_scan.restype = i
    lib.spf_window_scan_scratch.argtypes = [i, i, i, i]  # Q, Cpad, d_pad, bf16 rank
    lib.spf_window_scan_scratch.restype = ctypes.c_longlong
    lib.spf_replica_topk.argtypes = [
        p, p, p, p,          # X, base, cents, Cb = cents[base] (bf16; null for f32)
        p, i,                # db (n,), db given (0: scratch the kernel fills)
        p, p,                # scratch: x2 (n,), cn2 (C,)
        p, p,                # out idx (n, n_extra), out rank (n, n_extra)
        i, i, i, i,          # n, C, d, n_extra
        f, f,                # bt, soar_lambda
        i,                   # bf16 inputs
        p,                   # stream
    ]
    lib.spf_replica_topk.restype = i
    lib.spf_nearest_centroid.argtypes = [
        p, p,                # X, cents
        p, p,                # scratch: x2 (n,), cn2 (C,)
        p, p,                # out idx (n,), out dist (n,)
        i, i, i,             # n, C, d
        i,                   # bf16 inputs
        p,                   # stream
    ]
    lib.spf_nearest_centroid.restype = i
    lib.spf_l1_linf_pairwise.argtypes = [
        p, p, p,             # x, y, out
        i, i, i,             # n, m, d
        i, i,                # l1 (1 Manhattan, 0 Chebyshev), bf16 inputs
        p,                   # stream
    ]
    lib.spf_l1_linf_pairwise.restype = i
    lib.spf_topk_select.argtypes = [
        p, p, p,             # x (rows, n) f32, out values (rows, k) f32, out columns int64
        p, p,                # scratch (rows * tiles, k) f32 and int64, or null
        i, i, i,             # rows, n, k
        p,                   # stream
    ]
    lib.spf_topk_select.restype = i
    lib.spf_topk_select_tiles.argtypes = [i, i, i]  # rows, n, k: tiles a row (1: no scratch)
    lib.spf_topk_select_tiles.restype = i
    lib.spf_error_string.argtypes = [i]
    lib.spf_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = library().spf_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} ({msg})")
