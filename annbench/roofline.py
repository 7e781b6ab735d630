"""Published peaks of the card and the operations and bytes a kernel's work
needs, for roofline shares.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit; a run records the card's limit beside its shares.  A kernel's bound is
the larger of its bytes over the memory bandwidth and its operations over
the peak of their type; the bytes count each input read once and each output
written once, whatever the kernel reads again, and only the rows the work
needs (a posting's members, not its padding).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

HBM_BPS = 3.35e12
PEAK_OPS = {
    "f32": 67e12,     # CUDA cores
    "tf32": 495e12,   # tensor cores
    "bf16": 989e12,   # tensor cores
    "int8": 1979e12,  # tensor cores
}
STORAGE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
SCAN_WINDOW = 128   # centroids whose rank minimum the windowed stage 1 keeps as one


def bound_s(nbytes: float, ops: float, peak: str) -> float:
    """The least time the card could take, in seconds."""
    return max(nbytes / HBM_BPS, ops / PEAK_OPS[peak])


def probed_postings(queries: np.ndarray, centroids: np.ndarray, nprobe: int,
                    round_to: Optional[torch.dtype], device) -> np.ndarray:
    """The benchmark's own plain top-nprobe: each query's nprobe nearest
    centroids under squared L2, queries and centroids rounded to the dtype
    stage 1 ranks in (None: the f32 values as given), in f64.  (Q, nprobe)
    posting indices."""
    q = torch.from_numpy(queries).to(device)
    c = torch.from_numpy(centroids).to(device)
    if round_to is not None:
        q, c = q.to(round_to), c.to(round_to)
    q, c = q.to(torch.float64), c.to(torch.float64)
    out = []
    for s in range(0, q.shape[0], 1024):
        qb = q[s:s + 1024]
        d = (qb * qb).sum(1, keepdim=True) + (c * c).sum(1)[None, :] - 2.0 * qb @ c.T
        out.append(torch.topk(d, nprobe, dim=1, largest=False).indices.cpu())
    return torch.cat(out).numpy()


def rerank_work(probes: np.ndarray, lens: np.ndarray, dim: int, storage: str) -> dict:
    """Bytes and operations of the slab rerank of one query batch whose
    probes are ``probes`` (Q, nprobe) into postings of ``lens`` members:
    each probed posting's members read once at ``dim`` x the storage width,
    each query read once in f32, each (query, member) distance written once
    in f32; 3 operations (a difference, a multiply, an add) a coordinate of
    each (query, member) pair.  Residual int8 codes also need each probed
    posting's centroid (f32) and scale (f32) read once, and a dequantizing
    multiply: 4 operations a coordinate of a pair."""
    Q = probes.shape[0]
    pairs = float(lens[probes].sum())
    probed = np.unique(probes)
    members = float(lens[probed].sum())
    nbytes = members * dim * STORAGE_BYTES[storage] + Q * dim * 4 + pairs * 4
    per_coord = 3.0
    if storage == "int8":
        nbytes += len(probed) * (dim * 4 + 4)
        per_coord = 4.0
    return {"bytes": nbytes, "ops": per_coord * dim * pairs}


def centroid_scan_work(queries: int, centroids: int, dim: int) -> dict:
    """Bytes and operations of the windowed stage 1's scan for ``queries``
    queries over ``centroids`` centroids (the real ones, not the padding),
    against the TF32 peak: 2 x queries x centroids x dim operations (a
    multiply and an add a coordinate of each pair) three times over.  The
    rank has to be f32-grade (it orders the probes of f32 centroids), and
    the card's fastest route to f32-grade products is three TF32 passes on
    the tensor cores (hi.hi + hi.lo + lo.hi); counting that work at the TF32
    peak makes the bound the least time an f32-grade rank can take, the
    same whatever implements it.  Bytes: each query and each centroid read
    once in f32, each window minimum (one a ``SCAN_WINDOW`` centroids)
    written once in f32."""
    windows = -(-centroids // SCAN_WINDOW)
    nbytes = 4.0 * (queries * dim + centroids * dim + queries * windows)
    return {"bytes": nbytes, "ops": 3.0 * 2.0 * queries * centroids * dim}
