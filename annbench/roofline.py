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


def bound_s(nbytes: float, ops: float, peak: str) -> float:
    """The least time the card could take, in seconds."""
    return max(nbytes / HBM_BPS, ops / PEAK_OPS[peak])


def probed_postings(queries: np.ndarray, centroids: np.ndarray, nprobe: int,
                    round_to: torch.dtype, device) -> np.ndarray:
    """The benchmark's own plain top-nprobe: each query's nprobe nearest
    centroids under squared L2, queries and centroids rounded to the
    centroids' stored dtype, in f64.  (Q, nprobe) posting indices."""
    q = torch.from_numpy(queries).to(device).to(round_to).to(torch.float64)
    c = torch.from_numpy(centroids).to(device).to(round_to).to(torch.float64)
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
    each (query, member) pair."""
    Q = probes.shape[0]
    pairs = float(lens[probes].sum())
    members = float(lens[np.unique(probes)].sum())
    nbytes = members * dim * STORAGE_BYTES[storage] + Q * dim * 4 + pairs * 4
    return {"bytes": nbytes, "ops": 3.0 * dim * pairs}
