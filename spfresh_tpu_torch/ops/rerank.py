"""Slab rerank (counterpart of ``spfresh_tpu/ops/pallas/rerank.py``,
float path of ``padded_rerank_distances``).

``padded_rerank_distances`` launches the CUDA kernel in ``csrc/rerank.cu``
for CUDA tensors and runs ``padded_rerank_distances_plain`` for CPU
tensors; anything else raises.  Nothing on the CUDA search path calls the
plain version.
"""

from __future__ import annotations

import torch

from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops.distances import CHEBYSHEV, EUCLIDEAN, MANHATTAN, canonical_metric

_METRIC_CODE = {EUCLIDEAN: 0, MANHATTAN: 1, CHEBYSHEV: 2}
_SLAB_DTYPES = (torch.float32, torch.bfloat16)
PLAIN_CHUNK_BYTES = 1 << 28  # bound on the plain version's (q, nprobe, pad, d_pad) gather

# Kernel launches since the last reset (set to 0 to reset).
launches = 0


def padded_rerank_distances_plain(queries, rows, vectors3d,
                                  metric: str = EUCLIDEAN) -> torch.Tensor:
    """Plain PyTorch version: gather the probed slabs and reduce the
    elementwise difference in f32 — the math of the reference's
    ``rerank._emulate``.  Query chunks bound the (q, nprobe, pad, d) gather
    to ~``PLAIN_CHUNK_BYTES``."""
    metric = canonical_metric(metric)
    Q, nprobe = rows.shape
    _, pad, d_pad = vectors3d.shape
    per_query = max(1, nprobe * pad * d_pad * 4)
    step = max(1, PLAIN_CHUNK_BYTES // per_query)
    out = torch.empty((Q, nprobe, pad), dtype=torch.float32, device=queries.device)
    for s in range(0, Q, step):
        v = vectors3d[rows[s : s + step].long()].to(torch.float32)  # (q, nprobe, pad, d_pad)
        diff = v - queries[s : s + step].to(torch.float32)[:, None, None, :]
        if metric == EUCLIDEAN:
            out[s : s + step] = torch.sum(diff * diff, dim=-1)
        elif metric == MANHATTAN:
            out[s : s + step] = torch.sum(torch.abs(diff), dim=-1)
        else:
            out[s : s + step] = torch.amax(torch.abs(diff), dim=-1)
    return out


def _check(queries, rows, vectors3d) -> None:
    if queries.ndim != 2 or rows.ndim != 2 or vectors3d.ndim != 3:
        raise ValueError(
            f"expected queries (Q, d_pad), rows (Q, nprobe), vectors3d (C, pad, d_pad); got "
            f"{tuple(queries.shape)}, {tuple(rows.shape)}, {tuple(vectors3d.shape)}"
        )
    if queries.shape[0] != rows.shape[0]:
        raise ValueError(f"{queries.shape[0]} queries but {rows.shape[0]} row-table rows")
    if queries.shape[1] != vectors3d.shape[2]:
        raise ValueError(f"query width {queries.shape[1]} != slab width {vectors3d.shape[2]}")
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if vectors3d.dtype not in _SLAB_DTYPES:
        raise TypeError(f"slabs must be float32 or bfloat16, got {vectors3d.dtype}")
    if not (queries.device == rows.device == vectors3d.device):
        raise ValueError("queries, rows and vectors3d must be on one device")


def padded_rerank_distances(queries: torch.Tensor, rows: torch.Tensor,
                            vectors3d: torch.Tensor, metric: str = EUCLIDEAN) -> torch.Tensor:
    """Distances (Q, nprobe, pad) f32 between each query (Q, d_pad) f32 and
    every row of each probed slab ``vectors3d[rows[q, j]]``.  Rows beyond
    the true nprobe must still be valid slab indices; callers mask them."""
    global launches
    metric = canonical_metric(metric)
    _check(queries, rows, vectors3d)
    if queries.device.type == "cpu":
        return padded_rerank_distances_plain(queries, rows, vectors3d, metric)
    if queries.device.type != "cuda":
        raise ValueError(f"no rerank for device {queries.device}")
    Q, nprobe = rows.shape
    C, pad, d_pad = vectors3d.shape
    vals_per_16b = 16 // vectors3d.element_size()
    if d_pad % vals_per_16b:
        raise ValueError(f"d_pad={d_pad} must be a multiple of {vals_per_16b} for 16-byte loads")
    if d_pad * 4 > 48 * 1024:
        raise ValueError(f"d_pad={d_pad}: the query row must fit 48 KB of shared memory")
    if Q * nprobe >= 2**31:
        raise ValueError(f"Q*nprobe={Q * nprobe} exceeds the kernel's grid")
    for name, t in (("queries", queries), ("rows", rows), ("vectors3d", vectors3d)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vectors3d.data_ptr() % 16:
        raise ValueError("vectors3d must be 16-byte aligned")
    out = torch.empty((Q, nprobe, pad), dtype=torch.float32, device=queries.device)
    lib = _build.library()
    rc = lib.spf_rerank(
        queries.data_ptr(), rows.data_ptr(), vectors3d.data_ptr(), out.data_ptr(),
        Q, nprobe, C, pad, d_pad, _METRIC_CODE[metric],
        int(vectors3d.dtype == torch.bfloat16),
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    _build.check(rc, "rerank")
    launches += 1
    return out
