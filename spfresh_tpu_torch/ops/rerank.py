"""Slab rerank (counterpart of ``spfresh_tpu/ops/pallas/rerank.py``,
``padded_rerank_distances``: its float path and its quantized IVF-SQ8 path).

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
_SLAB_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PLAIN_CHUNK_BYTES = 1 << 28  # bound on the plain version's (q, nprobe, pad, d_pad) gather

# Kernel launches since the last reset (set to 0 to reset): the float path
# (f32/bf16 slabs) and the quantized path (int8 slabs) count apart.
launches = 0
quantized_launches = 0


def padded_rerank_distances_plain(queries, rows, vectors3d, metric: str = EUCLIDEAN,
                                  scales=None, centered_queries=None) -> torch.Tensor:
    """Plain PyTorch version: gather the probed slabs and reduce the
    elementwise difference in f32 — the math of the reference's
    ``rerank._emulate``.  Quantized (int8 residual codes): the difference is
    ``v * scales[q, j] - centered_queries[q, j]``, the multiply rounded on
    its own as in the reference kernel.  Query chunks bound the
    (q, nprobe, pad, d) gather to ~``PLAIN_CHUNK_BYTES``."""
    metric = canonical_metric(metric)
    Q, nprobe = rows.shape
    _, pad, d_pad = vectors3d.shape
    per_query = max(1, nprobe * pad * d_pad * 4)
    step = max(1, PLAIN_CHUNK_BYTES // per_query)
    out = torch.empty((Q, nprobe, pad), dtype=torch.float32, device=rows.device)
    for s in range(0, Q, step):
        v = vectors3d[rows[s : s + step].long()].to(torch.float32)  # (q, nprobe, pad, d_pad)
        if scales is None:
            diff = v - queries[s : s + step].to(torch.float32)[:, None, None, :]
        else:
            diff = (v * scales[s : s + step][:, :, None, None]
                    - centered_queries[s : s + step][:, :, None, :])
        if metric == EUCLIDEAN:
            out[s : s + step] = torch.sum(diff * diff, dim=-1)
        elif metric == MANHATTAN:
            out[s : s + step] = torch.sum(torch.abs(diff), dim=-1)
        else:
            out[s : s + step] = torch.amax(torch.abs(diff), dim=-1)
    return out


def _check(queries, rows, vectors3d, scales, centered_queries) -> None:
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
    if (scales is None) != (centered_queries is None):
        raise ValueError("scales and centered_queries are given together or not at all")
    quantized = scales is not None
    if vectors3d.dtype not in _SLAB_CODE:
        raise TypeError(f"slabs must be float32, bfloat16 or int8, got {vectors3d.dtype}")
    if (vectors3d.dtype == torch.int8) != quantized:
        raise TypeError("int8 slabs take the quantized path (scales=, centered_queries=) "
                        f"and float slabs do not; got {vectors3d.dtype} slabs with "
                        f"scales={'given' if quantized else None}")
    tensors = [queries, rows, vectors3d]
    if quantized:
        if tuple(scales.shape) != tuple(rows.shape):
            raise ValueError(f"scales {tuple(scales.shape)} must match rows {tuple(rows.shape)}")
        if tuple(centered_queries.shape) != (*rows.shape, vectors3d.shape[2]):
            raise ValueError(f"centered_queries {tuple(centered_queries.shape)} must be "
                             f"(Q, nprobe, d_pad) = {(*rows.shape, vectors3d.shape[2])}")
        if scales.dtype != torch.float32 or centered_queries.dtype != torch.float32:
            raise TypeError("scales and centered_queries must be float32")
        tensors += [scales, centered_queries]
    if any(t.device != rows.device for t in tensors):
        raise ValueError("queries, rows, vectors3d (and scales, centered_queries) "
                         "must be on one device")


def padded_rerank_distances(queries: torch.Tensor, rows: torch.Tensor,
                            vectors3d: torch.Tensor, metric: str = EUCLIDEAN,
                            scales: torch.Tensor | None = None,
                            centered_queries: torch.Tensor | None = None) -> torch.Tensor:
    """Distances (Q, nprobe, pad) f32 between each query (Q, d_pad) f32 and
    every row of each probed slab ``vectors3d[rows[q, j]]``.  Rows beyond
    the true nprobe must still be valid slab indices; callers mask them.

    int8 slabs hold residual codes and take ``scales`` (Q, nprobe) f32, the
    scale of each probed slab, and ``centered_queries`` (Q, nprobe, d_pad)
    f32, ``q - c_j`` for each probe; the distance is then that of
    ``scales * code - centered_queries``.  Both are given or neither is."""
    global launches, quantized_launches
    metric = canonical_metric(metric)
    _check(queries, rows, vectors3d, scales, centered_queries)
    quantized = scales is not None
    if rows.device.type == "cpu":
        return padded_rerank_distances_plain(queries, rows, vectors3d, metric, scales,
                                             centered_queries)
    if rows.device.type != "cuda":
        raise ValueError(f"no rerank for device {rows.device}")
    Q, nprobe = rows.shape
    C, pad, d_pad = vectors3d.shape
    vals_per_16b = 16 // vectors3d.element_size()
    if d_pad % vals_per_16b:
        raise ValueError(f"d_pad={d_pad} must be a multiple of {vals_per_16b} for 16-byte loads")
    if d_pad * 4 > 48 * 1024:
        raise ValueError(f"d_pad={d_pad}: the query row must fit 48 KB of shared memory")
    if Q * nprobe >= 2**31:
        raise ValueError(f"Q*nprobe={Q * nprobe} exceeds the kernel's grid")
    named = [("queries", queries), ("rows", rows), ("vectors3d", vectors3d)]
    if quantized:
        named += [("scales", scales), ("centered_queries", centered_queries)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vectors3d.data_ptr() % 16:
        raise ValueError("vectors3d must be 16-byte aligned")
    out = torch.empty((Q, nprobe, pad), dtype=torch.float32, device=rows.device)
    lib = _build.library()
    rc = lib.spf_rerank(
        (centered_queries if quantized else queries).data_ptr(), rows.data_ptr(),
        scales.data_ptr() if quantized else None, vectors3d.data_ptr(), out.data_ptr(),
        Q, nprobe, C, pad, d_pad, _METRIC_CODE[metric], _SLAB_CODE[vectors3d.dtype],
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _build.check(rc, "rerank")
    if quantized:
        quantized_launches += 1
    else:
        launches += 1
    return out
