"""Slab rerank (counterpart of ``spfresh_tpu/ops/pallas/rerank.py``:
``padded_rerank_distances``, its float path and its quantized IVF-SQ8
path, and ``padded_rerank_distances_int8mxu``, the expansion-form IVF-SQ8
scorer over transposed int8 codes).

Each wrapper launches its CUDA kernel (``csrc/rerank.cu``,
``csrc/rerank_int8mxu.cu``) for CUDA tensors and runs its ``*_plain``
version for CPU tensors; anything else raises.  Nothing on a CUDA path
calls a plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops.distances import CHEBYSHEV, EUCLIDEAN, MANHATTAN, canonical_metric

_METRIC_CODE = {EUCLIDEAN: 0, MANHATTAN: 1, CHEBYSHEV: 2}
_SLAB_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PLAIN_CHUNK_BYTES = 1 << 28  # bound on the plain version's (q, nprobe, pad, d_pad) gather

# Kernel launches since the last reset (set to 0 to reset): the float path
# (f32/bf16 slabs), the quantized path (int8 slabs) and the expansion-form
# scorer count apart.
launches = 0
quantized_launches = 0
int8mxu_launches = 0


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


def rerank_schedule(rows: torch.Tensor, cpad: int, group: int):
    """The slab-major schedule of the rerank kernel over the P = Q * nprobe
    (query, probe) pairs of ``rows`` (Q, nprobe) int32: a counting sort by
    slab, each slab's pairs cut into work items of at most ``group``.

    Returns ``(order, items, totals)``, int32 on ``rows``' device: ``order``
    (P,) the flat pairs ``q * nprobe + j`` grouped by slab in slab order,
    the pairs of an out-of-range slab index last; ``items`` (n_slots, 4)
    ``{slab, first position in order, count, 0}`` of each work item in slab
    order, then unused slots (n_slots bounds the item count);
    ``totals`` = (items, in-range pairs, 0), the last the counter off which
    the kernel's blocks take their items, so a schedule serves one launch.
    A CUDA tensor launches the counting sort of ``csrc/rerank.cu``
    (``group`` must be the kernel's), where a slab's pairs come in any
    order; on the CPU they stay in pair order."""
    flat = rows.reshape(-1)
    P = flat.numel()
    dev = rows.device
    n_slots = min(P, -(-P // group) + min(P, cpad))  # bounds the item count
    if dev.type == "cuda":
        if rows.dtype != torch.int32 or not rows.is_contiguous():
            raise ValueError("rows must be contiguous int32")
        if group != kernel_geometry(16, torch.int8)["group"]:
            raise ValueError(f"group={group} is not the kernel's work-item size")
        # One workspace: items (16-byte aligned at its start), totals (and a
        # word of padding), order, and the counting sort's hist and offs.
        ws = torch.empty(4 * n_slots + 4 + P + 2 * (cpad + 1), dtype=torch.int32, device=dev)
        items = ws[: 4 * n_slots].view(n_slots, 4)
        totals = ws[4 * n_slots : 4 * n_slots + 3]
        order = ws[4 * n_slots + 4 : 4 * n_slots + 4 + P]
        hist = ws[4 * n_slots + 4 + P : 4 * n_slots + 5 + P + cpad]
        offs = ws[4 * n_slots + 5 + P + cpad :]
        with torch.cuda.device(dev):  # the sort launches on the current device
            rc = _build.library().spf_rerank_schedule(
                flat.data_ptr(), order.data_ptr(), items.data_ptr(), totals.data_ptr(),
                hist.data_ptr(), offs.data_ptr(), P, cpad,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "rerank schedule")
        return order, items, totals
    key = torch.where((flat < 0) | (flat >= cpad), cpad, flat).long()
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    hist = torch.bincount(key, minlength=cpad + 1)[:cpad]
    per = (hist + group - 1) // group  # items per slab
    slab = torch.repeat_interleave(torch.arange(cpad, device=dev), per)
    k = torch.arange(slab.numel(), device=dev) - (torch.cumsum(per, 0) - per)[slab]
    items = torch.zeros((n_slots, 4), dtype=torch.int32, device=dev)
    items[: slab.numel(), 0] = slab.to(torch.int32)
    items[: slab.numel(), 1] = ((torch.cumsum(hist, 0) - hist)[slab] + k * group).to(torch.int32)
    items[: slab.numel(), 2] = torch.clamp(hist[slab] - k * group, max=group).to(torch.int32)
    totals = torch.tensor([slab.numel(), int(hist.sum()), 0], dtype=torch.int32, device=dev)
    return order, items, totals


@functools.lru_cache(maxsize=None)
def kernel_geometry(d_pad: int, slab_dtype: torch.dtype) -> dict:
    """The kernel's work-item size and tile geometry for (d_pad, slab dtype),
    as the built library computes them: rows wider than fit shared memory
    are taken in ``slices`` column slices of ``width`` elements."""
    out = (ctypes.c_int * 7)()
    rc = _build.library().spf_rerank_geometry(d_pad, _SLAB_CODE[slab_dtype], out)
    geo = dict(zip(("group", "lanes", "rows", "stages", "smem", "width", "slices"), out))
    if rc != 0:
        raise ValueError(f"d_pad={d_pad} {slab_dtype}: the slab ring and the query rows need "
                         f"{geo['smem']} bytes of shared memory, more than a block has")
    return geo


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: int, d_pad: int, slab_code: int, metric_code: int) -> int:
    """Readies the kernel on ``device`` (its shared-memory size) and returns
    how many of its persistent blocks the card holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.library().spf_rerank_prepare(d_pad, slab_code, metric_code,
                                                 ctypes.byref(out))
    _build.check(rc, "rerank prepare")
    return out.value


def padded_rerank_distances(queries: torch.Tensor, rows: torch.Tensor,
                            vectors3d: torch.Tensor, metric: str = EUCLIDEAN,
                            scales: torch.Tensor | None = None,
                            centered_queries: torch.Tensor | None = None) -> torch.Tensor:
    """Distances (Q, nprobe, pad) f32 between each query (Q, d_pad) f32 and
    every row of each probed slab ``vectors3d[rows[q, j]]``.  Rows beyond
    the true nprobe must still be valid slab indices; callers mask them.
    An out-of-range slab index gives a NaN row on the card.

    int8 slabs hold residual codes and take ``scales`` (Q, nprobe) f32, the
    scale of each probed slab, and ``centered_queries`` (Q, nprobe, d_pad)
    f32, ``q - c_j`` for each probe; the distance is then that of
    ``scales * code - centered_queries``.  Both are given or neither is.

    On the card the pairs are first grouped by slab (``rerank_schedule``),
    so the kernel reads each probed slab once per group."""
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
    if Q * nprobe >= 2**31:
        raise ValueError(f"Q*nprobe={Q * nprobe} exceeds the kernel's int32 pair index")
    geo = kernel_geometry(d_pad, vectors3d.dtype)
    named = [("queries", queries), ("rows", rows), ("vectors3d", vectors3d)]
    if quantized:
        named += [("scales", scales), ("centered_queries", centered_queries)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("vectors3d", vectors3d),
                    ("centered_queries" if quantized else "queries",
                     centered_queries if quantized else queries)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((Q, nprobe, pad), dtype=torch.float32, device=rows.device)
    if Q * nprobe == 0 or pad == 0:
        return out
    # The library launches on the current device: make it the tensors' one.
    with torch.cuda.device(rows.device):
        blocks = _resident_blocks(torch.cuda.current_device(), d_pad,
                                  _SLAB_CODE[vectors3d.dtype], _METRIC_CODE[metric])
        order, items, totals = rerank_schedule(rows, C, geo["group"])
        rc = _build.library().spf_rerank(
            (centered_queries if quantized else queries).data_ptr(),
            scales.data_ptr() if quantized else None, vectors3d.data_ptr(), order.data_ptr(),
            items.data_ptr(), totals.data_ptr(), out.data_ptr(),
            Q * nprobe, items.shape[0], blocks, nprobe, pad, d_pad, _METRIC_CODE[metric],
            _SLAB_CODE[vectors3d.dtype], torch.cuda.current_stream(rows.device).cuda_stream,
        )
    _build.check(rc, "rerank")
    if quantized:
        quantized_launches += 1
    else:
        launches += 1
    return out


# ---------------------------------------------------------------------------
# Expansion-form IVF-SQ8 rerank ("int8-MXU" in the JAX package)
# ---------------------------------------------------------------------------
#
# With r the residual codes of a slab row (scale s_j) and qcq the int8 codes
# of the centered query qc = q - c_row (scale s_q):
#   |s_j r - qc|^2 ~= |qc|^2 - 2 s_j s_q (r . qcq) + s_j^2 |r|^2,
# the double-quantized score.  The dot is an exact integer; |r|^2 is a
# per-row int32 table built once from the codes.


def quantize_centered_queries(queries: torch.Tensor, centroids: torch.Tensor,
                              rows: torch.Tensor):
    """(qcodes (Q, nprobe, d) int8, qscale (Q, nprobe) f32, qnorm2 (Q,
    nprobe) f32): per-(query, probe) symmetric int8 codes of
    ``qc = q - centroids[rows]``, with the JAX package's f32 expressions
    (``qscale = max|qc| / 127``, codes ``clip(round(qc / max(qscale,
    1e-30)), -127, 127)`` rounding half to even) and the exact f32
    ``qnorm2 = sum(qc * qc)``."""
    qc = queries.to(torch.float32)[:, None, :] - centroids[rows.long()].to(torch.float32)
    qscale = torch.amax(qc.abs(), dim=-1) / 127.0
    safe = torch.clamp_min(qscale, 1e-30)
    qcodes = torch.round(qc / safe[..., None]).clamp_(-127, 127).to(torch.int8)
    qnorm2 = torch.sum(qc * qc, dim=-1)
    return qcodes, qscale, qnorm2


def padded_rerank_distances_int8mxu_plain(qcodes, qscale, qnorm2, rows, codesT3d, norms2,
                                          scales) -> torch.Tensor:
    """Plain PyTorch version: the math of the JAX package's
    ``int8mxu_rerank_oracle``.  The dot is an f32 contraction over int8
    values, exact because every partial sum is an integer below 2^24 (d up
    to 1,040).  Query chunks bound the (q, nprobe, d, pad) gather to
    ~``PLAIN_CHUNK_BYTES``."""
    Q, nprobe = rows.shape
    _, d, pad = codesT3d.shape
    step = max(1, PLAIN_CHUNK_BYTES // max(1, nprobe * d * pad * 4))
    out = torch.empty((Q, nprobe, pad), dtype=torch.float32, device=rows.device)
    for s in range(0, Q, step):
        r = rows[s : s + step].long()
        dot = torch.einsum("qjdp,qjd->qjp", codesT3d[r].to(torch.float32),
                           qcodes[s : s + step].to(torch.float32))
        sj = scales[r].to(torch.float32)
        n2 = norms2[r].to(torch.float32)
        out[s : s + step] = (qnorm2[s : s + step, :, None]
                             - (2.0 * sj * qscale[s : s + step])[..., None] * dot
                             + (sj * sj)[..., None] * n2)
    return out


def _check_int8mxu(qcodes, qscale, qnorm2, rows, codesT3d, norms2, scales) -> None:
    if qcodes.ndim != 3 or rows.ndim != 2 or codesT3d.ndim != 3:
        raise ValueError(
            f"expected qcodes (Q, nprobe, d), rows (Q, nprobe), codesT3d (C, d, pad); got "
            f"{tuple(qcodes.shape)}, {tuple(rows.shape)}, {tuple(codesT3d.shape)}")
    C, d, pad = codesT3d.shape
    if tuple(qcodes.shape) != (*rows.shape, d):
        raise ValueError(f"qcodes {tuple(qcodes.shape)} must be (Q, nprobe, d) = "
                         f"{(*rows.shape, d)}")
    for name, t in (("qscale", qscale), ("qnorm2", qnorm2)):
        if tuple(t.shape) != tuple(rows.shape):
            raise ValueError(f"{name} {tuple(t.shape)} must match rows {tuple(rows.shape)}")
    if tuple(norms2.shape) != (C, pad):
        raise ValueError(f"norms2 {tuple(norms2.shape)} must be (C, pad) = {(C, pad)}")
    if tuple(scales.shape) != (C,):
        raise ValueError(f"scales {tuple(scales.shape)} must be (C,) = {(C,)}")
    for name, t, dt in (("qcodes", qcodes, torch.int8), ("qscale", qscale, torch.float32),
                        ("qnorm2", qnorm2, torch.float32), ("rows", rows, torch.int32),
                        ("codesT3d", codesT3d, torch.int8), ("norms2", norms2, torch.int32),
                        ("scales", scales, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != rows.device:
            raise ValueError("all int8mxu rerank inputs must be on one device")


@functools.lru_cache(maxsize=None)
def int8mxu_geometry(d: int, pad: int) -> dict:
    """The expansion scorer's work-item size and stage geometry for slabs of
    (d, pad), as the built library computes them: pad taken in ``passes``
    column passes of ``width``, ``kc`` k-rows a stage, ``nk`` stages a
    pass of an item, a ring of ``stages``, ``consumers`` warps."""
    out = (ctypes.c_int * 8)()
    rc = _build.library().spf_rerank_int8mxu_geometry(d, pad, out)
    if rc != 0:
        raise ValueError(f"d={d} pad={pad}: no int8mxu geometry (both must be multiples of 4)")
    return dict(zip(("group", "width", "passes", "kc", "nk", "stages", "smem", "consumers"),
                    out))


@functools.lru_cache(maxsize=None)
def _int8mxu_blocks(device: int, d: int, pad: int) -> int:
    """Readies the expansion scorer on ``device`` (its shared-memory size)
    and returns how many of its persistent blocks the card holds at once
    at (d, pad)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.library().spf_rerank_int8mxu_prepare(d, pad, ctypes.byref(out))
    _build.check(rc, "int8mxu rerank prepare")
    return out.value


def padded_rerank_distances_int8mxu(qcodes: torch.Tensor, qscale: torch.Tensor,
                                    qnorm2: torch.Tensor, rows: torch.Tensor,
                                    codesT3d: torch.Tensor, norms2: torch.Tensor,
                                    scales: torch.Tensor, native_int8: bool = False
                                    ) -> torch.Tensor:
    """Euclidean IVF-SQ8 rerank in expansion form: (Q, nprobe, pad) f32
    double-quantized squared distances between the quantized centered
    queries (``quantize_centered_queries``) and every row of each probed
    slab of ``codesT3d`` (C, d, pad) int8, the residual codes TRANSPOSED
    so pad is the contiguous axis, with ``norms2`` (C, pad) int32 the
    per-row |r|^2 and ``scales`` (C,) f32 the slab scales.  An
    out-of-range slab index gives a NaN row on the card.

    On the card the pairs are first grouped by slab (``rerank_schedule``,
    the rerank's work items), so the kernel reads each probed slab once per
    group.  ``native_int8`` names the JAX kernel's two forms (an int8 x
    int8 or an f32-accumulated dot); both dots are exact, so the result is
    the same and the flag changes nothing here."""
    global int8mxu_launches
    _check_int8mxu(qcodes, qscale, qnorm2, rows, codesT3d, norms2, scales)
    if not isinstance(native_int8, bool):
        raise TypeError("native_int8 must be a bool")
    if rows.device.type == "cpu":
        return padded_rerank_distances_int8mxu_plain(qcodes, qscale, qnorm2, rows, codesT3d,
                                                     norms2, scales)
    if rows.device.type != "cuda":
        raise ValueError(f"no int8mxu rerank for device {rows.device}")
    Q, nprobe = rows.shape
    C, d, pad = codesT3d.shape
    if d % 4 or pad % 4:
        raise ValueError(f"d={d} and pad={pad} must be multiples of 4 for 4-byte loads")
    if Q * nprobe >= 2**31:
        raise ValueError(f"Q*nprobe={Q * nprobe} exceeds the kernel's int32 pair index")
    named = (("qcodes", qcodes), ("qscale", qscale), ("qnorm2", qnorm2), ("rows", rows),
             ("codesT3d", codesT3d), ("norms2", norms2), ("scales", scales))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # The slab codes and |r|^2 rows arrive by bulk copy (16-byte aligned);
        # the query codes by 4-byte copies.
        align = 16 if name in ("codesT3d", "norms2") else 4
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    out = torch.empty((Q, nprobe, pad), dtype=torch.float32, device=rows.device)
    if Q * nprobe == 0 or pad == 0:
        return out
    geo = int8mxu_geometry(d, pad)
    # The library launches on the current device: make it the tensors' one.
    with torch.cuda.device(rows.device):
        blocks = _int8mxu_blocks(torch.cuda.current_device(), d, pad)
        order, items, totals = rerank_schedule(rows, C, geo["group"])
        rc = _build.library().spf_rerank_int8mxu(
            qcodes.data_ptr(), qscale.data_ptr(), qnorm2.data_ptr(), codesT3d.data_ptr(),
            norms2.data_ptr(), scales.data_ptr(), order.data_ptr(), items.data_ptr(),
            totals.data_ptr(), out.data_ptr(), Q * nprobe, items.shape[0], blocks, d, pad,
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    _build.check(rc, "int8mxu rerank")
    int8mxu_launches += 1
    return out
