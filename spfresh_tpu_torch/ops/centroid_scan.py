"""Windowed centroid scan for large centroid counts (counterpart of
``spfresh_tpu/ops/pallas/centroid_scan.py``).

Stage 1 past ``LARGE_C_THRESHOLD`` centroids (``ops.topk.centroid_topk``)
finds each query's nprobe nearest centroids without a (Q, C) top-k:

pass 1 (``centroid_window_scan``): rank(q, c) = |c|^2 - 2 q.c reduced to
  its minimum over each 128-centroid window; only the (Q, Cpad/128) minima
  are kept.  CUDA tensors launch ``csrc/centroid_scan.cu`` (tensor-core
  products: one bf16 pass, or 3xTF32 for the f32 rank, whose operand split
  is ``tf32_split`` and whose arithmetic ``centroid_window_scan_tf32x3``
  repeats); CPU tensors run ``centroid_window_scan_plain``.
pass 2: the nprobe + ``MARGIN`` best windows per query are reranked exactly
  by the slab rerank (``ops.rerank``) with the augmented centroid matrix
  viewed as (W, 128, d_pad) window slabs.

Exactness is the reference's argument: the nprobe windows with the
smallest minima hold nprobe distinct ranks at most the nprobe-th minimum,
so every true top-nprobe centroid lies in them; the margin absorbs
near-tie swaps of the bf16 rank mode.  Ranking precision follows the
centroid dtype: bf16 centroids rank with bf16-rounded dot operands, f32
centroids with f32 products.
"""

from __future__ import annotations

import torch

from spfresh_tpu_torch.ops import _build

CT = 1024   # Cpad is a multiple of this, as in the reference (W a multiple of 8)
L = 128     # centroids per window
MARGIN = 8  # extra windows selected to absorb bf16 near-tie swaps
SUPERCHUNK = 262144  # centroid rows per pass-1/pass-2 round; rounds merge exactly
PLAIN_CHUNK_BYTES = 1 << 28  # bound on the plain version's (q, Cpad) rank block

# Kernel launches since the last reset (set to 0 to reset).
launches = 0


def centroid_window_scan_plain(caug: torch.Tensor, qaug: torch.Tensor,
                               bf16_rank: bool) -> torch.Tensor:
    """Plain PyTorch version of pass 1: one product over the same operands,
    then a reshape-min.  bf16 mode rounds both operands to bf16 and
    multiplies them in f32 (exact products, f32 sums); |c|^2 comes from the
    unrounded rows.  Query chunks bound the (q, Cpad) rank block."""
    Cpad, _ = caug.shape
    Q = qaug.shape[0]
    W = Cpad // L
    cn2 = torch.sum(caug * caug, dim=1)
    a, b = caug, qaug
    if bf16_rank:
        a, b = bf16_operand(a), bf16_operand(b)
    out = torch.empty((Q, W), dtype=torch.float32, device=caug.device)
    step = max(1, PLAIN_CHUNK_BYTES // max(1, Cpad * 4))
    for s in range(0, Q, step):
        rank = cn2[None, :] + b[s : s + step] @ a.T
        out[s : s + step] = rank.reshape(-1, W, L).amin(dim=-1)
    return out


def bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest-even bf16, back in f32: the bf16 rank's dot
    operands (the kernel's first pass writes them as bf16)."""
    return x.to(torch.bfloat16).to(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) f32 tensors with hi = x rounded to TF32 (10 explicit
    mantissa bits, nearest, ties away from zero: ``cvt.rna.tf32.f32``) and
    lo = x - hi rounded the same way; hi + lo is within 2^-22 |x| of x.  The
    operands of the kernel's f32 rank."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def centroid_window_scan_tf32x3(caug: torch.Tensor, qaug: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's f32-rank arithmetic in plain PyTorch: both operands
    split by ``tf32_split``, the rank ``|c|^2 + (qlo.chi + qhi.clo +
    qhi.chi)`` with exact products and f32 sums (the lo.lo term dropped),
    then the window minimum.  The kernel is held to
    ``centroid_window_scan_plain``; this shows the split keeps f32 grade."""
    Cpad, _ = caug.shape
    Q = qaug.shape[0]
    W = Cpad // L
    cn2 = torch.sum(caug * caug, dim=1)
    chi, clo = tf32_split(caug)
    qhi, qlo = tf32_split(qaug)
    out = torch.empty((Q, W), dtype=torch.float32, device=caug.device)
    step = max(1, PLAIN_CHUNK_BYTES // max(1, Cpad * 4))
    for s in range(0, Q, step):
        hi, lo = qhi[s : s + step], qlo[s : s + step]
        rank = cn2[None, :] + ((lo @ chi.T + hi @ clo.T) + hi @ chi.T)
        out[s : s + step] = rank.reshape(-1, W, L).amin(dim=-1)
    return out


def centroid_window_scan(caug: torch.Tensor, qaug: torch.Tensor,
                         bf16_rank: bool) -> torch.Tensor:
    """Per-window rank minima (Q, Cpad/128) f32 of ``caug`` (Cpad, d_pad)
    f32, Cpad a multiple of ``CT`` and d_pad of ``L``, against ``qaug``
    (Q, d_pad) f32 holding ``-2 q``: entry (q, w) is the min over c in
    window w of ``|c|^2 + c . qaug[q]``."""
    global launches
    if caug.ndim != 2 or qaug.ndim != 2 or caug.shape[1] != qaug.shape[1]:
        raise ValueError(f"expected caug (Cpad, d_pad) and qaug (Q, d_pad); got "
                         f"{tuple(caug.shape)}, {tuple(qaug.shape)}")
    if caug.dtype != torch.float32 or qaug.dtype != torch.float32:
        raise TypeError(f"caug and qaug must be float32, got {caug.dtype}, {qaug.dtype}")
    Cpad, d_pad = caug.shape
    if Cpad % CT:
        raise ValueError(f"Cpad={Cpad} must be a multiple of {CT}")
    if d_pad == 0 or d_pad % L:
        raise ValueError(f"d_pad={d_pad} must be a positive multiple of {L}")
    if caug.device != qaug.device:
        raise ValueError("caug and qaug must be on one device")
    if caug.device.type == "cpu":
        return centroid_window_scan_plain(caug, qaug, bf16_rank)
    if caug.device.type != "cuda":
        raise ValueError(f"no centroid window scan for device {caug.device}")
    Q = qaug.shape[0]
    for name, t in (("caug", caug), ("qaug", qaug)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.library()
    bf16 = int(bool(bf16_rank))
    out = torch.empty((Q, Cpad // L), dtype=torch.float32, device=caug.device)
    scratch = torch.empty(lib.spf_window_scan_scratch(Q, Cpad, d_pad, bf16), dtype=torch.uint8,
                          device=caug.device)
    with torch.cuda.device(caug.device):  # the library launches on the current device
        rc = lib.spf_window_scan(
            caug.data_ptr(), qaug.data_ptr(), out.data_ptr(), scratch.data_ptr(), Q, Cpad, d_pad,
            bf16, torch.cuda.current_stream(caug.device).cuda_stream,
        )
    _build.check(rc, "centroid window scan")
    launches += 1
    return out


def _augment(qf, centroids, cent_valid, d_pad: int):
    """Padded operands (caug (Cpad, d_pad), qaug (Q, d_pad), Cpad).  Invalid
    and C-padding rows are 1e18 in every column; d-padding columns of valid
    rows stay 0 and meet a 0 in ``qaug``.  Their |c|^2 ~ 1e38 dominates
    every real rank, and pass 2 masks them too.  Unlike the reference, Q is
    not padded to a multiple of 256: the kernel masks its ragged edge."""
    C, d = centroids.shape
    Q = qf.shape[0]
    dev = centroids.device
    Cpad = ((C + CT - 1) // CT) * CT
    cf = torch.zeros((C, d_pad), dtype=torch.float32, device=dev)
    cf[:, :d] = centroids.to(torch.float32)
    caug = torch.full((Cpad, d_pad), 1e18, dtype=torch.float32, device=dev)
    caug[:C] = torch.where(cent_valid[:, None], cf, torch.full_like(cf, 1e18))
    qaug = torch.zeros((Q, d_pad), dtype=torch.float32, device=dev)
    qaug[:, :d] = -2.0 * qf.to(torch.float32)
    return caug, qaug, Cpad


def windowed_centroid_topk(qf: torch.Tensor, centroids: torch.Tensor,
                           cent_valid: torch.Tensor, nprobe: int):
    """Top-nprobe nearest centroids by squared L2 without sorting (Q, C):
    (distances (Q, nprobe) f32 ascending, centroid indices (Q, nprobe)
    int64), the contract of ``chunked_centroid_topk``.  Probes with no
    valid centroid come back as (+inf, 0): an in-range index that
    downstream masking ignores.

    C is processed in ``SUPERCHUNK``-row rounds whose exact top-nprobe
    results merge exactly.  Pass-2 candidate columns are laid out window by
    window in the order the windows were selected, so an exact tie resolves
    to the lower column, as in the reference."""
    from spfresh_tpu_torch.ops.rerank import padded_rerank_distances
    from spfresh_tpu_torch.ops.topk import smallest_k

    C, d = centroids.shape
    Q = qf.shape[0]
    dev = centroids.device
    bf16_rank = centroids.dtype == torch.bfloat16
    d_pad = ((d + L - 1) // L) * L
    qpad = torch.zeros((Q, d_pad), dtype=torch.float32, device=dev)
    qpad[:, :d] = qf.to(torch.float32)
    lane = torch.arange(L, device=dev)

    best_d = torch.full((Q, nprobe), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, nprobe), -1, dtype=torch.int64, device=dev)
    superchunk = max(CT, (SUPERCHUNK // CT) * CT)
    for start in range(0, C, superchunk):
        end = min(start + superchunk, C)
        caug, qaug, Cpad = _augment(qf, centroids[start:end], cent_valid[start:end], d_pad)
        winmin = centroid_window_scan(caug, qaug, bf16_rank)  # (Q, W)
        W = Cpad // L
        S = min(nprobe + MARGIN, W)
        _, wsel = smallest_k(winmin, S)  # (Q, S) window ids
        # Pass 2: exact distances inside the selected windows.  Invalid rows
        # are 1e18, so their distances are huge and the mask removes them.
        dw = padded_rerank_distances(qpad, wsel.to(torch.int32), caug.reshape(W, L, d_pad),
                                     "Euclidean")  # (Q, S, L)
        cols = wsel[:, :, None] * L + lane  # (Q, S, L)
        valid2d = torch.zeros(Cpad, dtype=torch.bool, device=dev)
        valid2d[: end - start] = cent_valid[start:end]
        dw = torch.where(valid2d.reshape(W, L)[wsel], dw, torch.full_like(dw, float("inf")))
        dw = dw.reshape(Q, S * L)
        cols = cols.reshape(Q, S * L)
        k_here = min(nprobe, S * L)
        loc_d, loc_j = smallest_k(dw, k_here)
        loc_i = torch.gather(cols, 1, loc_j) + start
        if k_here < nprobe:
            padk = nprobe - k_here
            loc_d = torch.cat([loc_d, torch.full((Q, padk), float("inf"), device=dev)], 1)
            loc_i = torch.cat([loc_i, torch.full((Q, padk), -1, dtype=torch.int64, device=dev)],
                              1)
        cat_d = torch.cat([best_d, loc_d], 1)
        cat_i = torch.cat([best_i, loc_i], 1)
        best_d, idx = smallest_k(cat_d, nprobe)
        best_i = torch.gather(cat_i, 1, idx)
    best_i = torch.where(torch.isfinite(best_d), best_i, torch.zeros_like(best_i))
    return best_d, best_i
