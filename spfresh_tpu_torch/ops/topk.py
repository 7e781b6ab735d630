"""Top-k selection (counterpart of ``spfresh_tpu/ops/topk.py``).

``lax.top_k`` breaks ties toward the lower index; ``torch.topk`` promises
no order among ties on CUDA.  ``smallest_k`` orders entries by the 32-bit
key of the f32 value (``+ 0.0`` folds -0.0 into +0.0; sign-magnitude bits
turned to two's-complement order) and equal keys by the lower column, on
every device.  CUDA tensors launch the row-select kernel in
``csrc/topk_select.cu``; CPU tensors run ``smallest_k_plain``, which
selects on the unique int64 key ``(key << 32) | column`` with
``torch.topk``.  Both give the same bits.
"""

from __future__ import annotations

import torch

from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops.distances import EUCLIDEAN, canonical_metric, pairwise_distance
from spfresh_tpu_torch.utils import metrics

# Centroid counts past this leave the dense (Q, C) scan + top-k for the
# windowed scan (Euclidean, nprobe <= 128) or the chunked scan; see
# centroid_topk.
LARGE_C_THRESHOLD = 32_768
# Centroid rows per step of ``chunked_centroid_topk``, as in the JAX package.
CENTROID_CHUNK = 8192

_LOW32 = 0xFFFFFFFF

# Kernel launches since the last reset (set to 0 to reset).
launches = 0


def _tie_stable_keys(dists: torch.Tensor) -> torch.Tensor:
    """Unique int64 keys ordering (value, column) lexicographically."""
    # +0.0 folds -0.0 into +0.0 so both zeros share one key.
    bits = (dists.to(torch.float32) + 0.0).view(torch.int32)
    # IEEE sign-magnitude -> two's-complement order for negative values.
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(dists.shape[-1], device=dists.device, dtype=torch.int64)
    return (bits.to(torch.int64) << 32) | col


def smallest_k_plain(dists: torch.Tensor, k: int):
    """Plain PyTorch version: ``torch.topk`` on the int64 keys of
    ``_tie_stable_keys``, the columns from their low bits."""
    keys = torch.topk(_tie_stable_keys(dists), k, dim=-1, largest=False, sorted=True).values
    idx = keys & _LOW32
    return torch.gather(dists, -1, idx), idx


def smallest_k(dists: torch.Tensor, k: int):
    """Per-row k smallest values of ``dists`` (..., n) -> (values, indices),
    ascending, ties to the lower index.  Values keep ``dists``' dtype and
    bits; indices are int64.  Counts the rows under ``topk.select.rows``."""
    global launches
    n = dists.shape[-1]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} columns")
    rows = dists.numel() // n if n else 0
    if dists.device.type == "cpu":
        metrics.inc("topk.select.rows", rows)
        return smallest_k_plain(dists, k)
    if k < 1:
        raise ValueError(f"the top-k select kernel takes 1 <= k <= n; got k={k}")
    if not dists.is_floating_point():
        raise TypeError(f"the top-k select kernel takes floating rows; got {dists.dtype}")
    if n >= 2**31 or rows >= 2**31:
        raise ValueError(f"{rows} rows of {n} columns exceed the top-k select kernel's range")
    if dists.device.type != "cuda":
        raise ValueError(f"no top-k select kernel for device {dists.device}")
    x = dists.to(torch.float32).contiguous()
    vals = torch.empty((*dists.shape[:-1], k), dtype=torch.float32, device=x.device)
    idx = torch.empty((*dists.shape[:-1], k), dtype=torch.int64, device=x.device)
    if rows:
        lib = _build.library()
        # Long rows of few selections run as tiles merged in a second launch.
        tiles = lib.spf_topk_select_tiles(rows, n, k)
        tile_vals = tile_idx = None
        if tiles > 1:
            tile_vals = torch.empty((rows * tiles, k), dtype=torch.float32, device=x.device)
            tile_idx = torch.empty((rows * tiles, k), dtype=torch.int64, device=x.device)
        with torch.cuda.device(x.device):  # the library launches on the current device
            rc = lib.spf_topk_select(
                x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                None if tiles == 1 else tile_vals.data_ptr(),
                None if tiles == 1 else tile_idx.data_ptr(), rows, n, k,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        _build.check(rc, "top-k select")
        launches += 1
    metrics.inc("topk.select.rows", rows)
    if dists.dtype != torch.float32:
        vals = torch.gather(dists, -1, idx)
    return vals, idx


def smallest_k_unique(dists: torch.Tensor, ids: torch.Tensor, k: int, max_dup: int = 8):
    """k smallest entries with distinct ``ids`` per row — exact given the
    duplication bound ``max_dup`` (SPANN replication caps how often one id
    can appear).  An oversampled top-(k * max_dup) prefilter provably holds
    k distinct ids; duplicates inside it are masked with an O(k'^2)
    comparison.  Duplicate copies carry identical distances, so keeping the
    best-ranked copy is exact.

    Returns (values (..., k), ids (..., k)); rows with fewer than k
    candidates are padded with (+inf, -1)."""
    n = dists.shape[-1]
    if k > n:
        pad = k - n
        dists = torch.cat(
            [dists, torch.full((*dists.shape[:-1], pad), float("inf"), dtype=dists.dtype,
                               device=dists.device)], dim=-1)
        ids = torch.cat(
            [ids, torch.full((*ids.shape[:-1], pad), -1, dtype=ids.dtype, device=ids.device)],
            dim=-1)
        n = k
    kk = min(max(k * max(1, max_dup), k), n)
    vals, idx = smallest_k(dists, kk)
    cand_ids = torch.gather(ids, -1, idx)
    if max_dup > 1:
        same = cand_ids[..., :, None] == cand_ids[..., None, :]  # (..., kk, kk)
        earlier = torch.tril(torch.ones((kk, kk), dtype=torch.bool, device=dists.device),
                             diagonal=-1)
        dup = torch.any(same & earlier, dim=-1)
        vals = torch.where(dup, torch.full_like(vals, float("inf")), vals)
        out_vals, out_idx = smallest_k(vals, min(k, kk))
        return out_vals, torch.gather(cand_ids, -1, out_idx)
    return vals[..., :k], cand_ids[..., :k]


def chunked_centroid_topk(qf, centroids, cent_valid, nprobe: int, metric: str = EUCLIDEAN):
    """Centroid scan + running top-nprobe over ``CENTROID_CHUNK``-row tiles
    of the (C, d) centroid matrix: each step folds a (Q, chunk) distance
    block into the running best via a (nprobe + chunk)-column tie-stable
    top-k, so the (Q, C) matrix never exists.  Exact: every centroid is
    scanned.  Probes with no valid centroid come back as (+inf, 0).
    Returns (dists, indices) (Q, nprobe)."""
    C = centroids.shape[0]
    Q = qf.shape[0]
    dev = qf.device
    chunk = min(CENTROID_CHUNK, C)
    best_d = torch.full((Q, nprobe), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((Q, nprobe), dtype=torch.int64, device=dev)
    for start in range(0, C, chunk):
        block = centroids[start : start + chunk]
        D = pairwise_distance(qf, block, metric)
        D = torch.where(cent_valid[start : start + chunk][None, :], D,
                        torch.full_like(D, float("inf")))
        col = torch.arange(start, start + block.shape[0], device=dev)
        cat_d = torch.cat([best_d, D], dim=1)
        cat_i = torch.cat([best_i, col.expand(Q, -1)], dim=1)
        best_d, idx = smallest_k(cat_d, nprobe)
        best_i = torch.gather(cat_i, 1, idx)
    return best_d, best_i


def centroid_topk(qf: torch.Tensor, centroids: torch.Tensor, cent_valid, nprobe: int,
                  metric: str):
    """Stage-1 probe used by the search: the dense (Q, C) scan + top-nprobe
    for ordinary centroid counts; past ``LARGE_C_THRESHOLD`` the windowed
    scan (Euclidean, nprobe <= 128) or the chunked scan (nprobe <= 1024).
    ``cent_valid`` may be None (all rows valid).

    The JAX package takes the windowed route only on a TPU.  Here the route
    depends on (C, nprobe, metric) alone: a CPU tensor runs the same
    algorithm through the plain versions of its kernels."""
    C = centroids.shape[0]
    if cent_valid is None:
        cent_valid = torch.ones(C, dtype=torch.bool, device=centroids.device)
    if C > LARGE_C_THRESHOLD and nprobe <= 128 and canonical_metric(metric) == EUCLIDEAN:
        from spfresh_tpu_torch.ops.centroid_scan import windowed_centroid_topk

        return windowed_centroid_topk(qf, centroids, cent_valid, nprobe)
    if C > LARGE_C_THRESHOLD and nprobe <= 1024:
        return chunked_centroid_topk(qf, centroids, cent_valid, nprobe, metric)
    Dc = pairwise_distance(qf, centroids, metric)
    Dc = torch.where(cent_valid[None, :], Dc, torch.full_like(Dc, float("inf")))
    return smallest_k(Dc, nprobe)
