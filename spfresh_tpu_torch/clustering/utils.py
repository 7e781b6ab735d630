"""Small clustering helpers (counterpart of ``spfresh_tpu/clustering/utils.py``)."""

from __future__ import annotations

import numpy as np
import torch

from spfresh_tpu_torch.core.dtypes import ACCUM_DTYPE


def compute_mean(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Mean of the selected rows in f32: data (n, d), indices (m,) -> (d,)."""
    return torch.mean(data[indices].to(ACCUM_DTYPE), dim=0)


def masked_means(data: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """Per-cluster means from a bool membership mask: data (n, d),
    member_mask (n, k) -> (k, d), one ``mask^T @ data`` f32 matmul.  Empty
    clusters get a zero mean (callers guard with counts)."""
    m = member_mask.to(ACCUM_DTYPE)
    sums = torch.matmul(m.T, data.to(ACCUM_DTYPE))  # (k, d)
    counts = torch.sum(m, dim=0)[:, None]
    return sums / torch.clamp_min(counts, 1.0)


def seg_max(vals: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """(S,) maximum of ``vals`` per segment ``seg``; -inf for an empty one."""
    return torch.full((S,), float("-inf"), dtype=vals.dtype, device=vals.device).scatter_reduce(
        0, seg, vals, "amax")


def seg_min(vals: torch.Tensor, seg: torch.Tensor, S: int, init: int) -> torch.Tensor:
    """(S,) minimum of ``vals`` per segment ``seg``; ``init`` for an empty
    one (and an upper bound of every value)."""
    return torch.full((S,), init, dtype=vals.dtype, device=vals.device).scatter_reduce(
        0, seg, vals, "amin")


def seg_sum(vals: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """(S, ...) sum of ``vals`` per segment ``seg``."""
    return torch.zeros((S,) + vals.shape[1:], dtype=vals.dtype, device=vals.device).index_add_(
        0, seg, vals)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def budget_sort(e_cls, e_d):
    """Stable (cluster asc, distance asc, input-order) permutation for the
    replica budget pass — the order ``np.lexsort((e_d, e_cls))`` gives, from
    one u64 radix key ``cls << 32 | f32 bits`` (distances are >= 0, so the
    bit pattern is order-preserving)."""
    e_d = np.ascontiguousarray(e_d, np.float32)
    if len(e_d) and float(e_d.min()) < 0.0:  # pragma: no cover - defensive
        return np.lexsort((e_d, e_cls))
    # +0.0 normalizes any -0.0 (bit 0x80000000 would sort as huge).
    key = (np.asarray(e_cls, np.uint64) << np.uint64(32)) | (
        e_d + np.float32(0.0)
    ).view(np.uint32).astype(np.uint64)
    return np.argsort(key, kind="stable")
