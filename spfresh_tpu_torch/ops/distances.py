"""Batched distances (counterpart of ``spfresh_tpu/ops/distances.py``).

* ``Euclidean`` means *squared* L2 everywhere, as in the reference.  The
  fast form is the expansion ``|x|^2 + |y|^2 - 2 x.y``: one f32 matmul plus
  rank-1 corrections.  Inputs are upcast to f32 *before* ``torch.matmul``
  — the JAX package's ``dot_general(..., preferred_element_type=f32)`` over
  bf16 inputs returns f32 sums of exact bf16 products, which a bf16
  ``torch.matmul`` would round back to bf16.
* The exact form (``exact=True``) and ``Manhattan``/``Chebyshev`` reduce
  the elementwise difference, tiled so the (tile, m, d) intermediate stays
  bounded.  On CUDA tensors, Manhattan and Chebyshev calls of at least
  ``L1_LINF_KERNEL_OPS`` element operations launch the L1/Linf kernel
  (``ops.pairwise``), where the JAX package launches its Pallas kernel.

float32 matmuls run at full precision: TF32 is switched off for both
matmuls and cuDNN when this module is imported, the counterpart of the
reference's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spfresh_tpu_torch.core.dtypes import ACCUM_DTYPE

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EUCLIDEAN = "Euclidean"
MANHATTAN = "Manhattan"
CHEBYSHEV = "Chebyshev"
METRICS: Sequence[str] = (EUCLIDEAN, MANHATTAN, CHEBYSHEV)

# At or past this many n*m*d element ops L1/Linf pairwise distances on a
# CUDA tensor take the L1/Linf kernel, as the JAX package's take its Pallas
# kernel (spfresh_tpu/ops/distances.py:124-134).
L1_LINF_KERNEL_OPS = 1 << 22


def canonical_metric(name: str) -> str:
    """Validate/normalise a metric name (case-insensitive)."""
    lowered = str(name).strip().lower()
    for m in METRICS:
        if lowered == m.lower():
            return m
    raise ValueError(f"unknown distance metric {name!r}; expected one of {list(METRICS)}")


def _reduce(diff: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == EUCLIDEAN:
        return torch.sum(diff * diff, dim=-1)
    if metric == MANHATTAN:
        return torch.sum(torch.abs(diff), dim=-1)
    return torch.amax(torch.abs(diff), dim=-1)


def _sq_l2_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xf = x.to(ACCUM_DTYPE)
    yf = y.to(ACCUM_DTYPE)
    x2 = torch.sum(xf * xf, dim=-1, keepdim=True)  # (n, 1)
    y2 = torch.sum(yf * yf, dim=-1)  # (m,)
    d = x2 + y2[None, :] - 2.0 * torch.matmul(xf, yf.T)
    # The expansion can go slightly negative from rounding; distances are >= 0.
    return torch.clamp_min(d, 0.0)


def _elementwise_pairwise(x: torch.Tensor, y: torch.Tensor, metric: str,
                          tile_n: int) -> torch.Tensor:
    """Tiled ``reduce(x[:, None, :] - y[None, :, :])`` — also the *exact*
    squared-L2 form (the expansion loses ~1e-3 relative precision to
    cancellation, which matters for ground truth)."""
    xf = x.to(ACCUM_DTYPE)
    yf = y.to(ACCUM_DTYPE)
    n = xf.shape[0]
    # Bound the (tile, m, d) broadcast intermediate to ~256 MB.
    budget_rows = max(8, (1 << 26) // max(1, y.shape[0] * y.shape[1]))
    tile_n = max(1, min(tile_n, budget_rows, n))
    out = torch.empty((n, yf.shape[0]), dtype=ACCUM_DTYPE, device=x.device)
    for s in range(0, n, tile_n):
        out[s : s + tile_n] = _reduce(xf[s : s + tile_n, None, :] - yf[None, :, :], metric)
    return out


def takes_l1_linf_kernel(x, y, metric: str) -> bool:
    """Whether ``pairwise_distance`` sends (x, y) to the L1/Linf kernel:
    Manhattan or Chebyshev, CUDA tensors, n*m*d >= L1_LINF_KERNEL_OPS."""
    return (metric in (MANHATTAN, CHEBYSHEV) and x.device.type == "cuda"
            and x.shape[0] * y.shape[0] * x.shape[1] >= L1_LINF_KERNEL_OPS)


def pairwise_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: str = EUCLIDEAN,
    tile_n: int = 1024,
    exact: bool = False,
) -> torch.Tensor:
    """All-pairs distances between rows of ``x`` (n, d) and ``y`` (m, d) as
    an (n, m) f32 tensor.  For Euclidean, ``exact=False`` uses the fast
    matmul expansion (probe selection); ``exact=True`` the elementwise
    difference form (rerank-grade precision, ground truth)."""
    metric = canonical_metric(metric)
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"expected 2-d inputs, got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[-1] != y.shape[-1]:
        raise ValueError(f"dimension mismatch: {x.shape[-1]} vs {y.shape[-1]}")
    if metric == EUCLIDEAN and not exact:
        return _sq_l2_pairwise(x, y)
    if takes_l1_linf_kernel(x, y, metric):
        from spfresh_tpu_torch.ops.pairwise import l1_linf_pairwise

        if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.bfloat16):
            x, y = x.to(ACCUM_DTYPE), y.to(ACCUM_DTYPE)
        return l1_linf_pairwise(x, y, metric)
    return _elementwise_pairwise(x, y, metric, tile_n)


def rowwise_distance(x: torch.Tensor, y: torch.Tensor, metric: str = EUCLIDEAN) -> torch.Tensor:
    """Row-aligned distances: x (..., d) vs y (..., d) -> (...,)."""
    metric = canonical_metric(metric)
    return _reduce(x.to(ACCUM_DTYPE) - y.to(ACCUM_DTYPE), metric)


def distance(u, v, metric: str = EUCLIDEAN) -> torch.Tensor:
    """Single-pair distance; scalar f32 tensor."""
    u = torch.as_tensor(u, dtype=ACCUM_DTYPE).reshape(-1)
    v = torch.as_tensor(v, dtype=ACCUM_DTYPE, device=u.device).reshape(-1)
    return rowwise_distance(u, v, metric)


def distance_f64(u, v, metric: str = EUCLIDEAN) -> np.float64:
    """Single-pair float64 distance on the host (numpy), for verification
    and ground-truth work; the device path accumulates in f32."""
    metric = canonical_metric(metric)
    uf = np.asarray(u, np.float64).reshape(-1)
    vf = np.asarray(v, np.float64).reshape(-1)
    if uf.shape != vf.shape:
        raise ValueError(f"dimension mismatch: {uf.shape} vs {vf.shape}")
    diff = uf - vf
    if metric == EUCLIDEAN:
        return np.float64(np.sum(diff * diff))
    if metric == MANHATTAN:
        return np.float64(np.sum(np.abs(diff)))
    return np.float64(np.max(np.abs(diff)))
