"""L1 / Linf pairwise distances (counterpart of
``spfresh_tpu/ops/pallas/pairwise.py``, ``pallas_l1_linf_pairwise``).

``l1_linf_pairwise`` launches the CUDA kernel in ``csrc/pairwise.cu`` for
CUDA tensors and runs ``l1_linf_pairwise_plain`` for CPU tensors; anything
else raises.  ``ops.distances.pairwise_distance`` sends Manhattan and
Chebyshev calls on CUDA tensors here from ``L1_LINF_KERNEL_OPS`` element
operations on, as the JAX package sends them to its Pallas kernel.
"""

from __future__ import annotations

import torch

from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops.distances import CHEBYSHEV, MANHATTAN, _elementwise_pairwise

# Kernel launches since the last reset (set to 0 to reset).
launches = 0


def l1_linf_pairwise_plain(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """Plain PyTorch version: the tiled broadcast-reduce
    ``reduce_k |x[:, None, k] - y[None, :, k]|`` in f32."""
    return _elementwise_pairwise(x, y, metric, tile_n=1024)


def l1_linf_pairwise(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """(n, d) x (m, d) -> (n, m) f32 Manhattan or Chebyshev distances.
    ``x`` and ``y`` share float32 or bfloat16; sums and maxima are f32."""
    global launches
    if metric not in (MANHATTAN, CHEBYSHEV):
        raise ValueError(f"metric must be {MANHATTAN!r} or {CHEBYSHEV!r}, got {metric!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"expected x (n, d) and y (m, d); got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x and y must share float32 or bfloat16; got {x.dtype}, {y.dtype}")
    if x.device != y.device:
        raise ValueError("x and y must be on one device")
    if x.device.type == "cpu":
        return l1_linf_pairwise_plain(x, y, metric)
    if x.device.type != "cuda":
        raise ValueError(f"no L1/Linf pairwise kernel for device {x.device}")
    x, y = x.contiguous(), y.contiguous()
    n, d = x.shape
    m = y.shape[0]
    if max(n * d, m * d) >= 2**31 or m > 65_535 * 128:
        raise ValueError(f"x {tuple(x.shape)} or y {tuple(y.shape)} exceed the kernel's range")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the library launches on the current device
        rc = _build.library().spf_l1_linf_pairwise(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d,
            int(metric == MANHATTAN), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "L1/Linf pairwise")
    launches += 1
    return out
