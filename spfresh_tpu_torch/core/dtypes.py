"""Dtype policy (counterpart of ``spfresh_tpu/core/dtypes.py``).

* **storage dtype** — how vectors live in device memory: ``float32`` by
  default, ``bfloat16`` halves the bytes the slab rerank streams.
  ``int8`` is residual IVF-SQ8: each posting slab stores
  ``round((x - c) / s_c)`` with one scale ``s_c`` per posting, and the
  quantized slab rerank dequantizes it (``ops.rerank``).
* **accumulation dtype** — always ``float32``.  Every distance upcasts its
  inputs to f32 *before* the matmul or reduction, so bf16-stored vectors
  accumulate like the f32 reference within rounding.

The int8 helpers below use the JAX package's f32 expressions
(``spfresh_tpu/core/dtypes.py``), so packs from either package are
bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ACCUM_DTYPE = torch.float32

_STORAGE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """The storage dtype of an index; accumulation is always f32."""

    storage: str = "float32"

    def __post_init__(self):
        if self.storage not in _STORAGE_DTYPES:
            raise ValueError(
                f"unsupported storage dtype {self.storage!r}; "
                f"expected one of {sorted(_STORAGE_DTYPES)}"
            )

    @property
    def storage_dtype(self) -> torch.dtype:
        return _STORAGE_DTYPES[self.storage]

    @property
    def accum_dtype(self) -> torch.dtype:
        return ACCUM_DTYPE

    @property
    def storage_itemsize(self) -> int:
        return self.storage_dtype.itemsize

    def to_storage(self, x, device=None) -> torch.Tensor:
        """``x`` as a tensor in the storage dtype on ``device`` (default:
        ``x``'s own device when it is a tensor, else the CPU)."""
        return torch.as_tensor(x, dtype=self.storage_dtype, device=_device_of(x, device))

    def to_accum(self, x, device=None) -> torch.Tensor:
        """``x`` as an f32 tensor on ``device``, defaulting as ``to_storage``."""
        return torch.as_tensor(x, dtype=ACCUM_DTYPE, device=_device_of(x, device))

    @property
    def quantized(self) -> bool:
        return self.storage == "int8"


DEFAULT_POLICY = DtypePolicy()


def _device_of(x, device):
    """``device`` if given, else ``x``'s device for a tensor, else the CPU:
    nothing moves to a card unless the caller names it."""
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def quant_scale_for(vecs) -> float:
    """Symmetric int8 scale for one posting: max|x| * (1/127), the same f32
    expression as :func:`posting_scales_np`; 1.0 for an all-zero posting."""
    m = np.float32(np.max(np.abs(np.asarray(vecs, np.float32)), initial=0.0))
    return float(m * np.float32(1.0 / 127.0)) or 1.0


def posting_scales_np(rowmax: np.ndarray) -> np.ndarray:
    """Per-posting scales from exact per-posting abs-maxima: rowmax / 127 as
    ``rowmax * f32(1/127)``, with empty or all-zero postings pinned to 1.0
    so the reciprocal stays finite."""
    rowmax = np.asarray(rowmax, np.float32)
    return np.where(
        rowmax > 0, rowmax * np.float32(1.0 / 127.0), np.float32(1.0)
    ).astype(np.float32)


def quantize_np(x: np.ndarray, scale) -> np.ndarray:
    """int8 codes ``clip(rint(x * (1/scale)), -127, 127)``: a multiply by
    the f32 reciprocal (not a division, which differs at .5 boundaries),
    rounding half to even.  ``scale`` is a scalar or broadcasts per row."""
    inv = np.float32(1.0) / np.asarray(scale, np.float32)
    return np.clip(np.rint(np.asarray(x, np.float32) * inv), -127, 127).astype(np.int8)


def bf16_round_np(x: np.ndarray) -> np.ndarray:
    """Round a float32 array to the bfloat16 grid (round-half-even) and
    return it as float32 — the wire rounding ``spfresh_tpu`` applies with
    ``ml_dtypes``, done through torch."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def as_f32_np(x) -> np.ndarray:
    """Host-side canonicalisation: a contiguous float32 numpy array."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))
