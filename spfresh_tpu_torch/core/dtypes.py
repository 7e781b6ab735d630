"""Dtype policy (counterpart of ``spfresh_tpu/core/dtypes.py``).

* **storage dtype** — how vectors live in device memory: ``float32`` by
  default, ``bfloat16`` halves the bytes the slab rerank streams.
* **accumulation dtype** — always ``float32``.  Every distance upcasts its
  inputs to f32 *before* the matmul or reduction, so bf16-stored vectors
  accumulate like the f32 reference within rounding.

``int8`` (per-posting residual IVF-SQ8 storage) is not ported yet: it needs
the quantized rerank kernel (ROADMAP queue 1, "int8 storage").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ACCUM_DTYPE = torch.float32

_STORAGE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """The storage dtype of an index; accumulation is always f32."""

    storage: str = "float32"

    def __post_init__(self):
        if self.storage == "int8":
            raise NotImplementedError(
                "int8 storage is not ported yet (ROADMAP queue 1: int8 "
                "residual storage and the quantized slab rerank)"
            )
        if self.storage not in _STORAGE_DTYPES:
            raise ValueError(
                f"unsupported storage dtype {self.storage!r}; "
                f"expected one of {sorted(_STORAGE_DTYPES)}"
            )

    @property
    def storage_dtype(self) -> torch.dtype:
        return _STORAGE_DTYPES[self.storage]


def bf16_round_np(x: np.ndarray) -> np.ndarray:
    """Round a float32 array to the bfloat16 grid (round-half-even) and
    return it as float32 — the wire rounding ``spfresh_tpu`` applies with
    ``ml_dtypes``, done through torch."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()
