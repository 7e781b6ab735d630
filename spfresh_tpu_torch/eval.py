"""Recall evaluation (counterpart of ``spfresh_tpu/eval.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def recall_at_k(result_ids: np.ndarray, groundtruth: np.ndarray, k: Optional[int] = None) -> float:
    """Mean |result ∩ gt| / k over queries.

    result_ids (Q, >=k) with -1 padding; groundtruth (Q, >=k)."""
    if k is None:
        k = min(result_ids.shape[1], groundtruth.shape[1])
    hits = 0
    for r, g in zip(result_ids[:, :k], groundtruth[:, :k]):
        hits += len(set(int(x) for x in r if x >= 0) & set(int(x) for x in g))
    return hits / (len(result_ids) * k)
