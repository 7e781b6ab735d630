"""Recall evaluation (counterpart of ``spfresh_tpu/eval.py``): recall@k,
a timed evaluation, the nprobe sweep and exact ground truth."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE
from spfresh_tpu_torch.index.spann import SpannIndex, brute_force_search

log = logging.getLogger(__name__)


def recall_at_k(result_ids: np.ndarray, groundtruth: np.ndarray, k: Optional[int] = None) -> float:
    """Mean |result ∩ gt| / k over queries.

    result_ids (Q, >=k) with -1 padding; groundtruth (Q, >=k)."""
    if k is None:
        k = min(result_ids.shape[1], groundtruth.shape[1])
    hits = 0
    for r, g in zip(result_ids[:, :k], groundtruth[:, :k]):
        hits += len(set(int(x) for x in r if x >= 0) & set(int(x) for x in g))
    return hits / (len(result_ids) * k)


@dataclasses.dataclass
class EvalResult:
    recall: float
    qps: float
    k: int
    nprobe: int
    latency_ms_per_batch: float


def evaluate(
    index: SpannIndex,
    queries: np.ndarray,
    groundtruth: np.ndarray,
    k: int = 10,
    nprobe: Optional[int] = None,
    batch_size: Optional[int] = None,
    warmup: bool = True,
) -> EvalResult:
    """Timed recall evaluation (host clock; ``search`` returns host arrays,
    so the clock stops after the device work).  ``groundtruth`` may come
    from an ivecs file or ``brute_force_search``."""
    queries = np.asarray(queries, np.float32)
    nprobe_eff = nprobe if nprobe is not None else (index.config.search.nprobe or k)
    if warmup:
        index.search(queries[:1], k, nprobe=nprobe)
    t0 = time.perf_counter()
    ids, _ = index.search(queries, k, nprobe=nprobe, batch_size=batch_size)
    dt = time.perf_counter() - t0
    rec = recall_at_k(ids, np.asarray(groundtruth), k)
    nbatches = max(1, -(-len(queries) // (batch_size or index.config.search.query_batch_size)))
    res = EvalResult(
        recall=rec,
        qps=len(queries) / dt,
        k=k,
        nprobe=int(nprobe_eff),
        latency_ms_per_batch=1e3 * dt / nbatches,
    )
    log.info("eval: recall@%d=%.4f qps=%.0f nprobe=%s", k, rec, res.qps, nprobe_eff)
    return res


def nprobe_sweep(
    index: SpannIndex,
    queries: np.ndarray,
    groundtruth: np.ndarray,
    k: int = 10,
    nprobes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
    batch_size: Optional[int] = None,
) -> List[EvalResult]:
    """Recall/QPS curve over nprobe, up to the index's cluster count."""
    out = []
    for np_ in nprobes:
        if np_ > index.num_clusters:
            break
        out.append(evaluate(index, queries, groundtruth, k, np_, batch_size))
    return out


def make_groundtruth(data: np.ndarray, queries: np.ndarray, k: int, metric: str = "Euclidean",
                     device: torch.device | str = DEFAULT_DEVICE) -> np.ndarray:
    """Exact ground truth ids by brute force on ``device``."""
    _, gt = brute_force_search(data, queries, k, metric, device=device)
    return gt
