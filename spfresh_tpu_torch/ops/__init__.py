from spfresh_tpu_torch.ops.distances import (
    CHEBYSHEV,
    EUCLIDEAN,
    MANHATTAN,
    METRICS,
    canonical_metric,
    distance,
    pairwise_distance,
    rowwise_distance,
)
from spfresh_tpu_torch.ops.topk import smallest_k, smallest_k_unique

__all__ = [
    "CHEBYSHEV",
    "EUCLIDEAN",
    "MANHATTAN",
    "METRICS",
    "canonical_metric",
    "distance",
    "pairwise_distance",
    "rowwise_distance",
    "smallest_k",
    "smallest_k_unique",
]
