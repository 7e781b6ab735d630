from spfresh_tpu_torch.clustering.hierarchical import (
    BOUNDARY_THRESHOLD,
    INIT_METHODS,
    KMEANS_PLUS_PLUS,
    RANDOM,
    Cluster,
    ClusteringParams,
    HierarchicalClustering,
    canonical_init,
)
from spfresh_tpu_torch.clustering.utils import compute_mean, masked_means

__all__ = [
    "BOUNDARY_THRESHOLD",
    "INIT_METHODS",
    "KMEANS_PLUS_PLUS",
    "RANDOM",
    "Cluster",
    "ClusteringParams",
    "HierarchicalClustering",
    "canonical_init",
    "compute_mean",
    "masked_means",
]
