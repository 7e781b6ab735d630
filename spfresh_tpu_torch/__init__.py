"""spfresh_tpu_torch — the SPANN build-and-search path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside ``spfresh_tpu`` (the JAX reference).  It imports
``torch`` and never ``jax``.  Every public entry point takes ``device``,
default ``"cuda"`` (raising where there is no card); ``device="cpu"`` runs
on the CPU.  A CPU tensor runs each kernel's plain PyTorch version, a CUDA
tensor launches the kernel (built from ``csrc/`` on first use) or raises.

Entry points::

    from spfresh_tpu_torch.index import Config, SpannIndexBuilder
    index = SpannIndexBuilder(cfg).with_data(data).build(save=False)
    ids, dists = index.search(queries, k=10, nprobe=8)

Each package level's ``__all__`` is the JAX package's (``parallel`` less
its three Mesh helpers).  Importing builds no kernel and touches no card.
The example CLIs are ``python -m spfresh_tpu_torch.examples.<name>``.
"""

__version__ = "0.1.0"

from spfresh_tpu_torch.clustering import ClusteringParams, HierarchicalClustering
from spfresh_tpu_torch.ops import (
    CHEBYSHEV,
    EUCLIDEAN,
    MANHATTAN,
    METRICS,
    distance,
    pairwise_distance,
)

__all__ = [
    "CHEBYSHEV",
    "EUCLIDEAN",
    "MANHATTAN",
    "METRICS",
    "ClusteringParams",
    "HierarchicalClustering",
    "distance",
    "pairwise_distance",
    "__version__",
]
