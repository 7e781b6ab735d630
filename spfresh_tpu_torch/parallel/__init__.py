"""Multi-device serving and build (counterpart of ``spfresh_tpu/parallel``).

One process drives a list of devices; an entry may repeat a device.

* ``ShardedSpannIndex`` shards an index's posting lists over the list.
* ``sharded_cluster_step`` and ``sharded_replica_pass`` (``cluster_step``)
  run the build's assign + medoid round and its closure-replica pass over
  row shards; ``sharded_split_level``, ``sharded_split_level_rows`` and
  ``kmeanspp_init_sharded`` (``build``) its subdivision levels and
  KMeans++ seeding.  ``HierarchicalClustering(devices=...)`` and
  ``SpannIndexBuilder(devices=...)`` drive them.

``__all__`` is the JAX package's, less ``default_mesh``, ``replicate`` and
``shard_rows``: they build and place arrays on a ``jax.sharding.Mesh``, and
a list of devices takes the mesh's place here (neither have the
mesh-resident split and apply calls a counterpart).  ``default_devices``
(every visible CUDA device, in ``default_mesh``'s place) and the build
functions above are importable from here too.
"""

from spfresh_tpu_torch.parallel.build import (
    kmeanspp_init_sharded,
    sharded_split_level,
    sharded_split_level_rows,
)
from spfresh_tpu_torch.parallel.cluster_step import sharded_cluster_step, sharded_replica_pass
from spfresh_tpu_torch.parallel.sharded import ShardedSpannIndex, default_devices

__all__ = [
    "ShardedSpannIndex",
    "sharded_cluster_step",
    "sharded_replica_pass",
]
