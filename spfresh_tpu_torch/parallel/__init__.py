"""Multi-device serving (counterpart of ``spfresh_tpu/parallel``).

``ShardedSpannIndex`` shards an index's posting lists over a list of
devices driven by one process.  ``replicate`` and ``shard_rows`` of the
JAX package place arrays on a ``Mesh`` and have no counterpart here; the
sharded build (``sharded_cluster_step``, ``sharded_replica_pass``) is not
ported yet.
"""

from spfresh_tpu_torch.parallel.sharded import ShardedSpannIndex, default_devices

__all__ = ["ShardedSpannIndex", "default_devices"]
