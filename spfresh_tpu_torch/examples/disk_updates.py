"""Disk-backed live updates (the JAX package's ``examples/disk_updates.py``):
build once, save the packed layout, then serve inserts, deletes and
searches with the corpus on disk (the card holds the centroids, host memory
the delta overlay), and ``compact()`` the overlay into a fresh packed base.

    python -m spfresh_tpu_torch.examples.disk_updates [--device cuda|cpu]
"""

import os
import tempfile

import numpy as np

from spfresh_tpu_torch.examples import parser, start
from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.lire import LazySpFreshIndex, LireConfig


def main(argv=None):
    device = start(parser(__doc__).parse_args(argv))
    rng = np.random.default_rng(0)
    n, d = 5000, 32
    data = rng.standard_normal((n, d)).astype(np.float32)

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 8,
                "desired_cluster_size": 250,
                "rng_seed": 42,
            },
        }
    )
    index = SpannIndexBuilder(cfg, device=device).with_data(data).build(save=False)
    with tempfile.TemporaryDirectory() as tmp:
        idx_dir = os.path.join(tmp, "spfresh_disk_idx")
        index.save(idx_dir, format="packed")
        print(f"built+saved: {index.num_clusters} posting lists -> {idx_dir}")

        with LazySpFreshIndex(
            idx_dir, lire_config=LireConfig(max_partition_size=320, min_partition_size=4),
            device=device,
        ) as fresh:
            # Stream inserts into one region until postings split.
            hot = rng.standard_normal(d).astype(np.float32)
            before = fresh.num_clusters
            batch = hot + 0.01 * rng.standard_normal((400, d)).astype(np.float32)
            fresh.insert_batch(batch, np.arange(10_000, 10_400))
            fresh.flush()
            print(f"after 400 hot inserts: {fresh.num_clusters} posting lists "
                  f"(was {before}); overlay rows: {fresh.storage.overlay_rows()}")

            # Inserted vectors are immediately searchable: the staged slabs
            # are patched against the overlay per batch.
            ids, dists = fresh.search(hot[None, :], k=5, nprobe=8)
            print("nearest to hot spot:", ids[0].tolist())

            # Delete them again; tombstones ride the overlay and the WAL.
            fresh.delete_batch(np.arange(10_000, 10_400))
            fresh.flush()
            ids, _ = fresh.search(hot[None, :], k=5, nprobe=8)
            assert not (set(ids[0].tolist()) & set(range(10_000, 10_400)))
            print(f"after deletes: {fresh.num_clusters} posting lists")

            # Fold the overlay into a fresh packed base (streamed, crash-safe).
            fresh.compact()
            print(f"compacted: overlay rows now {fresh.storage.overlay_rows()}")
            ids, _ = fresh.search(data[:1], k=1, nprobe=fresh.num_clusters)
            print("self-query after compaction returns id", int(ids[0, 0]))
            assert int(ids[0, 0]) == 0


if __name__ == "__main__":
    main()
