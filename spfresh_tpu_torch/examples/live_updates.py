"""SPFresh live updates: build an index, stream inserts and deletes, and
watch background split/merge keep it balanced (the JAX package's
``examples/live_updates.py``).

    python -m spfresh_tpu_torch.examples.live_updates [--device cuda|cpu]
"""

import os
import tempfile

import numpy as np

from spfresh_tpu_torch.examples import parser, start
from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex
from spfresh_tpu_torch.utils import metrics


def main(argv=None):
    device = start(parser(__doc__).parse_args(argv))
    rng = np.random.default_rng(0)
    data = rng.standard_normal((2000, 16)).astype(np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config.from_dict(
            {
                "clustering_params": {
                    "initial_k": 8,
                    "desired_cluster_size": 200,
                    "rng_seed": 42,
                },
                "output_path": os.path.join(tmp, "idx"),
            }
        )
        index = SpannIndexBuilder(cfg, device=device).with_data(data).build(save=False)
        print(f"built: {index.num_clusters} posting lists")

        with SpFreshIndex(
            index, os.path.join(tmp, "store"),
            LireConfig(max_partition_size=260, min_partition_size=4),
        ) as fresh:
            # Stream inserts into one region until a posting splits.
            hot = rng.standard_normal(16).astype(np.float32)
            before = fresh.index.num_clusters
            for i in range(400):
                fresh.insert(hot + 0.01 * rng.standard_normal(16).astype(np.float32), 10_000 + i)
            fresh.flush()
            print(f"after 400 hot inserts: {fresh.index.num_clusters} posting lists "
                  f"(was {before}; background splits rebalanced)")

            # Inserted vectors are immediately searchable.
            ids, dists = fresh.search(hot[None, :], k=5, nprobe=8)
            print("nearest to hot spot:", ids[0].tolist())

            # Delete them again; undersized postings merge away.
            for i in range(400):
                fresh.delete(10_000 + i)
            fresh.flush()
            fresh.repair()
            fresh.flush()
            print(f"after deletes: {fresh.index.num_clusters} posting lists")
            print("pipeline metrics:", {
                k: v for k, v in sorted(metrics.snapshot().items()) if k.startswith("lire")
            })


if __name__ == "__main__":
    main()
