"""Multi-device build and search (the JAX package's
``examples/sharded_search.py``): build over a list of devices, search a
``ShardedSpannIndex`` (per-shard top-k, merge on the first device), and
land a live update in the sharded view in place.

    python -m spfresh_tpu_torch.examples.sharded_search [--device cuda|cpu] [--shards 8]

The list is ``--shards`` entries of ``--device`` (an entry may repeat a
device), the JAX script's 8 shards by default.
"""

import numpy as np

from spfresh_tpu_torch.examples import parser, start
from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.parallel import ShardedSpannIndex


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--shards", type=int, default=8, help="entries of the device list")
    args = ap.parse_args(argv)
    device = start(args)
    devices = [device] * args.shards
    rng = np.random.default_rng(0)
    data = rng.standard_normal((4000, 32)).astype(np.float32)
    print(f"devices: {len(devices)} x {device.type}")

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 8,
                "desired_cluster_size": 250,
                "rng_seed": 42,
            },
        }
    )

    # Build over the device list: the assign/medoid rounds, the multi-way
    # subdivision and the replica pass run data-sharded, with the clusters
    # of a one-device build.
    index = SpannIndexBuilder(cfg, devices=devices).with_data(data).build(save=False)

    sharded = ShardedSpannIndex(index, devices=devices)
    queries = data[:16] + 0.01 * rng.standard_normal((16, 32)).astype(np.float32)
    ids, dists = sharded.search(queries, k=5, nprobe=index.num_clusters)
    assert (ids[np.arange(16), 0] == np.arange(16)).all(), "self-NN failed"
    print(f"sharded full-probe search over {index.num_clusters} postings: "
          f"self-NN exact for all {len(queries)} queries")

    # Live update: append two vectors to one posting; the sharded slab view
    # takes them in place (no rebuild) and search sees them.
    cid = sorted(index.postings)[0]
    pids, pvecs = index.postings[cid]
    new = rng.standard_normal((2, 32)).astype(np.float32)
    index.replace_posting(
        cid,
        np.concatenate([np.asarray(pids), [90_000, 90_001]]),
        np.concatenate([np.asarray(pvecs), new]),
    )
    ids2, _ = sharded.search(new[:1], k=1, nprobe=index.num_clusters)
    assert int(ids2[0, 0]) == 90_000
    print("live insert landed in the sharded view in place; search sees id 90000")


if __name__ == "__main__":
    main()
