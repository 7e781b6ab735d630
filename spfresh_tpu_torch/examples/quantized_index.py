"""int8 residual-quantized index (the JAX package's
``examples/quantized_index.py``): the same clustered corpus built with
float32 and with int8 (residual IVF-SQ8) storage, compared by recall,
reported distances and the slab view's device bytes.

    python -m spfresh_tpu_torch.examples.quantized_index [--device cuda|cpu]
"""

import os
import tempfile

import numpy as np

from spfresh_tpu_torch.eval import recall_at_k
from spfresh_tpu_torch.examples import parser, start
from spfresh_tpu_torch.index import Config, SpannIndexBuilder, brute_force_search


def main(argv=None):
    device = start(parser(__doc__).parse_args(argv))
    rng = np.random.default_rng(7)
    n, dim, n_centers = 20_000, 64, 128
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32)
    data = (
        centers[rng.integers(0, n_centers, n)]
        + 0.5 * rng.standard_normal((n, dim))
    ).astype(np.float32)
    queries = (
        centers[rng.integers(0, n_centers, 500)]
        + 0.5 * rng.standard_normal((500, dim))
    ).astype(np.float32)
    gt_d, gt_i = brute_force_search(data, queries, 10, device=device)

    with tempfile.TemporaryDirectory() as tmp:
        for sd in ("float32", "int8"):
            cfg = Config.from_dict(
                {
                    "clustering_params": {
                        "initial_k": 16,
                        "desired_cluster_size": 256,
                        "rng_seed": 42,
                    },
                    "output_path": os.path.join(tmp, f"spfresh_quant_{sd}"),
                    "storage_dtype": sd,
                }
            )
            index = SpannIndexBuilder(cfg, device=device).with_data(data).build(save=False)
            ids, dists = index.search(queries, 10, nprobe=8)
            slabs = index.padded_view().vectors3d
            slab_mb = slabs.numel() * slabs.element_size() / 2**20
            print(
                f"{sd:8s}  recall@10={recall_at_k(ids, gt_i, 10):.4f}  "
                f"slab HBM={slab_mb:7.1f} MB  "
                f"top-1 dist err={np.abs(dists[:, 0] - gt_d[:, 0]).mean():.4f}"
            )


if __name__ == "__main__":
    main()
