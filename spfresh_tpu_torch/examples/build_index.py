"""Build a SPANN index on the toy 6x2 dataset and query it: query (1.0, 2.0)
with k=1 returns point_id 0 (the JAX package's ``examples/build_index.py``).

    python -m spfresh_tpu_torch.examples.build_index [--device cuda|cpu]

The index is saved under the config's ``output_path`` ("data", relative to
the working directory), where ``load_index`` reopens it.
"""

import os

import numpy as np

from spfresh_tpu_torch.examples import parser, start
from spfresh_tpu_torch.index import Config, SpannIndexBuilder

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "example_config.yaml")


def main(argv=None):
    device = start(parser(__doc__).parse_args(argv))
    config = Config.from_file(CONFIG)
    config.rng_seed = 42

    data = np.array(
        [[1.0, 2.0], [1.5, 2.5], [8.0, 8.0], [8.5, 8.5], [4.0, 4.0], [4.5, 4.5]],
        dtype=np.float32,
    )

    index = SpannIndexBuilder(config, device=device).with_data(data).build(dim=2)
    result = index.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)
    print(f"[PointData(point_id={result[0].point_id}, vector={result[0].vector.tolist()})]")
    assert result[0].point_id == 0


if __name__ == "__main__":
    main()
