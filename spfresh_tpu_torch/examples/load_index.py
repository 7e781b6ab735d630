"""Load the SPANN index that ``build_index`` saved and query it (the JAX
package's ``examples/load_index.py``; either package's saved index loads).

    python -m spfresh_tpu_torch.examples.load_index [--device cuda|cpu]
"""

import numpy as np

from spfresh_tpu_torch.examples import parser, start
from spfresh_tpu_torch.examples.build_index import CONFIG
from spfresh_tpu_torch.index import Config, SpannIndexBuilder


def main(argv=None):
    device = start(parser(__doc__).parse_args(argv))
    config = Config.from_file(CONFIG)

    index = SpannIndexBuilder(config, device=device).load(dim=2)
    result = index.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)
    print(
        f"Nearest neighbour: point_id: {result[0].point_id} "
        f"and vector: {result[0].vector.tolist()}"
    )


if __name__ == "__main__":
    main()
