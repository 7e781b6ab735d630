"""Faults planted in the program, for reading what the comparison gives a
broken run at a cell's own size.  The benchmark's own runs never plant one.

    python3 annbench/faults.py --workload sift1m-spfresh.churn --fault insert_anywhere \
        --seeds 1 2 3 --seconds 10

prints one JSON line per seed with the compared numbers beside their limits.
The tests (``tests/test_annbench_faults.py``) plant the same faults at a
tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def insert_anywhere(seed: int = 0):
    """``SpFreshIndex`` routes each insert to a random live posting instead
    of its nearest: the searches' own postings still hold every insert."""
    from spfresh_tpu_torch.lire import fresh

    rng = np.random.default_rng(seed)
    real = fresh.SpFreshIndex._nearest_postings

    def anywhere(self, vectors):
        with self._lock:
            pids = sorted(self.index.centroids)
        pick = rng.integers(0, len(pids), len(vectors))
        return np.array([pids[int(i)] for i in pick]), np.zeros(len(vectors), np.float32)

    fresh.SpFreshIndex._nearest_postings = anywhere
    try:
        yield
    finally:
        fresh.SpFreshIndex._nearest_postings = real


FAULTS = {"insert_anywhere": insert_anywhere}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from annbench import spec
    from annbench.runner import execute

    if not torch.cuda.is_available():
        print("annbench faults: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        with FAULTS[args.fault](seed):
            out = execute(cell, seed, args.seconds, device="cuda", trace=False,
                          t_start=time.perf_counter())
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault,
                          "correct": out.correct, "attempted": out.attempted,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, (v, lim) in out.checks.items()},
                          "notes": out.notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
