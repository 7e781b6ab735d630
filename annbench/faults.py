"""Faults planted in the program, for reading what the comparison gives a
broken run at a cell's own size.  The benchmark's own runs never plant one.

    python3 annbench/faults.py --workload sift1m-spfresh.churn --fault insert_anywhere \
        --seeds 1 2 3 --seconds 10
    python3 annbench/faults.py --workload bigann4m-int8.batch --fault sq8_truncate \
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


@contextlib.contextmanager
def sq8_truncate(seed: int = 0):
    """The index's int8 pack rounds each residual code toward zero instead
    of to the nearest: a stored copy moves by up to a whole step of its
    posting's scale a coordinate, where SQ8 keeps it within half a step.
    The pack's own scales and slots are kept; only the codes change."""
    import torch
    from spfresh_tpu_torch.index import spann

    real = spann._pack_slabs

    def truncating(vec_source, flat_ids, slots, Cpad, pad, d, d_pad, sd, device, cent=None):
        v, ids, scales = real(vec_source, flat_ids, slots, Cpad, pad, d, d_pad, sd, device,
                              cent=cent)
        if sd == torch.int8:
            flat = v.view(Cpad * pad, d_pad)
            at = torch.from_numpy(slots.astype(np.int64)).to(device)
            inv = torch.reciprocal(scales)
            for s in range(0, len(slots), 1 << 16):
                e = min(len(slots), s + (1 << 16))
                seg = at[s:e] // pad
                r = (vec_source(s, e) - cent[seg]) * inv[seg][:, None]
                flat[at[s:e], :d] = torch.trunc(r).clamp_(-127, 127).to(torch.int8)
        return v, ids, scales

    spann._pack_slabs = truncating
    try:
        yield
    finally:
        spann._pack_slabs = real


FAULTS = {"insert_anywhere": insert_anywhere, "sq8_truncate": sq8_truncate}


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
