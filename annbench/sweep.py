"""The knee of an open-loop cell: its traffic at each of several offered
rates, one window each, in one process.  For each rate: requests served per
second, the median and p99 latency from the due time, and the mean wait
(start - due) over the first and the last quarter of the window; the backlog
grows where the last quarter waits much longer than the first.  The knee is
the highest rate whose backlog does not grow; a cell's rate is set from it
once and written into its mix.

    python3 annbench/sweep.py --workload sift1m-bf16.online --rates 200 400 800 \
        --seconds 10 --seed 7
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from annbench import spec
    from annbench.runner import execute

    cell = spec.cell(args.workload)
    for rate in args.rates:
        cell.traffic["reader"]["rate_per_s"] = rate
        out = execute(cell, args.seed, args.seconds, device="cuda", trace=False,
                      t_start=time.perf_counter())
        reqs = [r for r in out.run.requests if r.error is None]
        due = np.array([r.due for r in reqs]) - out.run.window_start
        wait = np.array([r.start - r.due for r in reqs])
        lat = np.array([r.end - r.due for r in reqs])
        q = args.seconds / 4
        first, last = wait[due < q], wait[due >= 3 * q]
        print(json.dumps({"rate": rate, "served_per_s": len(reqs) / (max(r.end for r in reqs)
                                                                      - out.run.window_start),
                          "p50_ms": 1e3 * float(np.median(lat)),
                          "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                          "wait_first_ms": 1e3 * float(first.mean()),
                          "wait_last_ms": 1e3 * float(last.mean()),
                          "service_ms": 1e3 * float(np.mean([r.end - r.start for r in reqs])),
                          "correct": out.correct}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
