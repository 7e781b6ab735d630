"""Sets of runs of one cell, for setting bounds: each run its own process
(``run.py``), one after another, each with its seed; prints each result line
and, per metric, the median and the quartile spread (``stats``), and keeps
every line and the end of each run's standard error in ``--out``.

    python3 annbench/sets.py --workload <cell> --seeds 11 12 13 --seconds 30 \
        [--trace 0] [--out chiprun_out/sets.jsonl]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from annbench.stats import quartile_spread  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    values = {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t = time.perf_counter()
            p = subprocess.run([sys.executable, str(ROOT / "annbench" / "run.py"), "--workload",
                                args.workload, "--seed", str(seed), "--seconds",
                                str(args.seconds), "--trace", str(args.trace)],
                               capture_output=True, text=True, cwd=ROOT)
            wall = time.perf_counter() - t
            lines = p.stdout.strip().splitlines()
            rec = {"workload": args.workload, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "stderr_tail": p.stderr[-3000:]}
            try:
                rec["result"] = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                rec["result"] = None
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            res = rec["result"]
            print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": round(wall, 1),
                              "result": res}), flush=True)
            if res is None:
                print(p.stderr[-3000:], file=sys.stderr, flush=True)
                continue
            for name, m in res["metrics"].items():
                values.setdefault(name, []).append(m["value"])
    finally:
        if out:
            out.close()
    for name, v in values.items():
        print(f"{args.workload} {name}: n={len(v)} median={statistics.median(v)!r} "
              f"spread={quartile_spread(v)!r} values={v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
