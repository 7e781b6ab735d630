"""One benchmark run of ``spfresh_tpu_torch`` on CUDA devices.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It makes the cell's inputs from the seed,
builds and warms up the system (``setup_s``), measures for ``--seconds``,
checks what the timed path returned against the plain reference, and prints
as its last line on standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer ones, from a profiled slice of the
window), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each compared number beside its limit, which also close standard error.
It exits non-zero and prints no result without the CUDA devices the cell
asks for, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: idle pools of the host's math libraries
# compete with the client loops for the cores and spread the timings.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "spfresh_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _num(x: float):
    return x if math.isfinite(x) else repr(x)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from annbench import spec

    cell = spec.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"annbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    from annbench.runner import execute

    out = execute(cell, args.seed, args.seconds, device="cuda", trace=bool(args.trace),
                  t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"annbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": {name: {"value": v, "unit": u} for name, (v, u) in out.metrics.items()
                          if math.isfinite(v)},
              "device": device}
    if args.trace and out.slice is not None:
        device["busy_s"] = out.slice.busy_s
        device["window_s"] = out.slice.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in out.slice.device_ops],
                               "idle_gaps": [[n, s] for n, s in out.slice.idle_gaps]}
    result["checks"] = {name: {"value": _num(v), "limit": lim}
                        for name, (v, lim) in out.checks.items()}
    print(f"annbench: {args.workload} seed={args.seed} card {power_limit()}", file=sys.stderr)
    for note in out.notes:
        print(f"annbench: {note}", file=sys.stderr)
    for name, (v, lim) in out.checks.items():
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
