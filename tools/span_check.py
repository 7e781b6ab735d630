#!/usr/bin/env python3
"""Check the port's spans (``spfresh_tpu_torch.utils.profiling.span``) on one
CUDA card: what a span costs, and that ``device_trace`` puts the spans of
every thread on the profiler's timeline.

    python3 tools/span_check.py [--device cuda] [--out chiprun_out/span_check.json]

1. Cost: 10**6 empty spans with no trace open (the counters alone), 10**6
   inside ``device_trace`` (four traces of 250,000, each one recorded
   whole), and 250,000 inside a bare ``torch.profiler.profile`` (profiler
   open, spans not recorded), less the empty loop, in µs a span; best of
   three rounds.
2. Timeline: a small bf16 index (20,000 × 128 Gaussian mixture) on the
   device; inside one ``device_trace``, three searches of 1,000 queries on
   this thread, 5 ms apart, and one on a second thread.  Every kernel launch
   of this thread (the CUDA runtime's launch events) must lie inside a
   ``search`` span, each such span must hold one, and the second thread's
   ``search`` span must be exported on its own thread id.
3. The profiler's own state per thread: whether a thread started inside the
   profiled block sees the profiler on, and whether its ``aten::`` ops are
   in the trace.

Prints one line a check, the card's name and power limit, and last a JSON
object of every number, also written to ``--out``; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPANS = 10**6


def card_name() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def cost_us(device_trace, span, count: int) -> dict:
    """µs a span, off and on, each less the empty loop: best of 3 rounds."""
    def loop(n, body):
        t = time.perf_counter()
        body(n)
        return (time.perf_counter() - t) / n

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with span("span_check.cost"):
                pass

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    chunk = count // 4
    off, on, prof, base = [], [], [], []
    with tempfile.TemporaryDirectory() as d:
        for _ in range(3):
            base.append(loop(count, empty))
            off.append(loop(count, spans))
            with torch.profiler.profile(activities=acts):
                prof.append(loop(chunk, spans))
            t = 0.0
            for _ in range(4):
                with device_trace(d):
                    t += loop(chunk, spans) * chunk
                for f in os.listdir(d):
                    os.remove(os.path.join(d, f))
            on.append(t / (4 * chunk))
    b = min(base)
    return {"off_us": 1e6 * (min(off) - b), "on_us": 1e6 * (min(on) - b), "loop_us": 1e6 * b,
            "profiler_open_not_recording_us": 1e6 * (min(prof) - b),
            "off_rounds_us": [1e6 * (x - b) for x in off],
            "on_rounds_us": [1e6 * (x - b) for x in on]}


def timeline(torch, device: str, device_trace) -> dict:
    import numpy as np

    from spfresh_tpu_torch.index import Config, SpannIndexBuilder

    rng = np.random.default_rng(5)
    centers = rng.standard_normal((64, 128)).astype(np.float32)
    data = (centers[rng.integers(0, 64, 20_000)]
            + 0.7 * rng.standard_normal((20_000, 128))).astype(np.float32)
    queries = (centers[rng.integers(0, 64, 1_000)]
               + 0.7 * rng.standard_normal((1_000, 128))).astype(np.float32)
    cfg = Config.from_dict({"clustering_params": {"initial_k": 16, "desired_cluster_size": 256,
                                                  "rng_seed": 42},
                            "storage_dtype": "bfloat16"})
    index = SpannIndexBuilder(cfg, device=device).with_data(data).build(save=False)
    index.search(queries, 10, nprobe=8)  # warm: every kernel built and loaded
    if device == "cuda":
        torch.cuda.synchronize()
    seen = {}

    def other():
        seen["tid"] = threading.get_native_id()
        enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
        seen["profiler_enabled"] = None if enabled is None else bool(enabled())
        index.search(queries[:64], 10, nprobe=8)

    with tempfile.TemporaryDirectory() as d:
        with device_trace(d):
            for _ in range(3):
                index.search(queries, 10, nprobe=8)
                time.sleep(0.005)
            th = threading.Thread(target=other, name="span-check-other")
            th.start()
            th.join(timeout=300)
        (name,) = os.listdir(d)
        trace = json.loads(Path(d, name).read_text())
    me = threading.get_native_id()
    ev = trace["traceEvents"]
    spans = [e for e in ev if e.get("cat") == "spfresh_span" and e["name"] == "search"]
    mine = [e for e in spans if e["tid"] == me]
    theirs = [e for e in spans if e["tid"] == seen["tid"]]
    launches = [e for e in ev if e.get("ph") == "X" and e.get("tid") == me
                and e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e["name"]]

    def inside(s, e):
        return s["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0) <= s["ts"] + s["dur"]

    held = [sum(inside(s, e) for e in launches) for s in mine]
    outside = [e for e in launches if not any(inside(s, e) for s in mine)]
    margins = [min(e["ts"] - s["ts"] for e in launches if inside(s, e)) for s in mine
               if any(inside(s, e) for e in launches)]
    other_aten = sum(1 for e in ev if e.get("tid") == seen["tid"]
                     and str(e.get("name", "")).startswith("aten::"))
    return {"search_spans_this_thread": len(mine), "search_spans_other_thread": len(theirs),
            "launches_this_thread": len(launches), "launches_per_span": held,
            "launches_outside_spans": len(outside),
            "first_launch_after_span_start_us": margins,
            "other_thread_profiler_enabled": seen["profiler_enabled"],
            "other_thread_aten_ops_in_trace": other_aten,
            "spfresh_spans": trace.get("spfresh_spans"),
            "span_names": sorted({e["name"] for e in ev if e.get("cat") == "spfresh_span"})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/span_check.json")
    ap.add_argument("--spans", type=int, default=SPANS, help="spans timed a round and state")
    args = ap.parse_args(argv)

    import torch

    from spfresh_tpu_torch.utils.profiling import device_trace, span

    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_check: no CUDA device", file=sys.stderr)
        return 2
    result = {"card": card_name() if args.device == "cuda" else "cpu",
              "torch": torch.__version__, "cuda": torch.version.cuda}
    result["cost"] = cost_us(device_trace, span, args.spans)
    print(f"span cost: off {result['cost']['off_us']:.3f} us, on {result['cost']['on_us']:.3f} "
          f"us (loop {result['cost']['loop_us']:.3f} us)", flush=True)
    result["timeline"] = tl = timeline(torch, args.device, device_trace)
    print(f"timeline: {json.dumps(tl)}", flush=True)
    failures = []
    if args.device == "cuda":
        if tl["search_spans_this_thread"] != 3 or not tl["launches_this_thread"]:
            failures.append("expected 3 search spans and kernel launches on this thread")
        if tl["launches_outside_spans"] or not all(tl["launches_per_span"]):
            failures.append("a launch outside the search spans, or a span without one")
    if tl["search_spans_other_thread"] != 1:
        failures.append("the second thread's search span was not exported")
    result["failures"] = failures
    print(f"card {result['card']}; torch {result['torch']} cuda {result['cuda']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
