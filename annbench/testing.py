"""The test-only entry: one cell's whole run (inputs, set-up, client loops,
comparison) at a tiny size.  It returns the ``Outcome`` and prints nothing;
no device metric of such a run is ever reported."""

from __future__ import annotations

import copy

from annbench import spec
from annbench.clients import now
from annbench.runner import execute

# 3,000 rows of the same mixture, 200 queries, postings of ~64, and rates a
# short window on the CPU holds many requests and steps of.
SMALL = {"corpus": {"n": 3000, "queries": 200},
         "index": {"clustering_params": {"desired_cluster_size": 64, "initial_k": 4}}}
SMALL_RATE = 100.0         # reads a second
SMALL_WRITE_RATE = 640.0   # ops a second: a step every 0.1 s


def run_small(name: str, seed: int = 5, seconds: float = 1.0, *, device="cpu", trace=False,
              benchmark=spec.BENCHMARK, **kw):
    cell = spec.cell(name, benchmark)
    cell.traffic = copy.deepcopy(cell.traffic)
    if cell.traffic.get("writer"):
        cell.traffic["writer"]["rate_ops_per_s"] = SMALL_WRITE_RATE
    if cell.traffic["reader"]["loop"] == "open":
        cell.traffic["reader"]["rate_per_s"] = SMALL_RATE
    return execute(cell, seed, seconds, device=device, trace=trace, t_start=now(),
                   sizes=SMALL, **kw)
