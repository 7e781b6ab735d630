"""The control of the comparison: the reference put in the system's place,
computed in the precision below the configuration's: fp8 e4m3 for bf16
storage, and for int8 residual storage, whose steps of 1/254 of a posting's
residual range fp8's 3-bit mantissa cannot hold; bf16 for f32.  It answers
every search exactly, over rows and queries rounded to that precision, keeps
the live set itself, and has no postings (every live row counts as probed).
The comparison has to find it not correct.

    python3 annbench/control.py --workload <cell> --seeds 1 2 3 --seconds 5

prints one JSON line per seed with the compared numbers beside their
limits.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"bfloat16": torch.float8_e4m3fn, "float32": torch.bfloat16,
         "int8": torch.float8_e4m3fn}


class ReferenceSystem:
    """Exact search in a lower precision, with the same methods as
    ``system.ProgramSystem``."""

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.dtype = LOWER[config["index"]["storage_dtype"]]
        self.rows = None
        self.live = None
        self.count = 0

    def build(self, corpus: np.ndarray) -> None:
        self.rows = torch.from_numpy(corpus).to(self.device)
        self.count = len(corpus)
        self.live = torch.ones(self.count, dtype=torch.bool, device=self.device)

    def open_live(self) -> None:
        pass

    @property
    def num_stored(self) -> int:
        return self.count

    def search(self, queries: np.ndarray, k: int, nprobe: int):
        from annbench.reference.exact import lowp_topk

        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(self.device)
        ids, d = lowp_topk(self.rows[:self.count], q, k, live=self.live[:self.count],
                           dtype=self.dtype)
        return ids.cpu().numpy(), d.cpu().numpy()

    def insert(self, vectors: np.ndarray, ids: np.ndarray) -> int:
        top = int(ids.max()) + 1
        if top > self.rows.shape[0]:
            cap = max(top, 2 * self.rows.shape[0])
            rows = torch.zeros((cap, self.rows.shape[1]), device=self.device)
            rows[:self.count] = self.rows[:self.count]
            live = torch.zeros(cap, dtype=torch.bool, device=self.device)
            live[:self.count] = self.live[:self.count]
            self.rows, self.live = rows, live
        t = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        self.rows[t] = torch.from_numpy(np.asarray(vectors, np.float32)).to(self.device)
        self.live[t] = True
        self.count = max(self.count, top)
        return len(ids)

    def delete(self, ids: np.ndarray) -> int:
        t = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        t = t[t < self.count]
        hit = int(self.live[t].sum())
        self.live[t] = False
        return hit

    def quiesce(self) -> None:
        pass

    def snapshot(self):
        return None

    def search_and_snapshot(self, queries, k: int, nprobe: int):
        return self.search(queries, k, nprobe), None

    @staticmethod
    def counters() -> dict:
        return {}

    def close(self) -> None:
        self.rows = self.live = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from annbench import spec
    from annbench.runner import execute

    if not torch.cuda.is_available():
        print("annbench control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        out = execute(cell, seed, args.seconds, device="cuda", trace=False,
                      t_start=time.perf_counter(), system_factory=ReferenceSystem)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": "fp8 exact search",
                          "correct": out.correct, "attempted": out.attempted,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, (v, lim) in out.checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
