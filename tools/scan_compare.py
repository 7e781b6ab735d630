#!/usr/bin/env python3
"""Time the windowed centroid scan against an earlier version of it on one
CUDA card, in turns (earlier, this, this, earlier), on the same inputs.

    git show <commit>:spfresh_tpu_torch/csrc/centroid_scan.cu > build/scan_parent/centroid_scan.cu
    python3 tools/scan_compare.py --parent build/scan_parent/centroid_scan.cu

The earlier source is built on its own with the package's nvcc flags and
called through its plain-C entry point: ``spf_window_scan(caug, qaug,
out, Q, Cpad, d_pad, bf16, stream)``, or, where it exports
``spf_window_scan_scratch``, the form that takes a scratch buffer after
``out``.  Timed, by CUDA events:

- the kernel alone (``centroid_window_scan``) in both rank modes at
  ``chip_smoke.SCAN_TIMED``'s shapes, after holding both versions to the
  plain version at chip_smoke.SCAN_RTOL: called from Python as the port
  calls it, and replayed from a CUDA graph (device time alone);
- the whole ``windowed_centroid_topk`` (nprobe 8) at the ``large`` phase's
  stage-1 shape (f32 centroids: the f32 rank) and the ``outofcore``
  phase's (bf16 centroids), with the ids of both versions compared.

Prints one line a measurement, the card's name and power limit, and last a
JSON object of every number, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the check shapes, inputs and timers)

TOPK_CASES = (("large", 8192, 43_300, 128, "float32"), ("outofcore", 8192, 53_898, 96, "bfloat16"))


def build_parent(src: Path):
    """The earlier scan built on its own into <src dir>/libscan_parent.so."""
    from spfresh_tpu_torch.ops import _build

    out = src.parent / "libscan_parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    scratch = hasattr(lib, "spf_window_scan_scratch")
    lib.spf_window_scan.argtypes = [p, p, p, *([p] if scratch else []), i, i, i, i, p]
    lib.spf_window_scan.restype = i
    if scratch:
        lib.spf_window_scan_scratch.argtypes = [i, i, i, i]
        lib.spf_window_scan_scratch.restype = ctypes.c_longlong
    return lib, scratch


def parent_scan(torch, lib, scratch: bool):
    def scan(caug, qaug, bf16_rank):
        Q, (cpad, d_pad) = qaug.shape[0], caug.shape
        bf16 = int(bool(bf16_rank))
        out = torch.empty((Q, cpad // 128), dtype=torch.float32, device=caug.device)
        extra = []
        if scratch:
            buf = torch.empty(lib.spf_window_scan_scratch(Q, cpad, d_pad, bf16), dtype=torch.uint8,
                              device=caug.device)
            extra = [buf.data_ptr()]
        rc = lib.spf_window_scan(caug.data_ptr(), qaug.data_ptr(), out.data_ptr(), *extra, Q, cpad,
                                 d_pad, bf16, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"parent scan failed: cudaError {rc}"
        return out

    return scan


def in_turns(torch, parent, change, iters: int) -> dict:
    """Mean ms of each in the order parent, change, change, parent."""
    t = [cs.cuda_ms(torch, f, iters) for f in (parent, change, change, parent)]
    return {"parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]]}


def graph_ms(torch, fn, iters: int) -> float:
    """Device ms of one call of ``fn`` replayed from a CUDA graph: the
    kernels' time without the host's launch work, which at a batch of 64
    is about as long as the kernels."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cs.cuda_ms(torch, g.replay, iters)


def graph_in_turns(torch, parent, change, iters: int) -> dict:
    t = [graph_ms(torch, f, iters) for f in (parent, change, change, parent)]
    return {"parent_graph_ms": [t[0], t[3]], "change_graph_ms": [t[1], t[2]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, help="the earlier centroid_scan.cu")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "scan_compare.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: scan_compare.py times the kernels on a GPU only")
    from spfresh_tpu_torch.ops import _build
    from spfresh_tpu_torch.ops import centroid_scan as cs_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"device: {smi}")
    _build.library()
    old = parent_scan(torch, *build_parent(args.parent))
    new = cs_mod.centroid_window_scan
    dev = torch.device("cuda")
    result = {"device": smi, "kernel": [], "topk": []}

    for name, Q, C, d in cs.SCAN_CASES:
        if name not in cs.SCAN_TIMED:
            continue
        data, queries = cs.mixture(2, C, Q, d)
        valid = torch.ones(C, dtype=torch.bool, device=dev)
        valid[::997] = False
        valid[128:256] = False
        d_pad = -(-d // cs_mod.L) * cs_mod.L
        caug, qaug, cpad = cs_mod._augment(torch.from_numpy(queries).to(dev),
                                           torch.from_numpy(data).to(dev), valid, d_pad)
        cn2_mean = float((caug[:C][valid] ** 2).sum(1).mean())
        for bf16_rank in (False, True):
            want = cs_mod.centroid_window_scan_plain(caug, qaug, bf16_rank)
            fin = torch.isfinite(want)
            errs = []
            for f in (old, new):
                got = f(caug, qaug, bf16_rank)
                assert torch.equal(torch.isfinite(got), fin)
                errs.append(float(((got - want).abs()[fin] / (want.abs()[fin] + cn2_mean)).max()))
            assert max(errs) <= cs.SCAN_RTOL, errs
            iters = 50 if Q < 1024 else 10
            t = in_turns(torch, lambda: old(caug, qaug, bf16_rank),
                         lambda: new(caug, qaug, bf16_rank), iters)
            t.update(graph_in_turns(torch, lambda: old(caug, qaug, bf16_rank),
                                    lambda: new(caug, qaug, bf16_rank), iters))
            mode = "bf16" if bf16_rank else "f32"
            row = {"case": name, "rank": mode, "Q": Q, "Cpad": cpad, "d_pad": d_pad,
                   "parent_rel_err": errs[0], "change_rel_err": errs[1], **t}
            result["kernel"].append(row)
            cs.log(f"scan {name} rank={mode} Q={Q} Cpad={cpad} d_pad={d_pad}: parent "
                   f"{t['parent_ms'][0]:.4f} / {t['parent_ms'][1]:.4f} ms, change "
                   f"{t['change_ms'][0]:.4f} / {t['change_ms'][1]:.4f} ms; from a CUDA graph "
                   f"parent {t['parent_graph_ms'][0]:.4f} / {t['parent_graph_ms'][1]:.4f} ms, "
                   f"change {t['change_graph_ms'][0]:.4f} / {t['change_graph_ms'][1]:.4f} ms; "
                   f"rel err parent "
                   f"{errs[0]:.3e} change {errs[1]:.3e}")
        del caug, qaug, want

    for name, Q, C, d, dtype in TOPK_CASES:
        data, queries = cs.mixture(2, C, Q, d)
        cents = torch.from_numpy(data).to(dev).to(getattr(torch, dtype))
        valid = torch.ones(C, dtype=torch.bool, device=dev)
        valid[::997] = False
        qf = torch.from_numpy(queries).to(dev)
        runs = {}

        def topk(scan, key):
            cs_mod.centroid_window_scan = scan
            try:
                runs[key] = cs_mod.windowed_centroid_topk(qf, cents, valid, 8)
            finally:
                cs_mod.centroid_window_scan = new

        t = in_turns(torch, lambda: topk(old, "parent"), lambda: topk(new, "change"), 5)
        differ = int((runs["parent"][1] != runs["change"][1]).sum())
        row = {"case": name, "Q": Q, "C": C, "d": d, "centroids": dtype, "nprobe": 8,
               "ids_differ": differ, **t}
        result["topk"].append(row)
        cs.log(f"windowed_centroid_topk {name} ({dtype} centroids) Q={Q} C={C} d={d} nprobe=8: "
               f"parent {t['parent_ms'][0]:.4f} / {t['parent_ms'][1]:.4f} ms, change "
               f"{t['change_ms'][0]:.4f} / {t['change_ms'][1]:.4f} ms; {differ} of "
               f"{runs['change'][1].numel()} ids differ")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
