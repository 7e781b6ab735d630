#!/usr/bin/env python3
"""Drive the spfresh_tpu_torch main path once on one CUDA card.

    python3 chip_smoke.py            # all phases, one card, exits 0 on success

Phases, each printing a line:

1. device   — require CUDA; print nvidia-smi's name and power limit.
2. build    — compile csrc/*.cu with nvcc for sm_90a, one nvcc per source,
              all at once (cached in build/kernels/).
3. kernels  — each kernel against its plain PyTorch version on the card at
              the shapes its path gives it, with CUDA-event times for both.
4. main     — the bench corpus (1M x 128 Gaussian mixture, seed 12345), a
              KMeans++ bf16 build through SpannIndexBuilder on "cuda",
              padded_view(), exact ground truth on the card, and an nprobe
              sweep to recall@10 >= 0.90; asserts the rerank and replica
              kernels ran in it; then device time by operation
              (torch.profiler) over 3 searches at the recall point.
5. large    — the same generator at 4,194,304 x 128 (4,194 centers) with
              int8 (IVF-SQ8) storage: more than 32,768 clusters, so stage 1
              takes the windowed centroid scan and the rerank its quantized
              path; ground truth, the nprobe sweep to recall@10 >= 0.80
              (LARGE_RECALL_TARGET), both new kernels launched in the
              phase, the ids through the dense stage 1 and of 1,000
              queries against the same view searched on the CPU with the
              plain versions, the device-time breakdown, and int8 against
              a bf16 build of the same corpus.
6. exact    — a 20k f32 index: full-probe search must have recall exactly 1.0.

Any failure raises, so the exit code is non-zero.  The last two lines are
the kernel report and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

REPLACES = {
    "rerank": "spfresh_tpu/ops/pallas/rerank.py:146",
    "replica": "spfresh_tpu/ops/pallas/replica.py:412",
    "centroid_scan": "spfresh_tpu/ops/pallas/centroid_scan.py:94",
    "rerank_int8": "spfresh_tpu/ops/pallas/rerank.py:117",
}
SOURCES = {
    "rerank": "spfresh_tpu_torch/csrc/rerank.cu",
    "replica": "spfresh_tpu_torch/csrc/replica.cu",
    "centroid_scan": "spfresh_tpu_torch/csrc/centroid_scan.cu",
    "rerank_int8": "spfresh_tpu_torch/csrc/rerank.cu",
}
RERANK_RTOL = 1e-5   # f32 sums of 128 terms in another order
REPLICA_RTOL = 1e-4  # expansion-form ranks, f32, another summation order
# Window-minimum ranks |c|^2 - 2 q.c: f32 sums of 128 products in another
# order.  A rank is a difference of terms of the size of |c|^2, so its
# error is relative to that size, not to the (possibly cancelled) rank.
SCAN_RTOL = 1e-5
LARGE_N = 4_194_304  # the smallest power of two whose build crosses 32,768 clusters
# The large phase's recall target.  On this corpus the hierarchical build's
# probe recall falls with n in both packages (tests/test_torch_build_quality.py
# run as a script): at 4M no nprobe <= 64 reaches 0.90, so the phase's
# operating point is the first nprobe at recall@10 >= 0.80.
LARGE_RECALL_TARGET = 0.80
TIE_TOL = 1e-4       # relative gap under which two ranks or bounds count as tied
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean CUDA-event milliseconds per call over ``iters`` calls, warmed."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mixture(seed: int, n: int, nq: int, d: int = 128, spread: float = 0.7):
    """The bench corpus: Gaussian mixture with max(64, n // 1000) centers,
    queries from the same mixture."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, n // 1000)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)

    def draw(m):
        a = rng.integers(0, n_centers, size=m)
        return (centers[a] + spread * rng.standard_normal((m, d))).astype(np.float32)

    return draw(n), draw(nq)


def mixture_blobs(seed: int, n: int, d: int = 128):
    """The blob (mixture center) of each of the n corpus points of
    ``mixture(seed, n, ...)``: the generator's first two draws, replayed."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, n // 1000)
    rng.standard_normal((n_centers, d))
    return rng.integers(0, n_centers, size=n)


def phase_kernels(torch, report):
    from spfresh_tpu_torch.ops import rerank, replica
    from spfresh_tpu_torch.ops.distances import pairwise_distance

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)

    # Kernel 1 at the main path's shape, then every metric x slab dtype small.
    Q, nprobe, pad, d_pad, cpad = 8192, 8, 336, 128, 11008
    slabs = torch.randn((cpad, pad, d_pad), generator=g, device=dev).to(torch.bfloat16)
    queries = torch.randn((Q, d_pad), generator=g, device=dev)
    rows = torch.randint(0, cpad, (Q, nprobe), generator=g, device=dev, dtype=torch.int32)
    got = rerank.padded_rerank_distances(queries, rows, slabs)
    want = rerank.padded_rerank_distances_plain(queries, rows, slabs)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = float((err / want.abs().clamp_min(1.0)).max())
    assert rel <= RERANK_RTOL, f"rerank rel err {rel} > {RERANK_RTOL}"
    for metric in ("Euclidean", "Manhattan", "Chebyshev"):
        for sd in (torch.float32, torch.bfloat16):
            s = slabs[:512].to(sd)
            r = rows[:512] % 512
            a = rerank.padded_rerank_distances(queries[:512], r, s, metric)
            b = rerank.padded_rerank_distances_plain(queries[:512], r, s, metric)
            e = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
            assert e <= RERANK_RTOL, f"rerank {metric} {sd}: rel err {e}"
    ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances(queries, rows, slabs), 20)
    plain_ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances_plain(queries, rows, slabs), 3)
    gbps = Q * nprobe * pad * d_pad * 2 / (ms * 1e-3) / 1e9
    log(f"kernel rerank: Q={Q} nprobe={nprobe} pad={pad} d_pad={d_pad} Cpad={cpad} bf16 "
        f"max_rel_err={rel:.3e} max_abs_err={float(err.max()):.3e} (rtol {RERANK_RTOL}) "
        f"kernel={ms:.4f} ms ({gbps:.0f} GB/s slab reads) plain={plain_ms:.4f} ms; "
        f"all 3 metrics x f32/bf16 agree at Q=512")
    report["rerank"] = {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms}
    del slabs, got, want, err

    # Kernel 2: n points of the bench mixture, C medoid-like centroids,
    # base = nearest centroid (what the build hands the replica pass).
    n, C, d, n_extra, lam, bt = 65536, 10775, 128, 3, 0.5, float(np.float32(1.1))
    data, _ = mixture(1, n + C, 0, d)
    X = torch.from_numpy(data[:n]).to(dev).to(torch.bfloat16)
    cents = torch.from_numpy(data[n:]).to(dev).to(torch.bfloat16)
    base = torch.empty(n, dtype=torch.int32, device=dev)
    for s in range(0, n, 8192):
        base[s : s + 8192] = torch.argmin(pairwise_distance(X[s : s + 8192], cents), 1)
    ki, kr = replica.replica_topk(X, base, cents, bt, n_extra, soar_lambda=lam)
    pi, pr = replica.replica_topk_plain(X, base, cents, bt, n_extra, soar_lambda=lam)
    torch.cuda.synchronize()
    ki, kr, pi, pr = (t.cpu().numpy() for t in (ki, kr, pi, pr))
    tie_rows, max_abs, max_rel = replica_compare(
        X.float().cpu().numpy().astype(np.float64), base.cpu().numpy(),
        cents.float().cpu().numpy().astype(np.float64), bt, ki, kr, pi, pr)
    assert max_rel <= REPLICA_RTOL, f"replica rank rel err {max_rel} > {REPLICA_RTOL}"
    admitted = int(np.isfinite(kr).sum())
    assert admitted > n // 10, f"only {admitted} replicas admitted: degenerate check"
    ms = cuda_ms(torch, lambda: replica.replica_topk(X, base, cents, bt, n_extra,
                                                     soar_lambda=lam), 5)
    plain_ms = cuda_ms(torch, lambda: replica.replica_topk_plain(X, base, cents, bt, n_extra,
                                                                 soar_lambda=lam), 2)
    tflops = 4 * n * C * d / (ms * 1e-3) / 1e12
    log(f"kernel replica: n={n} C={C} d={d} bf16 n_extra={n_extra} lambda={lam} "
        f"admitted={admitted} near_tie_rows={tie_rows} max_rank_rel_err={max_rel:.3e} "
        f"max_rank_abs_err={max_abs:.3e} (rtol {REPLICA_RTOL}) kernel={ms:.4f} ms "
        f"({tflops:.2f} TFLOP/s) plain={plain_ms:.4f} ms")
    report["replica"] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
    del X, cents, base

    kernel_centroid_scan(torch, report)
    kernel_rerank_int8(torch, report)


def kernel_centroid_scan(torch, report):
    """The window scan at the large phase's stage-1 shape in both rank
    modes: bench-mixture centroids with a few invalid (1e18) rows, and
    bench-mixture queries."""
    from spfresh_tpu_torch.ops import centroid_scan

    dev = torch.device(DEVICE)
    Q, C, d_pad = 8192, 43_300, 128
    data, queries = mixture(2, C, Q)
    valid = torch.ones(C, dtype=torch.bool, device=dev)
    valid[::997] = False
    caug, qaug, cpad = centroid_scan._augment(torch.from_numpy(queries).to(dev),
                                              torch.from_numpy(data).to(dev), valid, d_pad)
    assert cpad == 44_032, cpad
    cn2_mean = float((caug[:C][valid] ** 2).sum(1).mean())  # the size of a rank's terms
    worst = {}
    for bf16_rank in (False, True):
        got = centroid_scan.centroid_window_scan(caug, qaug, bf16_rank)
        want = centroid_scan.centroid_window_scan_plain(caug, qaug, bf16_rank)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), "window minima must be finite at d_pad 128"
        err = (got - want).abs()
        rel = float((err / (want.abs() + cn2_mean)).max())
        assert rel <= SCAN_RTOL, f"window scan bf16_rank={bf16_rank}: rel err {rel} > {SCAN_RTOL}"
        # Windows of C-padding rows hold ~1.3e38 sentinels; the absolute
        # error is reported over the windows whose minimum is a real rank.
        real = want.abs() < 1e30
        max_abs = float(err[real].max())
        ms = cuda_ms(torch, lambda: centroid_scan.centroid_window_scan(caug, qaug, bf16_rank), 10)
        plain_ms = cuda_ms(torch, lambda: centroid_scan.centroid_window_scan_plain(
            caug, qaug, bf16_rank), 3)
        tflops = 2 * Q * cpad * d_pad / (ms * 1e-3) / 1e12
        mode = "bf16" if bf16_rank else "f32"
        log(f"kernel centroid_scan: Q={Q} Cpad={cpad} d_pad={d_pad} rank={mode} "
            f"max_rel_err={rel:.3e} (of |rank| + mean |c|^2 = {cn2_mean:.1f}) "
            f"max_abs_err={max_abs:.3e} over {int(real.sum())} real window minima "
            f"(rtol {SCAN_RTOL}) kernel={ms:.4f} ms ({tflops:.2f} TFLOP/s) "
            f"plain={plain_ms:.4f} ms")
        worst[mode] = (max_abs, ms, plain_ms)
    # The large phase ranks in f32 (an int8 index routes on f32 centroids).
    _, ms, plain_ms = worst["f32"]
    report["centroid_scan"] = {"max_abs_err": max(w[0] for w in worst.values()), "ms": ms,
                               "plain_ms": plain_ms}


def kernel_rerank_int8(torch, report):
    """The quantized rerank at the large phase's shape, every metric."""
    from spfresh_tpu_torch.ops import rerank

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    Q, nprobe, pad, d_pad, cpad = 8192, 8, 336, 128, 43_264
    slabs = torch.randint(-127, 128, (cpad, pad, d_pad), generator=g, device=dev,
                          dtype=torch.int8)
    queries = torch.randn((Q, d_pad), generator=g, device=dev)
    rows = torch.randint(0, cpad, (Q, nprobe), generator=g, device=dev, dtype=torch.int32)
    scales = torch.rand((Q, nprobe), generator=g, device=dev) * 0.02 + 0.005
    qc = torch.randn((Q, nprobe, d_pad), generator=g, device=dev)
    kw = dict(scales=scales, centered_queries=qc)
    parts = []
    for metric in ("Euclidean", "Manhattan", "Chebyshev"):
        got = rerank.padded_rerank_distances(queries, rows, slabs, metric, **kw)
        want = rerank.padded_rerank_distances_plain(queries, rows, slabs, metric, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = float((err / want.abs().clamp_min(1.0)).max())
        assert rel <= RERANK_RTOL, f"rerank int8 {metric}: rel err {rel} > {RERANK_RTOL}"
        ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances(queries, rows, slabs, metric,
                                                                   **kw), 20)
        plain_ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances_plain(
            queries, rows, slabs, metric, **kw), 3)
        gbps = Q * nprobe * pad * d_pad / (ms * 1e-3) / 1e9
        log(f"kernel rerank_int8: Q={Q} nprobe={nprobe} pad={pad} d_pad={d_pad} Cpad={cpad} "
            f"{metric} max_rel_err={rel:.3e} max_abs_err={float(err.max()):.3e} "
            f"(rtol {RERANK_RTOL}) kernel={ms:.4f} ms ({gbps:.0f} GB/s slab reads) "
            f"plain={plain_ms:.4f} ms")
        parts.append((metric, float(err.max()), ms, plain_ms))
    # Times are the Euclidean ones, the metric the main path runs.
    report["rerank_int8"] = {"max_abs_err": max(p[1] for p in parts), "ms": parts[0][2],
                             "plain_ms": parts[0][3]}


def replica_compare(X, base, C, bt, ki, kr, pi, pr):
    """Kernel vs plain replica lists.  Ids must be identical except where
    a disagreement is a near-tie: an id in only one list must sit within
    TIE_TOL of the admission bound, the closure bound, or the other list's
    last kept rank (recomputed in f64); ranks of ids in both lists must
    agree within REPLICA_RTOL.  Returns (rows with a near-tie difference,
    max abs rank error, max rel rank error)."""
    kid = np.where(np.isfinite(kr), ki, -1)
    pid = np.where(np.isfinite(pr), pi, -1)
    fin = (kid >= 0) & (kid == pid)
    diff = (kr[fin] - pr[fin]).astype(np.float64)
    max_abs = float(np.abs(diff).max()) if diff.size else 0.0
    max_rel = float((np.abs(diff) / np.maximum(np.abs(pr[fin]), 1e-6)).max()) if diff.size else 0.0
    rows = np.nonzero((kid != pid).any(axis=1))[0]
    for p in rows:
        kd = {int(j): float(r) for j, r in zip(kid[p], kr[p]) if j >= 0}
        pd = {int(j): float(r) for j, r in zip(pid[p], pr[p]) if j >= 0}
        for j in set(kd) & set(pd):
            rel = abs(kd[j] - pd[j]) / max(abs(pd[j]), 1e-6)
            max_rel = max(max_rel, rel)
            max_abs = max(max_abs, abs(kd[j] - pd[j]))
        b = int(base[p])
        db = float(((X[p] - C[b]) ** 2).sum())
        for j in set(kd) ^ set(pd):
            D = float(((X[p] - C[j]) ** 2).sum())
            CC = float(((C[b] - C[j]) ** 2).sum())
            rank = kd.get(j, pd.get(j))
            other = pd if j in kd else kd
            last = max(other.values()) if len(other) == ki.shape[1] else None
            near = (abs(D - bt * db) <= TIE_TOL * max(bt * db, D, 1e-12)
                    or abs(CC - D) <= TIE_TOL * max(CC, D, 1e-12)
                    or (last is not None and abs(rank - last) <= TIE_TOL * max(last, 1e-12)))
            assert near, f"replica row {p}: id {j} differs without a near-tie"
    return len(rows), max_abs, max_rel


def best_qps(torch, index, queries, nprobe: int) -> float:
    """Queries per second of the best of 3 warm searches, host clock."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        s = time.perf_counter()
        index.search(queries, 10, nprobe=nprobe)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s)
    return len(queries) / min(times)


def sweep(torch, index, queries, gt, tag: str, target: float = 0.90):
    """nprobe sweep to recall@10 >= ``target``: (nprobe, recall, qps, ids)
    of the first point that clears it, or None."""
    from spfresh_tpu_torch.eval import recall_at_k

    for nprobe in (2, 4, 8, 16, 24, 32, 48, 64):
        ids, _ = index.search(queries, 10, nprobe=nprobe)  # warm
        rec = recall_at_k(ids, gt, 10)
        qps = best_qps(torch, index, queries, nprobe)
        log(f"{tag}: nprobe={nprobe} recall@10={rec:.4f} qps={qps:.1f} (best of 3)")
        if rec >= target:
            return nprobe, rec, qps, ids
    return None


def build_logged(torch, cfg, data, tag: str):
    """SpannIndexBuilder(...).build() and padded_view() on the card, timed,
    with the build's phases printed."""
    from spfresh_tpu_torch.index import SpannIndexBuilder

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = SpannIndexBuilder(cfg, device=DEVICE).with_data(data).build(save=False)
    t_pack = time.perf_counter()
    view = index.padded_view()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    phases = dict(index.build_profile)
    phases["view_pack"] = t1 - t_pack
    n = len(data)
    log(f"{tag}: build wall={t1 - t0:.3f} s clusters={index.num_clusters} "
        f"stored={index.num_vectors} (x{index.num_vectors / n:.4f}) "
        f"slabs={tuple(view.vectors3d.shape)} {view.vectors3d.dtype}")
    log(f"{tag}: build phases " + " ".join(
        f"{k}={v:.3f}" for k, v in sorted(phases.items(), key=lambda kv: -kv[1])))
    return index, view


def phase_main(torch, n: int, nq: int, report) -> None:
    from spfresh_tpu_torch.index import Config, brute_force_search
    from spfresh_tpu_torch.ops import rerank, replica
    from spfresh_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    data, queries = mixture(12345, n, nq)
    log(f"main: corpus n={n} d=128 nq={nq} made in {time.perf_counter() - t0:.2f} s (host)")
    with tempfile.TemporaryDirectory() as out:
        cfg = Config.from_dict({
            "clustering_params": {
                "distance_metric": "Euclidean", "initialization_method": "KMeans++",
                "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 42,
            },
            "output_path": out,
            "storage_dtype": "bfloat16",
            "search": {"query_batch_size": 8192},
        })
        metrics.DEFAULT.reset()
        rerank.launches = 0
        replica.launches = 0
        index, view = build_logged(torch, cfg, data, "main")

        t0 = time.perf_counter()
        _, gt = brute_force_search(data, queries, 10, device=DEVICE, batch_size=4096)
        log(f"main: exact ground truth on the card in {time.perf_counter() - t0:.2f} s")

        best = sweep(torch, index, queries, gt, "main")
        counts = {"rerank": rerank.launches, "replica": replica.launches}
        log(f"main: kernel launches in the main path {counts}; engines "
            f"{ {k: v for k, v in metrics.snapshot().items() if 'engine' in k} }")
        assert counts["rerank"] > 0 and counts["replica"] > 0, counts
        assert best is not None, "recall@10 >= 0.90 not reached within nprobe <= 64"
        nprobe, rec, qps, ids = best
        assert_no_duplicates(ids)
        log(f"main: recall point nprobe={nprobe} recall@10={rec:.4f} qps={qps:.1f}; "
            "no result row repeats an id")
        for name, c in counts.items():
            report[name]["launches"] = c
        profile_search(torch, index, queries, nprobe)


def phase_large(torch, n: int, nq: int, report) -> None:
    """The large-index path: an int8 build past 32,768 clusters, searched
    through the windowed centroid scan and the quantized rerank."""
    import copy
    import dataclasses

    from spfresh_tpu_torch.index import Config, brute_force_search
    from spfresh_tpu_torch.ops import centroid_scan, rerank, topk

    t0 = time.perf_counter()
    data, queries = mixture(12345, n, nq)
    log(f"large: corpus n={n} d=128 nq={nq} made in {time.perf_counter() - t0:.2f} s (host)")
    cfg = Config.from_dict({
        "clustering_params": {
            "distance_metric": "Euclidean", "initialization_method": "KMeans++",
            "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 42,
        },
        "storage_dtype": "int8",
        "search": {"query_batch_size": 8192},
    })
    centroid_scan.launches = 0
    rerank.quantized_launches = 0
    index, view = build_logged(torch, cfg, data, "large")
    assert index.num_clusters > topk.LARGE_C_THRESHOLD, (
        f"{index.num_clusters} clusters do not cross {topk.LARGE_C_THRESHOLD}")

    t0 = time.perf_counter()
    _, gt = brute_force_search(data, queries, 10, device=DEVICE, batch_size=4096)
    log(f"large: exact ground truth on the card in {time.perf_counter() - t0:.2f} s")

    best = sweep(torch, index, queries, gt, "large", target=LARGE_RECALL_TARGET)
    counts = {"centroid_scan": centroid_scan.launches, "rerank_int8": rerank.quantized_launches}
    log(f"large: kernel launches in the large path {counts}")
    assert counts["centroid_scan"] > 0 and counts["rerank_int8"] > 0, counts
    assert best is not None, (
        f"large: recall@10 >= {LARGE_RECALL_TARGET} not reached within nprobe <= 64")
    nprobe, rec, qps, ids = best
    assert_no_duplicates(ids)
    log(f"large: recall point nprobe={nprobe} recall@10={rec:.4f} qps={qps:.1f}; "
        "no result row repeats an id")
    for name, c in counts.items():
        report[name]["launches"] = c

    # Stage 1 through the dense (Q, C) scan instead of the windowed one:
    # both are exact, so the search ids agree up to near-ties.
    threshold = topk.LARGE_C_THRESHOLD
    topk.LARGE_C_THRESHOLD = index.num_clusters + view.centroids.shape[0]
    try:
        dense, _ = index.search(queries, 10, nprobe=nprobe)
    finally:
        topk.LARGE_C_THRESHOLD = threshold
    differ = int((dense != ids).sum())
    log(f"large: nprobe={nprobe} ids through the dense stage 1 vs the windowed one: "
        f"{differ} of {ids.size} differ")
    assert differ <= ids.size // 1000, f"{differ} of {ids.size} ids differ from the dense route"

    # The same view on the CPU, searched with the plain versions.
    cpu = copy.copy(index)
    cpu.device = torch.device("cpu")
    cpu._padded_view = dataclasses.replace(view, **{
        f.name: getattr(view, f.name).cpu() for f in dataclasses.fields(view)
        if isinstance(getattr(view, f.name), torch.Tensor)})
    t0 = time.perf_counter()
    want, _ = cpu.search(queries[:1000], 10, nprobe=nprobe)
    differ = int((ids[:1000] != want).sum())
    log(f"large: nprobe={nprobe} ids of 1,000 queries vs the same view on the CPU (plain "
        f"versions, {time.perf_counter() - t0:.1f} s): {differ} of {want.size} differ")
    assert differ <= want.size // 1000, f"{differ} of {want.size} ids differ from the CPU path"
    del cpu, want
    profile_search(torch, index, queries, nprobe, tag="profile large")
    compare_bf16(torch, cfg, data, queries, gt, index, (nprobe, 2 * nprobe))


def compare_bf16(torch, cfg, data, queries, gt, index8, nprobes) -> None:
    """int8 against bf16 storage on the same corpus: a bf16 build (its
    clusters are the int8 build's, since both cluster the bf16-rounded
    corpus), then searches in the turns int8, bf16, bf16, int8 at each
    nprobe, QPS best of 3 per turn."""
    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import Config

    raw = cfg.to_dict()
    raw["storage_dtype"] = "bfloat16"
    index16, _ = build_logged(torch, Config.from_dict(raw), data, "large bf16")
    assert index16.num_clusters == index8.num_clusters
    indexes = {"int8": index8, "bf16": index16}
    for nprobe in nprobes:
        rec = {k: recall_at_k(ix.search(queries, 10, nprobe=nprobe)[0], gt, 10)
               for k, ix in indexes.items()}
        qps = {"int8": [], "bf16": []}
        for k in ("int8", "bf16", "bf16", "int8"):
            qps[k].append(best_qps(torch, indexes[k], queries, nprobe))
        log(f"large int8 vs bf16: nprobe={nprobe} " + " ".join(
            f"{k} recall@10={rec[k]:.4f} qps={q[0]:.1f}/{q[1]:.1f}" for k, q in qps.items()))


def profile_search(torch, index, queries, nprobe: int, top: int = 10,
                   tag: str = "profile") -> None:
    """Device time of 3 warm searches at the recall point, by operation.
    Kernels launched inside an aten op count under that op's name; the
    ctypes-launched kernels (under no op) under their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        for _ in range(3):
            index.search(queries, 10, nprobe=nprobe)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    assert device_ms > 0, "the profiler saw no device time"
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    rows += [(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels
             if "rerank_kernel<" in e.key or "window_scan_kernel<" in e.key]
    log(f"{tag}: nprobe={nprobe}, 3 searches of {len(queries)} queries: wall={wall_ms:.1f} ms "
        f"device={device_ms:.1f} ms (idle {100 * (1 - device_ms / wall_ms):.1f}% of wall)")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"{tag}:   {ms:8.2f} ms {100 * ms / device_ms:5.1f}%  x{count}  {name[:80]}")


def assert_no_duplicates(ids: np.ndarray) -> None:
    s = np.sort(ids, axis=1)
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    assert not dup.any(), f"{int(dup.any(axis=1).sum())} result rows repeat an id"


def phase_exact(torch) -> None:
    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import Config, SpannIndex, SpannIndexBuilder, brute_force_search

    data, queries = mixture(7, 20_000, 200)
    cfg = Config.from_dict({
        "clustering_params": {"initialization_method": "KMeans++", "initial_k": 16,
                              "desired_cluster_size": 256, "rng_seed": 3},
        "storage_dtype": "float32",
    })
    index = SpannIndexBuilder(cfg, device=DEVICE).with_data(data).build(save=False)
    ids, _ = index.search(queries, 10, nprobe=index.num_clusters)
    _, gt = brute_force_search(data, queries, 10, device=DEVICE)
    rec = recall_at_k(ids, gt, 10)
    assert rec == 1.0, f"full-probe recall {rec} != 1.0"
    assert_no_duplicates(ids)
    # The same index saved, loaded on the CPU and searched with the plain
    # versions: the CUDA pipeline must return the same ids, up to near-ties
    # from f32 summation order (a probe or a rank flipping at equal values).
    with tempfile.TemporaryDirectory() as out:
        index.save(out)
        cpu = SpannIndex.load(out, device="cpu")
    got, _ = index.search(queries, 10, nprobe=8)
    want, _ = cpu.search(queries, 10, nprobe=8)
    differ = int((got != want).sum())
    assert differ <= got.size // 1000, f"{differ} of {got.size} ids differ from the CPU path"
    log(f"exact: n=20000 f32 clusters={index.num_clusters} full-probe recall@10={rec} "
        f"(200 queries, no pruning); nprobe=8 ids vs the saved index on the CPU: "
        f"{differ} of {got.size} differ")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on a GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {smi}")
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count={torch.cuda.device_count()}")

    from spfresh_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"build: {len(_build.sources())} sources -> {path.name} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])})")

    assert not torch.backends.cuda.matmul.allow_tf32, "plain versions must not run in TF32"
    report = {}
    phase_kernels(torch, report)
    phase_main(torch, 1_000_000, 16_384, report)
    phase_large(torch, LARGE_N, 16_384, report)
    phase_exact(torch)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         **{k: report[name][k] for k in ("launches", "max_abs_err", "ms", "plain_ms")}}
        for name in REPLACES
    ]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
