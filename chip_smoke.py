#!/usr/bin/env python3
"""Drive the spfresh_tpu_torch main paths once on one CUDA card.

    python3 chip_smoke.py            # all phases, one card, exits 0 on success

Phases, each printing a line:

1. device   — require CUDA; print nvidia-smi's name and power limit.
2. build    — compile csrc/*.cu with nvcc for sm_90a, one nvcc per source,
              all at once (cached in build/kernels/).
3. kernels  — each kernel against its plain PyTorch version on the card at
              the shapes its path gives it, with CUDA-event times for both;
              the replica and nearest-centroid kernels also on small inputs
              of every route (SMALL_CASES: f32 and bf16, d 5 to 960, SOAR
              on and off, n_extra 1 to 8, db given and computed, centroids
              near points), and beside each the cuBLAS time of its
              products alone (gemm_ms, a yardstick the port never calls);
              the slab rerank also at its edges (d_pad 16, 32, 112 and 1,024,
              f32, bf16 and int8, every metric, a pad no tile divides and
              one that wraps the ring, one slab under 4,096 pairs, one
              pair, out-of-range rows giving NaN rows), and its slab-major
              schedule on the card against its CPU form; the window scan in
              both rank modes at SCAN_CASES (large's and outofcore's stage-1
              shapes, Q 64, d_pad 1,024, Q 1 and 8,229; an all-invalid
              window), with the cuBLAS product alone and its tensor-core
              bound where timed; the expansion-form
              int8 scorer (rerank_int8mxu) at benchmarks/rerank_bench.py's
              shape, bit-equal to its plain version, with its schedule
              timed alone, and at its edges (d 16 to 4,096 at pads 4 to
              2,052, one to three column passes; one slab under 4,096
              pairs, one pair, slabs of equal rows, out-of-range rows
              giving NaN rows; unaligned code tables raise); the row
              select (topk_select) bit-equal to its plain version at
              TOPK_CASES (the search's shapes, ties, +-0, +-inf, NaNs,
              k = n, long rows), timed against torch.topk on the values.
4. main     — the bench corpus (1M x 128 Gaussian mixture, seed 12345), a
              KMeans++ bf16 build through SpannIndexBuilder on "cuda",
              padded_view(), exact ground truth on the card, and an nprobe
              sweep to recall@10 >= 0.90; asserts the rerank and replica
              kernels ran in it; then device time by operation
              (torch.profiler) over 3 searches at the recall point, the
              rerank on the phase's own stage-1 rows, one search's
              row-select launches (3 a batch; no profiled search runs
              aten::topk), and a full-probe
              search of 8,192 queries in one batch (the probe axis taken
              in chunks; peak memory logged) whose first 64 rows must equal
              an unchunked search.
5. examples — the seven example CLIs (spfresh_tpu_torch.examples) in this
              process with --device cuda, each one's stdout and wall logged:
              build_index then load_index in a temporary working directory
              (point_id 0 both times), live_updates (a posting split, the
              hot-spot inserts found), disk_updates (the self-query returns
              0 after compact()), quantized_index (float32 and int8),
              sharded_search (8 entries of the card: self-NN exact, the
              in-place insert found), then sift_eval at main's scale through
              files: main's corpus, 1,024 of its queries and their exact top
              10 written as fvecs/ivecs with the port's writers and read by
              the native reader, built with main's config (cluster size 256,
              initial_k 16, bf16).  Gates: every contract above, sift_eval's
              clusters equal main's (0 differ), its ids at nprobe 32 equal
              main's index's up to f64 ties and its printed recall theirs,
              that recall at least main's at its recall point, and the float
              rerank, the int8 rerank and the replica kernel launched in the
              phase.  Every launch of those kernels in the phase is recorded
              (its inputs copied at the call); after the counts are read,
              each recorded call under 64 MiB of inputs (all but sift_eval's,
              which run main's shapes, held in `kernels` and `main`) runs
              again against its plain version: the rerank within
              RERANK_RTOL, the replica lists by replica_compare.
6. shardbuild — the build over a device list of 4 entries, every one cuda:0
              (spfresh_tpu_torch.parallel): main's corpus and config built
              in-core in both corpus layouts (sharded: a quarter of the rows
              an entry; replicated: a copy on each, the first handed to the
              view pack), with main's clusters and its recall; binary
              (max_split_ways 2) and nested builds of main's corpus, f32
              storage (nested at SpannIndexBuilder's default cap,
              0.18 n, and initial_k 4: at main's cap of 256 nested replicas
              compound with depth), each on one device twice and over the
              list, all three equal, every point placed, nested postings
              within the cap, full-probe recall@10 exactly 1.0 on 1,000
              queries; main's corpus out-of-core (sample 262,144, 8 tiles of
              131,072) over the list equal to one device, the
              nearest-centroid and replica kernels launched on every tile;
              65,536 rows of manhattan's corpus over the list equal to one
              device, the L1/Linf kernel launched.  Each device-list build
              logs its wall, launches and build phases beside main's.  Each
              kernel is also held to its plain version at the shapes the
              phase launches it: the replica kernel at a shard's (250,000
              rows of main's corpus, main's centroids, db computed) and at
              an out-of-core tile's (db given), the nearest-centroid kernel
              at that tile against the sample fit's centroids, the L1/Linf
              kernel on a Manhattan shard's assign block and its replica
              pass's first row block.
7. disk     — main's index saved packed under build/ (deleted after) and
              served from disk by LazySpannIndex on the card: the centroid
              matrix on the device, each batch's unique probed slabs staged
              by the native reader, cast to bf16 on the host and reranked
              by the float rerank kernel.  16,384 queries at main's nprobe,
              timed at batch 64 with prefetch 2 and at batch 1,024, and
              4,096 of them at batch 64 with prefetch 0.
              Gates: the kernel launched, no repeated id, recall@10 within
              0.01 of the in-memory search, prefetch 0 and 2 equal, 1,000
              queries' ids against the directory opened on the CPU, and
              the search's peak device memory under an eighth of the
              in-memory view's slab bytes.  Then LazySpFreshIndex on the
              directory: 10,000 inserts in 512-batches (each then
              searched), 4,096 hot-spot inserts (Split and Reassign run),
              5,000 deletes and the hot spot's, flush(); gates: every
              surviving insert in its own top 10, or its miss shown in
              f64 to be a routing near-tie (as in live) or routed away (a
              merge or split moved its home centroid past the nprobe-th
              nearest; a full-probe search must still find it), no
              deleted or repeated id, Split and Reassign ran; with the
              pipeline then stopped, a close and reopen (WAL replay) and
              a compact() leave the same live postings and the same ids
              (up to f64 ties, tie_explained); recall before and after
              against brute force on the mutated corpus.
8. live     — live updates on main's index through
              spfresh_tpu_torch.lire.SpFreshIndex (LireConfig max 512, min
              16, a store under build/ deleted after): benchmarks/
              streaming_updates.py's traffic (20,000 inserts in batches of
              512; 20,000 more, each batch then searched; deletes) plus
              4,096 hot-spot inserts around one corpus point, so Split,
              Reassign and Merge all run; flush().  Gates: the in-place
              view searches as a full repack does (16,384 queries, nprobe
              8), append and slab-rewrite updates and every LIRE op ran,
              each surviving insert finds itself in its top 10, no deleted
              or repeated id; recall before and after against brute force
              on the mutated corpus.  Then 5,000 inserts and 2,000 deletes
              on a 262,144-row int8 index and the same repack gate.
9. sharded  — multi-device serving: main's index as live left it in a
              ShardedSpannIndex, 4 shards on cuda:0 when the card is alone
              (one shard a card otherwise), batch 8,192.  Global nprobe at
              main's recall point on 16,384 queries: the rerank launched
              once per shard and batch, search.engine.cuda counted,
              |recall@10 - the single index's| <= 0.002 (against exact
              ground truth of the index's live points), per_shard recall at
              least global's; QPS of both modes and of the single index,
              the view's bytes, the search's peak device memory and its
              device time by operation (torch.profiler).  At
              full probe (4,096 queries, without and with pruning 1.2) the
              ids equal the single index's, and 1,000 queries' ids those of
              the same shards on the CPU (plain versions), each up to f64
              ties (sharded_ties).  Then 10,000 inserts in 512-batches, each
              then searched, and 2,000 deletes through live's SpFreshIndex
              (its store deleted after): the view refreshes in place
              (appends and slab rewrites, no full repack), and its ids equal
              a freshly packed ShardedSpannIndex's up to f64 ties, with no
              deleted id, while the single-device view did not refresh
              (both count under view.*).  Last, live's int8 index in 4
              shards: the quantized rerank per shard, recall within 0.002
              of the single index at nprobe 8, and 1,000 queries' ids equal
              to the same shards on the CPU up to f64 ties on the
              dequantized rows, with the distances of rows of equal ids
              within RERANK_RTOL.
10. fuzz    — the JAX package's model fuzzers on the card (their CPU twins
              are tests/test_torch_*_fuzz.py and test_torch_concurrent_stress.py):
              the view-update fuzz at its test size (seeds 0, 1, 3 x float32,
              bfloat16, int8: 40 random appends, rewrites, shrinks, new and
              removed postings and centroid moves; every 6th, full-probe and
              nprobe-2 searches of the in-place view give a fresh pack's
              result sets and distances; under int8 the view's host scales
              equal its device scales after every step) and at 100,000 x 128
              of main's config (2,000 mutations, a full-probe check of 256
              queries every 250, then nprobe 8 on 1,024 queries with equal
              ids); SpFreshIndex and LazySpFreshIndex (with compact and
              reopen) model fuzz, seeds 0, 1 x float32, int8, 150 steps:
              after every flush the live set, the stored vectors (and the
              RAM tier's search mirror) equal a dict model's, no deleted vid
              is back, full-probe self-queries hit; the concurrent stress
              on both tiers for 5 s each (searchers, a mutator, and on disk
              a compactor thread).  Every rerank and replica launch of the
              phase is recorded and held to its plain version afterwards.
11. large   — the same generator at 4,194,304 x 128 (4,194 centers) with
              int8 (IVF-SQ8) storage: more than 32,768 clusters, so stage 1
              takes the windowed centroid scan and the rerank its quantized
              path; ground truth, the nprobe sweep to recall@10 >= 0.80
              (LARGE_RECALL_TARGET), both new kernels launched in the
              phase, the ids through the dense stage 1 and of 1,000
              queries against the same view searched on the CPU with the
              plain versions, the device-time breakdown, and int8 against
              a bf16 build of the same corpus.  The expansion-form int8
              scorer (rerank_int8mxu) then scores the phase's queries over
              the phase's own int8 view (codes transposed to (C, d_pad,
              pad)), is held to its plain version, and its top-10 per query
              is compared with the elementwise int8 rerank's.  The int8
              rerank is also held to its plain version on the phase's own
              windowed stage-1 rows, centered queries and scales.  The
              index is then saved packed and searched lazily on the card
              (window scan and quantized rerank launched, recall within
              0.01 of the in-memory search, 1,000 queries against the CPU).
12. manhattan — bench.py's --latent-dim 32 generator at GIST width (n 1M,
              d 960, 16,384 queries, seed 12345), a Manhattan bf16 build:
              the L1/Linf pairwise kernel runs the build's assignments,
              the closure pass, stage 1 and the ground truth; the sweep
              to recall@10 >= 0.90, the bf16 rerank against its plain
              version on the phase's slabs (d_pad 1,024) and stage-1 rows,
              and the device-time breakdown.
13. chebyshev — the same generator at 262,144 x 960 with Chebyshev; the
              sweep is printed (no target: Chebyshev plateaus on this data)
              and the rerank checked on the phase's slabs at nprobe 48.
14. outofcore — benchmarks/outofcore_build_bench.py's corpus (4,194,304 x 96,
              a memmap under build/) built out-of-core through
              Config.build_sample_rows (sample 1,048,576, tile 262,144, cap
              256, bf16): one nearest-centroid launch per tile, the replica
              kernel with db supplied; the budget invariants, both kernels
              against their plain versions on the build's first tile (the
              nearest centroid with the sample fit's centroids, the replica
              top-k with db supplied and the final centroids), a sweep of
              16,384 queries through the windowed stage 1, then the index
              saved packed, the in-memory index and view released, and the
              queries served from disk at nprobe 8 (prefetch 2; 4,096
              queries with prefetch 0):
              window scan and float rerank launched, recall within 0.01 of
              the in-memory search, 1,000 queries against the CPU, peak
              device memory under an eighth of the view's slab bytes.
15. exact   — a 20k f32 index: full-probe search must have recall exactly 1.0
              (Euclidean; Manhattan and Chebyshev at d 960, where a miss is
              allowed only as a tie, shown in f64).

Any failure raises, so the exit code is non-zero.  The last three lines are
the card's name and power limit, the kernel report and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import logging
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
    "pairwise": "spfresh_tpu/ops/pallas/pairwise.py:58",
    "nearest_centroid": "spfresh_tpu/ops/pallas/replica.py:347",
    "rerank_int8mxu": "spfresh_tpu/ops/pallas/rerank.py:376",
    "topk_select": "none (lax.top_k, spfresh_tpu/ops/topk.py::smallest_k)",
}
SOURCES = {
    "rerank": "spfresh_tpu_torch/csrc/rerank.cu",
    "replica": "spfresh_tpu_torch/csrc/replica.cu",
    "centroid_scan": "spfresh_tpu_torch/csrc/centroid_scan.cu",
    "rerank_int8": "spfresh_tpu_torch/csrc/rerank.cu",
    "pairwise": "spfresh_tpu_torch/csrc/pairwise.cu",
    "nearest_centroid": "spfresh_tpu_torch/csrc/replica.cu",
    "rerank_int8mxu": "spfresh_tpu_torch/csrc/rerank_int8mxu.cu",
    "topk_select": "spfresh_tpu_torch/csrc/topk_select.cu",
}
# The card's published peaks (H100 SXM data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM_BPS and its operations over the
# peak of their type.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12    # CUDA cores
BF16_FLOPS = 989e12  # tensor cores
TF32_FLOPS = 495e12  # tensor cores, TF32
INT8_OPS = 1979e12   # tensor cores, dense int8
PAIRWISE_RTOL, PAIRWISE_ATOL = 1e-5, 1e-4  # tests/test_pallas_pairwise.py: L1 sum order
GIST_D, GIST_LATENT = 960, 32
# n cut from the bench's 20M for the time limit: 4,194,304 rows once the
# command passes ~1,000 s (the disk phase's hot-spot drain varies by minutes).
OC_N, OC_D, OC_SAMPLE, OC_TILE = 4_194_304, 96, 1_048_576, 262_144
OC_NPROBE = 8  # the out-of-core phase's serving point
RERANK_RTOL = 1e-5   # f32 sums of 128 terms in another order
REPLICA_RTOL = 1e-4  # expansion-form ranks, f32, another summation order
# Nearest-centroid distances |x|^2 + |c|^2 - 2 x.c: f32 sums of d products in
# another order, so the error is relative to |x|^2 + |c|^2, not to D.
NEAREST_RTOL = 1e-5
# Window-minimum ranks |c|^2 - 2 q.c: f32 sums of 128 products in another
# order.  A rank is a difference of terms of the size of |c|^2, so its
# error is relative to that size, not to the (possibly cancelled) rank.
SCAN_RTOL = 1e-5
# The window scan's checks: (name, Q, C, d).  `large`'s stage-1 shape
# (Cpad 44,032), `outofcore`'s (Cpad 54,272, d_pad 128), the disk tier's
# batch of 64, a GIST-width index (d_pad 1,024) and the edges of Q.  Every
# case runs both rank modes with window 1 and every 997th row invalid.
SCAN_CASES = (("large", 8192, 43_300, 128), ("outofcore", 8192, 53_898, 96),
              ("q64", 64, 43_300, 128), ("d1024", 8192, 43_300, 960),
              ("q1", 1, 43_300, 128), ("q8229", 8192 + 37, 43_300, 128))
SCAN_TIMED = ("large", "outofcore", "q64", "d1024")  # the cases timed
# The row select's checks: (name, rows, n, k, rows' kind).  The search's
# shapes (stage 1 at main's 11,008 postings and a 64-query batch, the dedup
# prefilter of k 10 x max_dup 8 and 16, its final select, the windowed
# route's window minima and centroids, a chunked-route row, a corpus-wide
# row), then the orders' hazards: full probe (k = n, rounds of ranks), rows
# of ties (the column passes), -0.0/+0.0, +-inf and NaNs of both signs,
# k = n, k = 1, one column, long rows in tiles and in rounds, and a long
# row whose tiles' selections would not fit (read from global memory).
# brute_force_search's two-stage rows take tiles too.
TOPK_CASES = (("stage1", 8192, 11_008, 8, "centroids"), ("stage1_q64", 64, 11_008, 8, "centroids"),
              ("prefilter80", 8192, 2688, 80, "candidates"),
              ("prefilter160", 8192, 2688, 160, "candidates"),
              ("final", 8192, 160, 10, "candidates"),
              ("window_minima", 8192, 344, 16, "centroids"),
              ("window_centroids", 8192, 2048, 8, "centroids"),
              ("chunked", 8192, 8 + 8192, 8, "centroids"),
              ("corpus_row", 16, 1_000_000, 100, "centroids"),
              ("brute_two_stage", 1024, 320 + 65_536, 320, "centroids"),
              ("full_probe", 512, 11_008, 11_008, "centroids"),
              ("ties", 1024, 11_008, 8, "ties"), ("ties_warp", 4096, 700, 40, "ties"),
              ("specials", 4096, 3000, 50, "specials"), ("specials_k_n", 64, 300, 300, "specials"),
              ("specials_k1", 4096, 500, 1, "specials"), ("one_column", 64, 1, 1, "specials"),
              ("long_rounds", 8, 40_000, 5000, "ties"), ("long_stream", 8, 40_000, 20_000, "ties"))
TOPK_TIMED = ("stage1", "stage1_q64", "prefilter80", "prefilter160", "final", "window_minima",
              "window_centroids", "chunked", "corpus_row", "brute_two_stage")
# The shardbuild phase: a device list of 4 entries (cuda:0 repeated); the
# binary and nested builds on main's corpus; the out-of-core build of main's
# corpus in 8 tiles; 65,536 rows of manhattan's.
SB_ENTRIES, SB_L1_N = 4, 65_536
SB_DEVICES = ["cuda:0"] * SB_ENTRIES
SB_OC_SAMPLE, SB_OC_TILE = 262_144, 131_072
LARGE_N = 4_194_304  # the smallest power of two whose build crosses 32,768 clusters
# The large phase's recall target.  On this corpus the hierarchical build's
# probe recall falls with n in both packages (tests/test_torch_build_quality.py
# run as a script): at 4M no nprobe <= 64 reaches 0.90, so the phase's
# operating point is the first nprobe at recall@10 >= 0.80.
LARGE_RECALL_TARGET = 0.80
TIE_TOL = 1e-4       # relative gap under which two ranks or bounds count as tied
# The expansion-form scorer against its plain version
# (tests/test_pallas_rerank.py): exact dots, the combine within an ulp.
MXU_RTOL, MXU_ATOL = 3e-7, 1e-3
LIVE_STORE = "live_store"  # under build/, deleted after the phase
# Packed saves the disk tier serves, under build/, each deleted after its phase.
DISK_STORE, LARGE_STORE, OC_STORE = "disk_index", "large_index", "oc_index"
PHASE_T0 = [0.0]  # the disk phase's start, for the seconds its lines carry
# Queries of the lazy timings that only give a rate (prefetch 0), so the
# added searches stay inside the run's time.
TIMING_NQ = 4096
SIFT_NQ = 1024  # main's queries that the examples phase's sift_eval reads from a file
EXAMPLES = ("build_index", "load_index", "live_updates", "disk_updates", "quantized_index",
            "sharded_search", "sift_eval")
# The fuzz phase: tests/test_view_update_fuzz.py's seeds (3 caught the int8
# append-scale divergence), its real-size case, the model fuzzers' depth
# and the concurrent stress's wall a tier.
FUZZ_SEEDS = (0, 1, 3)
FUZZ_REAL_N, FUZZ_REAL_STEPS, FUZZ_REAL_EVERY = 100_000, 2_000, 250
MODEL_FUZZ_STEPS = 150
FUZZ_STRESS_WALL = 5.0
FUZZ_STORE = "fuzz"  # under build/, deleted after the phase
# The real-size view is ~110 MiB of bf16 slabs; every launch of the phase is
# recorded and held against its plain version.
FUZZ_RECORD_MAX_BYTES = 512 * 2**20
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


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM_BPS and the
    operations over ``peak``, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gemm_ms(torch, ops, C, iters: int) -> float:
    """cuBLAS time of a kernel's products alone: each (n, d) bf16 operand
    times C^T by torch.matmul in 16,384-row chunks into a bf16 buffer.  A
    yardstick of what the tensor cores reach on the shape; the port never
    calls it."""
    chunk = 16384
    out = torch.empty((chunk, C.shape[0]), dtype=torch.bfloat16, device=C.device)
    Ct = C.T

    def run():
        for A in ops:
            for s in range(0, A.shape[0], chunk):
                a = A[s : s + chunk]
                torch.matmul(a, Ct, out=out[: a.shape[0]])

    return cuda_ms(torch, run, iters)


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


def latent_mixture(seed: int, n: int, nq: int, d: int = GIST_D, latent: int = GIST_LATENT,
                   spread: float = 0.7):
    """bench.py's --latent-dim corpus (bench.py:305-327): a mixture of
    max(64, n // 1000) centers in ``latent`` dimensions, embedded into d
    by a fixed projection, plus 0.01 ambient noise; queries from the same
    mixture.  The same expressions, so the same arrays for the same seed."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, n // 1000)
    proj = rng.standard_normal((latent, d)).astype(np.float32) / np.sqrt(latent)
    centers = rng.standard_normal((n_centers, latent)).astype(np.float32)

    def draw(m):
        a = rng.integers(0, n_centers, size=m)
        lat = centers[a] + spread * rng.standard_normal((m, latent))
        amb = 0.01 * rng.standard_normal((m, d))
        return (lat.astype(np.float32) @ proj + amb).astype(np.float32)

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
    # Bytes: the slabs these rows probe, each read once, queries, rows and
    # the output; operations: subtract, multiply, add per slab element.
    probed = int(torch.unique(rows).numel())
    nbytes = probed * pad * d_pad * 2 + Q * d_pad * 4 + Q * nprobe * 4 + Q * nprobe * pad * 4
    log(f"kernel rerank: the rows probe {probed} of {cpad} slabs; "
        f"{schedule_stats(torch, rows, cpad)}")
    report["rerank"] = {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
                        "library_ms": None,
                        **bound(nbytes, 3 * Q * nprobe * pad * d_pad, F32_FLOPS)}
    del slabs, got, want, err
    rerank_edge_cases(torch)

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
        cents.float().cpu().numpy().astype(np.float64), bt, ki, kr, pi, pr, lam)
    admitted = int(np.isfinite(kr).sum())
    assert admitted > n // 10, f"only {admitted} replicas admitted: degenerate check"
    ms = cuda_ms(torch, lambda: replica.replica_topk(X, base, cents, bt, n_extra,
                                                     soar_lambda=lam), 5)
    plain_ms = cuda_ms(torch, lambda: replica.replica_topk_plain(X, base, cents, bt, n_extra,
                                                                 soar_lambda=lam), 2)
    tflops = 4 * n * C * d / (ms * 1e-3) / 1e12
    g_ms = gemm_ms(torch, [X, cents[base.long()]], cents, 5)
    # Two dot products per (point, centroid) pair on bf16 inputs.
    b = bound((n + C) * d * 2 + n * 4 + n * n_extra * 8, 4 * n * C * d, BF16_FLOPS)
    log(f"kernel replica: n={n} C={C} d={d} bf16 n_extra={n_extra} lambda={lam} "
        f"admitted={admitted} near_tie_rows={tie_rows} max_rank_rel_err={max_rel:.3e} "
        f"max_rank_abs_err={max_abs:.3e} (rtol {REPLICA_RTOL}) kernel={ms:.4f} ms "
        f"({tflops:.2f} TFLOP/s) plain={plain_ms:.4f} ms gemm_ms={g_ms:.4f} "
        f"bound={b['bound_ms']:.4f} ms")
    # The out-of-core tile (kernel_replica_tile) replaces the times with the
    # path's shape, and phase_outofcore the launches with that path's; the
    # error stays the worst of every check.
    report["replica"] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": None, **b}
    del X, cents, base
    replica_small_checks(torch, report)

    kernel_centroid_scan(torch, report)
    kernel_rerank_int8(torch, report)
    kernel_pairwise(torch, report)
    kernel_int8mxu(torch, report)
    int8mxu_edge_cases(torch)
    kernel_topk_select(torch, report)


def schedule_stats(torch, rows, cpad: int) -> str:
    """How the rerank's slab-major schedule groups ``rows``: the slabs they
    probe, the pairs per probed slab (mean, largest) and the work items.
    Asserts that the counting sort on the card gives the CPU form's items
    and totals, and the same slab at every position of a permutation of
    the pairs (a slab's pairs may come in another order)."""
    from spfresh_tpu_torch.ops import rerank

    group = rerank.kernel_geometry(128, torch.bfloat16)["group"]
    order, items, totals = rerank.rerank_schedule(rows, cpad, group)
    want = rerank.rerank_schedule(rows.cpu(), cpad, group)
    n_items = int(totals[0])
    assert torch.equal(totals.cpu(), want[2]), f"schedule totals {totals} != {want[2]}"
    assert torch.equal(items[:n_items].cpu(), want[1][:n_items]), "schedule items differ"
    flat = rows.reshape(-1).long()
    key = torch.where((flat < 0) | (flat >= cpad), cpad, flat)
    assert torch.equal(torch.sort(order).values.cpu(), torch.arange(flat.numel(), dtype=torch.int32))
    assert torch.equal(key[order.long()].cpu(), key.cpu()[want[0].long()]), "schedule order differs"
    _, per = torch.unique(flat[key < cpad], return_counts=True)
    return (f"{per.numel()} slabs probed, pairs per probed slab mean "
            f"{float(per.float().mean()):.2f} largest {int(per.max())}; {n_items} work items "
            f"of <= {group} pairs (mean {int(per.sum()) / max(1, n_items):.2f})")


def rerank_compare(torch, queries, rows, slabs, metric: str, **kw) -> tuple:
    """(max relative error, max absolute error) of the rerank kernel against
    its plain version on the same inputs; out-of-range rows must give NaN
    rows on the card and are left out of the comparison."""
    from spfresh_tpu_torch.ops import rerank

    cpad = slabs.shape[0]
    bad = (rows < 0) | (rows >= cpad)
    got = rerank.padded_rerank_distances(queries, rows, slabs, metric, **kw)
    want = rerank.padded_rerank_distances_plain(queries, torch.where(bad, 0, rows), slabs,
                                                metric, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[bad]).all()), "an out-of-range row did not give NaN"
    got, want = got[~bad], want[~bad]
    assert bool(torch.isfinite(got).all()), "the kernel left a non-finite distance"
    err = (got - want).abs()
    if err.numel() == 0:
        return 0.0, 0.0
    return float((err / want.abs().clamp_min(1.0)).max()), float(err.max())


def rerank_edge_cases(torch) -> None:
    """The rerank (float and int8 cases) against its plain version where the
    schedule and the tile ring have edges, within RERANK_RTOL: d_pad 16,
    32 (the disk tier's at d 32), 112 and 1,024 for f32, bf16 and int8 slabs and every metric, at a pad
    that no row tile divides (37) and one that wraps the ring (1,100);
    d_pad 1,536, 2,048 and 4,096 (rows taken in column slices) at pads 37
    and 300; every pair on one slab (many work items for one slab); one
    pair; and out-of-range rows, which must give NaN rows."""
    from spfresh_tpu_torch.ops import rerank

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(2)

    def inputs(Q, nprobe, cpad, pad, d_pad, sd, rows=None):
        if sd == torch.int8:  # every byte value, -128 too
            slabs = torch.randint(-128, 128, (cpad, pad, d_pad), generator=g, device=dev,
                                  dtype=torch.int8)
        else:
            slabs = torch.randn((cpad, pad, d_pad), generator=g, device=dev).to(sd)
        q = torch.randn((Q, d_pad), generator=g, device=dev)
        if rows is None:
            rows = torch.randint(0, cpad, (Q, nprobe), generator=g, device=dev,
                                 dtype=torch.int32)
        kw = {}
        if sd == torch.int8:
            kw = dict(scales=torch.rand(rows.shape, generator=g, device=dev) * 0.02 + 0.005,
                      centered_queries=torch.randn((*rows.shape, d_pad), generator=g,
                                                   device=dev))
        return q, rows, slabs, kw

    worst, n = 0.0, 0
    for d_pad, pads in ((16, (37, 1100)), (32, (37, 1100)), (112, (37, 1100)),
                        (1024, (37, 1100)),
                        (1536, (37, 300)), (2048, (37, 300)), (4096, (37, 300))):
        for sd in (torch.float32, torch.bfloat16, torch.int8):
            geo = rerank.kernel_geometry(d_pad, sd)
            for pad in pads:
                q, rows, slabs, kw = inputs(40, 5, 24, pad, d_pad, sd)
                for metric in ("Euclidean", "Manhattan", "Chebyshev"):
                    rel, _ = rerank_compare(torch, q, rows, slabs, metric, **kw)
                    assert rel <= RERANK_RTOL, (
                        f"rerank edge d_pad={d_pad} {sd} pad={pad} {metric}: rel err {rel}")
                    worst, n = max(worst, rel), n + 1
            log(f"kernel rerank edges: d_pad={d_pad} {sd} geometry {geo}")
    # The widest single-slice geometry again, after narrower ones of the
    # same kernels: its launch set-up is cached and must still hold.
    for sd in (torch.float32, torch.bfloat16, torch.int8):
        q, rows, slabs, kw = inputs(40, 5, 24, 37, 1024, sd)
        rel, _ = rerank_compare(torch, q, rows, slabs, "Manhattan", **kw)
        assert rel <= RERANK_RTOL, f"rerank edge d_pad=1024 {sd} again: rel err {rel}"
        worst, n = max(worst, rel), n + 1
    for sd in (torch.bfloat16, torch.int8):
        hot = torch.full((512, 8), 3, dtype=torch.int32, device=dev)
        one = torch.full((1, 1), 5, dtype=torch.int32, device=dev)
        bad = torch.randint(0, 16, (64, 6), generator=g, device=dev, dtype=torch.int32)
        bad[0, 0], bad[1, 5], bad[7, 2], bad[63, 0] = -1, 16, -2**31, 2**31 - 1
        for rows in (hot, one, bad):
            q, rows, slabs, kw = inputs(rows.shape[0], rows.shape[1], 16, 336, 128, sd, rows)
            for metric in ("Euclidean", "Manhattan", "Chebyshev"):
                rel, _ = rerank_compare(torch, q, rows, slabs, metric, **kw)
                assert rel <= RERANK_RTOL, f"rerank edge {sd} rows {tuple(rows.shape)}: {rel}"
                worst, n = max(worst, rel), n + 1
        log(f"kernel rerank edges: {sd} one slab x 4,096 pairs ({schedule_stats(torch, hot, 16)})"
            f", one pair, and 4 out-of-range rows (NaN rows) agree")
    log(f"kernel rerank edges: {n} cases within rtol {RERANK_RTOL}, worst rel err {worst:.3e}")


# replica_small_checks' inputs: (dtype, d, SOAR lambda, n_extra, db given,
# centroids near points).  f32 is the exact build's CUDA-core kernel; d 5
# and 100 are zero-padded to 16 and 112; d 96 reads a zero-filled half
# slice; d 960 streams the point tiles by slices.  The last case puts each
# centroid 0.1 N(0, 1) from a corpus point, so an admitted D is ~1 against
# terms |x|^2 + |c|^2 ~280: there the f32 expansion of either version
# carries errors of ~1e-4 of D, and the ranks are held to NEAREST_RTOL of
# the terms (replica_compare's ``terms``).
SMALL_CASES = (
    ("float32", 128, 0.5, 3, False, False),
    ("float32", 96, 0.0, 8, True, False),
    ("bfloat16", 5, 0.5, 1, False, False),
    ("bfloat16", 16, 0.0, 8, True, False),
    ("bfloat16", 96, 0.0, 1, False, False),
    ("bfloat16", 96, 0.5, 8, True, False),
    ("bfloat16", 100, 0.5, 3, False, False),
    ("bfloat16", 960, 0.5, 3, False, False),
    ("bfloat16", 96, 0.0, 1, False, True),
)


def rank_error_f64(Xh, Ch, base, ids, ranks, lam: float) -> float:
    """Max error of the finite ranks relative to their f64 values."""
    p, s = np.nonzero(np.isfinite(ranks))
    worst = 0.0
    for k in range(0, len(p), 8192):
        pp, j = p[k : k + 8192], ids[p[k : k + 8192], s[k : k + 8192]]
        D = ((Xh[pp] - Ch[j]) ** 2).sum(1)
        if lam:
            b = base[pp]
            db = ((Xh[pp] - Ch[b]) ** 2).sum(1)
            CC = ((Ch[b] - Ch[j]) ** 2).sum(1)
            D = D + lam * (0.5 * (db + D - CC)) ** 2 / np.maximum(db, 1e-30)
        err = np.abs(ranks[pp, s[k : k + 8192]] - D) / np.maximum(D, 1e-6)
        worst = max(worst, float(err.max()))
    return worst


def replica_small_checks(torch, report) -> None:
    """Both kernels against their plain versions on small inputs of every
    route (SMALL_CASES): n 8,192 points and C 1,500 centroids, draws of the
    bench mixture (or centroids near points), base the plain nearest
    centroid, bt 1.1.  Same gates as the path-shape checks; each line also
    gives both versions' rank errors against f64."""
    from spfresh_tpu_torch.ops import replica

    dev = torch.device(DEVICE)
    n, C, bt = 8192, 1500, float(np.float32(1.1))
    for i, (dt_name, d, lam, n_extra, given, near) in enumerate(SMALL_CASES):
        dt = getattr(torch, dt_name)
        if near:
            data, _ = mixture(d + i, n, 0, d)
            rng = np.random.default_rng(d + i)
            cents_np = data[rng.integers(0, n, C)] + 0.1 * rng.standard_normal((C, d))
            data = np.concatenate([data, cents_np.astype(np.float32)])
        else:
            data, _ = mixture(d + i, n + C, 0, d)
        X = torch.from_numpy(data[:n]).to(dev).to(dt)
        cents = torch.from_numpy(data[n:]).to(dev).to(dt)
        kb, kd = replica.nearest_centroid(X, cents)
        pb, pd = replica.nearest_centroid_plain(X, cents)
        torch.cuda.synchronize()
        Xh = X.float().cpu().numpy().astype(np.float64)
        Ch = cents.float().cpu().numpy().astype(np.float64)
        differ, gap, n_abs, n_rel = nearest_compare(Xh, Ch, *(t.cpu().numpy()
                                                              for t in (kb, kd, pb, pd)))
        base = pb.to(torch.int32)
        db = ((X.float() - cents[pb.long()].float()) ** 2).sum(1) if given else None
        ki, kr = replica.replica_topk(X, base, cents, bt, n_extra, db=db, soar_lambda=lam)
        pi, pr = replica.replica_topk_plain(X, base, cents, bt, n_extra, db=db, soar_lambda=lam)
        torch.cuda.synchronize()
        ki, kr, pi, pr = (t.cpu().numpy() for t in (ki, kr, pi, pr))
        bh = base.cpu().numpy()
        tie_rows, r_abs, r_rel = replica_compare(Xh, bh, Ch, bt, ki, kr, pi, pr, lam, terms=near)
        admitted = int(np.isfinite(kr).sum())
        tag = f"{dt_name} d={d} lambda={lam} n_extra={n_extra} db {'given' if given else 'computed'}"
        tag += ", centroids near points" if near else ""
        assert admitted > n // 10, f"replica {tag}: only {admitted} replicas admitted"
        rule = f"|x|^2+|c|^2, rtol {NEAREST_RTOL}" if near else f"the rank, rtol {REPLICA_RTOL}"
        log(f"kernel replica/nearest small: n={n} C={C} {tag}: nearest ids differing {differ} "
            f"(f64 near-ties, max gap {gap:.2e}) max_rel_err={n_rel:.3e}; replica "
            f"admitted={admitted} near_tie_rows={tie_rows} max_rank_rel_err={r_rel:.3e} (of "
            f"{rule}); rank rel err vs f64: kernel {rank_error_f64(Xh, Ch, bh, ki, kr, lam):.3e} "
            f"plain {rank_error_f64(Xh, Ch, bh, pi, pr, lam):.3e}")
        report["replica"]["max_abs_err"] = max(report["replica"]["max_abs_err"], r_abs)
        near_rep = report.setdefault("nearest_centroid", {"max_abs_err": 0.0})
        near_rep["max_abs_err"] = max(near_rep["max_abs_err"], n_abs)


def transposed_codes(torch, vectors3d):
    """(codesT3d (C, d_pad, pad) int8, norms2 (C, pad) int32) of int8 slabs
    (C, pad, d_pad): the layout and |r|^2 table the expansion scorer reads,
    built on the card as benchmarks/rerank_bench.py builds them in numpy
    (a transposed copy; the squared codes summed in int32, 4,096 slabs at
    a time)."""
    codesT3d = vectors3d.transpose(1, 2).contiguous()
    norms2 = torch.zeros(vectors3d.shape[:2], dtype=torch.int32, device=vectors3d.device)
    for s in range(0, vectors3d.shape[0], 4096):
        v = vectors3d[s : s + 4096].to(torch.int32)
        norms2[s : s + 4096] = (v * v).sum(dim=2, dtype=torch.int32)
    return codesT3d, norms2


def int8mxu_check(torch, args, tag: str):
    """The expansion scorer's kernel against its plain version on ``args``
    (qcodes, qscale, qnorm2, rows, codesT3d, norms2, scales), as
    int8mxu_compare holds it, and both timed.  Returns (max abs error,
    kernel ms, plain ms)."""
    from spfresh_tpu_torch.ops import rerank

    max_abs = int8mxu_compare(torch, args, tag)
    ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances_int8mxu(*args), 20)
    plain_ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances_int8mxu_plain(*args), 2)
    return max_abs, ms, plain_ms


def int8mxu_bound(rows, Q: int, nprobe: int, d: int, pad: int) -> dict:
    """Bytes: each probed (d, pad) int8 slab and its pad int32 norms once,
    the query codes and scalars, the output; operations: a multiply and
    an add per code, over the dense int8 tensor-core peak."""
    probed = int(rows.unique().numel())
    nbytes = probed * (d * pad + pad * 4) + Q * nprobe * (d + 12) + Q * nprobe * pad * 4
    return {**bound(nbytes, 2 * Q * nprobe * pad * d, INT8_OPS), "probed": probed}


def kernel_int8mxu(torch, report):
    """The expansion-form scorer at benchmarks/rerank_bench.py's shape and
    data (C 10,775, pad 240, d 128, Q 4,096, nprobe 8, seed 0: Gaussian
    residuals quantized per slab); codes transposed and |r|^2 built on the
    card as the bench builds them in numpy."""
    from spfresh_tpu_torch.ops import rerank

    dev = torch.device(DEVICE)
    C, pad, d, Q, nprobe = 10775, 240, 128, 4096, 8
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((C, d)).astype(np.float32)
    resid = rng.standard_normal((C, pad, d)).astype(np.float32)
    scales_c = (np.abs(resid).max(axis=(1, 2)) / 127.0).astype(np.float32)
    codes = np.clip(np.rint(resid / scales_c[:, None, None]), -127, 127).astype(np.int8)
    del resid
    queries = rng.standard_normal((Q, d)).astype(np.float32)
    rows = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
    log(f"kernel rerank_int8mxu: bench data made in {time.perf_counter() - t0:.2f} s (host)")
    codesT, norms2 = transposed_codes(torch, torch.from_numpy(codes).to(dev))
    del codes
    rows_d = torch.from_numpy(rows).to(dev)
    qcodes, qscale, qnorm2 = rerank.quantize_centered_queries(
        torch.from_numpy(queries).to(dev), torch.from_numpy(cents).to(dev), rows_d)
    args = (qcodes, qscale, qnorm2, rows_d, codesT, norms2, torch.from_numpy(scales_c).to(dev))
    max_abs, ms, plain_ms = int8mxu_check(torch, args, "kernel rerank_int8mxu")
    b = int8mxu_bound(rows_d, Q, nprobe, d, pad)
    gbps = Q * nprobe * pad * d / (ms * 1e-3) / 1e9
    tops = 2 * Q * nprobe * pad * d / (ms * 1e-3) / 1e12
    log(f"kernel rerank_int8mxu: C={C} pad={pad} d={d} Q={Q} nprobe={nprobe} (rerank_bench) "
        f"max_abs_err={max_abs:.3e} (bit-equal to the plain version); "
        f"kernel={ms:.4f} ms ({gbps:.0f} GB/s code reads, {tops:.2f} TOP/s) "
        f"plain={plain_ms:.4f} ms bound={b['bound_ms']:.4f} ms ({b['bound_by']}); "
        f"the rows probe {b.pop('probed')} of {C} slabs; "
        f"{int8mxu_schedule_note(torch, rows_d, C, d, pad)}")
    report["rerank_int8mxu"] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                                "library_ms": None, **b}


def int8mxu_schedule_note(torch, rows, cpad: int, d: int, pad: int) -> str:
    """The scorer's slab-major schedule of ``rows``, timed alone (it is part
    of every kernel time above), with how it groups the pairs and the
    kernel's stage geometry at (d, pad)."""
    from spfresh_tpu_torch.ops import rerank

    geo = rerank.int8mxu_geometry(d, pad)
    sched_ms = cuda_ms(torch, lambda: rerank.rerank_schedule(rows, cpad, geo["group"]), 20)
    return (f"schedule alone {sched_ms:.4f} ms; {schedule_stats(torch, rows, cpad)}; "
            f"geometry {geo}")


def int8mxu_compare(torch, args, tag: str) -> float:
    """The scorer's kernel against its plain version on ``args``; rows out
    of range must give NaN rows on the card and are left out.  Up to d
    1,040, where every dot is an exact f32 integer in both: bit-equal;
    above it within MXU_ATOL + MXU_RTOL |want| with the same stable order
    of each (query, probe)'s pad row.  Returns the max abs error."""
    from spfresh_tpu_torch.ops import rerank

    rows = args[3]
    exact = args[4].shape[1] <= 1040
    bad = (rows < 0) | (rows >= args[4].shape[0])
    got = rerank.padded_rerank_distances_int8mxu(*args)
    want = rerank.padded_rerank_distances_int8mxu_plain(
        *args[:3], torch.where(bad, 0, rows), *args[4:])
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[bad]).all()), "an out-of-range row did not give NaN"
    got, want = got[~bad], want[~bad]
    assert bool(torch.isfinite(got).all()), f"{tag}: the kernel left a non-finite score"
    if got.numel() == 0:
        return 0.0
    err = float((got - want).abs().max())
    if exact:
        assert torch.equal(got, want), f"{tag}: not bit-equal to the plain version ({err})"
        return err
    over = int(((got - want).abs() > MXU_ATOL + MXU_RTOL * want.abs()).sum())
    assert over == 0, f"{tag}: {over} scores outside rtol {MXU_RTOL} atol {MXU_ATOL}"
    assert torch.equal(torch.argsort(got, dim=-1, stable=True),
                       torch.argsort(want, dim=-1, stable=True)), f"{tag}: stable orders differ"
    return err


def int8mxu_edge_cases(torch) -> None:
    """The expansion scorer against its plain version where its schedule and
    stages have edges: d 16, 20, 128, 960, 1,040, 2,048 and 4,096 (k-chunks
    of the slab, a query row not 16-byte aligned at d 20) at pads 4, 240,
    336, 528 and 1,000 (one column pass; no stage divides 1,000) and 1,100
    and 2,052 (two and three column passes); then one slab probed by 4,096
    pairs, a single pair, slabs whose rows are all equal (every score of a
    row ties) and out-of-range rows (NaN rows).  Bit-equal up to d 1,040;
    above it within MXU_RTOL / MXU_ATOL with the same stable order.  A codes
    or |r|^2 table that is not 16-byte aligned must raise."""
    from spfresh_tpu_torch.ops import rerank

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(3)

    def inputs(C, d, pad, rows, equal_rows=False):
        codes = torch.randint(-128, 128, (C, d, 1 if equal_rows else pad), generator=g,
                              device=dev, dtype=torch.int8)
        codes = codes.expand(C, d, pad).contiguous()
        norms2 = (codes.to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
        scales = torch.rand(C, generator=g, device=dev) * 0.02 + 0.005
        Q, nprobe = rows.shape
        qcodes = torch.randint(-127, 128, (Q, nprobe, d), generator=g, device=dev,
                               dtype=torch.int8)
        qscale = torch.rand((Q, nprobe), generator=g, device=dev) * 0.02 + 0.005
        qnorm2 = torch.rand((Q, nprobe), generator=g, device=dev) * 100.0
        return (qcodes, qscale, qnorm2, rows, codes, norms2, scales)

    worst, worst_wide, n = 0.0, 0.0, 0
    for d in (16, 20, 128, 960, 1040, 2048, 4096):
        for pad in (4, 240, 336, 528, 1000, 1100, 2052):
            C = 12
            rows = torch.randint(0, C, (40, 5), generator=g, device=dev, dtype=torch.int32)
            err = int8mxu_compare(torch, inputs(C, d, pad, rows), f"int8mxu edge d={d} pad={pad}")
            if d <= 1040:
                worst = max(worst, err)
            else:
                worst_wide = max(worst_wide, err)
            n += 1
        log(f"kernel int8mxu edges: d={d} geometry at pad 336 {rerank.int8mxu_geometry(d, 336)}, "
            f"at pad 2,052 {rerank.int8mxu_geometry(d, 2052)}")
    C = 16
    hot = torch.full((512, 8), 3, dtype=torch.int32, device=dev)
    one = torch.full((1, 1), 5, dtype=torch.int32, device=dev)
    bad = torch.randint(0, C, (64, 6), generator=g, device=dev, dtype=torch.int32)
    bad[0, 0], bad[1, 5], bad[7, 2], bad[63, 0] = -1, C, -2**31, 2**31 - 1
    for d, pad in ((128, 336), (20, 1000), (960, 2052)):
        for rows, equal_rows in ((hot, False), (one, False), (bad, False), (bad, True)):
            tag = f"int8mxu edge d={d} pad={pad} rows {tuple(rows.shape)} equal={equal_rows}"
            worst = max(worst, int8mxu_compare(torch, inputs(C, d, pad, rows, equal_rows), tag))
            n += 1
    log(f"kernel int8mxu edges: one slab x 4,096 pairs ({schedule_stats(torch, hot, C)}), one "
        f"pair, equal rows and 4 out-of-range rows (NaN rows) agree at (d, pad) (128, 336), "
        f"(20, 1000), (960, 2052)")
    # Tables 4 bytes off a 16-byte boundary: the bulk copies cannot take them.
    args = list(inputs(C, 128, 336, one))
    for i, name in ((4, "codesT3d"), (5, "norms2")):
        t = args[i]
        buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.int8, device=dev)
        off = buf[4 : 4 + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
        off.copy_(t)
        assert off.is_contiguous() and off.data_ptr() % 16 == 4
        bad_args = list(args)
        bad_args[i] = off
        try:
            rerank.padded_rerank_distances_int8mxu(*bad_args)
        except ValueError as e:
            assert "16-byte aligned" in str(e), e
        else:
            raise AssertionError(f"a {name} 4 bytes off 16-byte alignment did not raise")
    log(f"kernel int8mxu edges: {n} cases; bit-equal up to d 1,040 (max abs err {worst:.3e}), "
        f"d 2,048 / 4,096 max abs err {worst_wide:.3e} (rtol {MXU_RTOL} atol {MXU_ATOL}), "
        f"stable order equal; unaligned codes and |r|^2 tables raise")


def scan_check(torch, caug, qaug, bf16_rank: bool, cn2_mean: float):
    """The window scan against its plain version on (caug, qaug): no NaN,
    the same windows finite (sentinel windows reach inf from d_pad 384 on),
    and every finite minimum within SCAN_RTOL of |rank| + mean |c|^2.
    Returns (max rel err, max abs err over windows whose minimum is a real
    rank, the number of those)."""
    from spfresh_tpu_torch.ops import centroid_scan

    got = centroid_scan.centroid_window_scan(caug, qaug, bf16_rank)
    want = centroid_scan.centroid_window_scan_plain(caug, qaug, bf16_rank)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(got).any()), "window scan gave NaN"
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin), "window scan: other windows finite"
    err = (got - want).abs()[fin]
    rel = float((err / (want.abs()[fin] + cn2_mean)).max())
    assert rel <= SCAN_RTOL, f"window scan bf16_rank={bf16_rank}: rel err {rel} > {SCAN_RTOL}"
    real = want.abs() < 1e30
    return rel, float((got - want).abs()[real].max()), int(real.sum())


def scan_gemm_ms(torch, caug, qaug, bf16_rank: bool, iters: int) -> float:
    """cuBLAS time of the scan's product alone, (Q, d_pad) x (d_pad, Cpad):
    torch.matmul in bf16 for the bf16 rank, in f32 without TF32 for the f32
    rank (Precision.HIGHEST's contract).  A yardstick the port never calls."""
    dt = torch.bfloat16 if bf16_rank else torch.float32
    a, b = qaug.to(dt), caug.to(dt).T
    out = torch.empty((a.shape[0], b.shape[1]), dtype=dt, device=a.device)
    return cuda_ms(torch, lambda: torch.matmul(a, b, out=out), iters)


def kernel_centroid_scan(torch, report):
    """The window scan at SCAN_CASES in both rank modes against its plain
    version: bench-mixture centroids with window 1 and every 997th row
    invalid (1e18), and bench-mixture queries.  The timed cases log the
    kernel, its plain version, the cuBLAS product alone and the bound."""
    from spfresh_tpu_torch.ops import centroid_scan

    dev = torch.device(DEVICE)
    cases, worst = [], 0.0
    for name, Q, C, d in SCAN_CASES:
        data, queries = mixture(2, C, Q, d)
        valid = torch.ones(C, dtype=torch.bool, device=dev)
        valid[::997] = False
        valid[128:256] = False  # an all-invalid window
        d_pad = -(-d // centroid_scan.L) * centroid_scan.L
        caug, qaug, cpad = centroid_scan._augment(torch.from_numpy(queries).to(dev),
                                                  torch.from_numpy(data).to(dev), valid, d_pad)
        cn2_mean = float((caug[:C][valid] ** 2).sum(1).mean())  # the size of a rank's terms
        for bf16_rank in (False, True):
            mode = "bf16" if bf16_rank else "f32"
            rel, max_abs, n_real = scan_check(torch, caug, qaug, bf16_rank, cn2_mean)
            worst = max(worst, max_abs)
            line = (f"kernel centroid_scan {name}: Q={Q} Cpad={cpad} d_pad={d_pad} rank={mode} "
                    f"max_rel_err={rel:.3e} (of |rank| + mean |c|^2 = {cn2_mean:.1f}) "
                    f"max_abs_err={max_abs:.3e} over {n_real} real window minima "
                    f"(rtol {SCAN_RTOL})")
            if name not in SCAN_TIMED:
                log(line)
                continue
            iters = 50 if Q < 1024 else 10
            ms = cuda_ms(torch, lambda: centroid_scan.centroid_window_scan(caug, qaug, bf16_rank),
                         iters)
            plain_ms = cuda_ms(torch, lambda: centroid_scan.centroid_window_scan_plain(
                caug, qaug, bf16_rank), 3)
            g_ms = scan_gemm_ms(torch, caug, qaug, bf16_rank, 3)
            # Bytes: both operands read once, the minima written once.
            # Operations: one bf16 product (2 Q Cpad d_pad) on the bf16 tensor
            # cores, or the f32 rank's three TF32 products on the TF32 ones:
            # the TPU kernel's matrix-unit work, on this card's matrix unit.
            nbytes = (cpad + Q) * d_pad * 4 + Q * (cpad // centroid_scan.L) * 4
            flops = 2 * Q * cpad * d_pad
            b = bound(nbytes, flops, BF16_FLOPS) if bf16_rank else bound(
                nbytes, 3 * flops, TF32_FLOPS)
            log(f"{line} kernel={ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the "
                f"rank's product) plain={plain_ms:.4f} ms gemm_ms={g_ms:.4f} "
                f"bound={b['bound_ms']:.4f} ms ({b['bound_by']}; "
                f"{b['bound_ms'] / ms:.1%} of it)")
            cases.append({"case": name, "rank": mode, "Q": Q, "Cpad": cpad, "d_pad": d_pad,
                          "ms": ms, "plain_ms": plain_ms, "gemm_ms": g_ms, "max_abs_err": max_abs,
                          **b})
        del caug, qaug
    # The entry's numbers are the large phase's stage 1 (an int8 index routes
    # on f32 centroids: the f32 rank); every timed case is kept beside them.
    head = next(c for c in cases if c["case"] == "large" and c["rank"] == "f32")
    report["centroid_scan"] = {"max_abs_err": worst, "library_ms": None, "cases": cases,
                               **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def topk_rows(torch, rows: int, n: int, kind: str, seed: int):
    """(rows, n) f32 rows of ``kind`` on the card: "centroids", bench-mixture
    queries' distances to bench-mixture rows (bf16, as stage 1 ranks);
    "candidates", the same with ~30% +inf (a posting's padding); "ties",
    an all-equal row, rows of five values and rows rounded to 1,000;
    "specials", distances with -0.0, +0.0, +-inf and NaNs of both signs."""
    from spfresh_tpu_torch.ops.distances import pairwise_distance

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((64, 128), generator=g, device=dev)

    def draw(m):
        a = torch.randint(0, 64, (m,), generator=g, device=dev)
        return (centers[a] + 0.7 * torch.randn((m, 128), generator=g, device=dev)).to(
            torch.bfloat16)

    cols = draw(n)
    x = torch.empty((rows, n), dtype=torch.float32, device=dev)
    for s in range(0, rows, 1024):
        x[s : s + 1024] = pairwise_distance(draw(min(1024, rows - s)), cols)
    if kind == "candidates":
        x.masked_fill_(torch.rand((rows, n), generator=g, device=dev) < 0.3, float("inf"))
    elif kind == "ties":
        x[::3] = 2.5
        x[1::3] = torch.randint(0, 5, x[1::3].shape, generator=g, device=dev).float()
        x[2::3] = x[2::3].round(decimals=-3)
    elif kind == "specials":
        nan = torch.tensor(float("nan"), device=dev)
        special = torch.stack([torch.tensor(0.0, device=dev), torch.tensor(-0.0, device=dev),
                               torch.tensor(float("inf"), device=dev),
                               torch.tensor(float("-inf"), device=dev), nan, -nan.abs()])
        at = torch.rand((rows, n), generator=g, device=dev) < min(0.5, 12 / n)
        pick = torch.randint(0, len(special), (rows, n), generator=g, device=dev)
        x = torch.where(at, special[pick], x)
    return x


def kernel_topk_select(torch, report):
    """The row select at TOPK_CASES against its plain version (torch.topk
    on the int64 keys, on the card): values bit for bit, columns equal.
    The timed cases log the kernel (CUDA events over back-to-back calls,
    and its own device time by torch.profiler), the plain version,
    torch.topk on the f32 values (the yardstick; the port never calls it)
    and the bytes bound."""
    from spfresh_tpu_torch.ops import topk

    cases = []
    for i, (name, rows, n, k, kind) in enumerate(TOPK_CASES):
        x = topk_rows(torch, rows, n, kind, seed=i)
        before = topk.launches
        v, idx = topk.smallest_k(x, k)
        pv, pidx = topk.smallest_k_plain(x, k)
        torch.cuda.synchronize()
        assert topk.launches == before + 1, "the select did not launch its kernel"
        bad = int(((idx != pidx) | (v.view(torch.int32) != pv.view(torch.int32))).any(1).sum())
        assert bad == 0, f"topk_select {name}: {bad} of {rows} rows differ from the plain version"
        line = (f"kernel topk_select {name}: rows={rows} n={n} k={k} {kind}: values and columns "
                f"bit-equal to the plain version")
        if name not in TOPK_TIMED:
            log(line)
            continue
        iters = 20 if rows * n >= 10**7 else 200
        ms = cuda_ms(torch, lambda: topk.smallest_k(x, k), iters)
        dev_ms = profiled_kernel_ms(torch, lambda: topk.smallest_k(x, k), iters,
                                    "topk_select_kernel")
        plain_ms = cuda_ms(torch, lambda: topk.smallest_k_plain(x, k), 3)
        lib_ms = cuda_ms(torch, lambda: torch.topk(x, k, largest=False, sorted=True), iters)
        # Bytes: the rows read once, k (value, int64 column) pairs written.
        b = bound(rows * n * 4 + rows * k * 12, 0, F32_FLOPS)
        log(f"{line}; kernel={ms:.4f} ms (device {dev_ms:.4f}) plain={plain_ms:.4f} ms "
            f"torch.topk={lib_ms:.4f} ms bound={b['bound_ms']:.4f} ms "
            f"({b['bound_ms'] / dev_ms:.1%} of it)")
        cases.append({"case": name, "rows": rows, "n": n, "k": k, "ms": ms, "device_ms": dev_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms, **b})
        del x, v, idx, pv, pidx
    head = cases[0]  # stage 1 at main's shape
    report["topk_select"] = {"max_abs_err": 0.0, "cases": cases,
                             **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by")}}


def profiled_kernel_ms(torch, fn, iters: int, kernel: str) -> float:
    """Mean device ms a call of the kernels whose name holds ``kernel``,
    by torch.profiler over ``iters`` calls (warmed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    assert us > 0, f"the profiler saw no {kernel}"
    return us / 1e3 / iters


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
    # Times are the Euclidean ones, the metric the main path runs.  Bytes:
    # the probed int8 slabs once, the centered queries, queries, rows,
    # scales and the output; operations: dequantize, subtract, multiply, add.
    probed = int(torch.unique(rows).numel())
    log(f"kernel rerank_int8: the rows probe {probed} of {cpad} slabs; "
        f"{schedule_stats(torch, rows, cpad)}")
    nbytes = (probed * pad * d_pad + Q * nprobe * d_pad * 4 + Q * d_pad * 4 + Q * nprobe * 8
              + Q * nprobe * pad * 4)
    report["rerank_int8"] = {"max_abs_err": max(p[1] for p in parts), "ms": parts[0][2],
                             "plain_ms": parts[0][3], "library_ms": None,
                             **bound(nbytes, 4 * Q * nprobe * pad * d_pad, F32_FLOPS)}


def kernel_pairwise(torch, report):
    """The L1/Linf kernel at the Manhattan phase's stage-1 shape (Q 8,192 x
    C 9,945 x d 960), both metrics, f32 and bf16 inputs: Chebyshev must be
    bit-equal to the plain version (a maximum is order-free), Manhattan
    within PAIRWISE_RTOL / PAIRWISE_ATOL (another summation order).
    torch.cdist with p=1 (on f32 copies) is the library yardstick."""
    from spfresh_tpu_torch.ops import pairwise

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(3)
    Q, C, d = 8192, 9945, GIST_D
    x32 = torch.randn((Q, d), generator=g, device=dev)
    y32 = torch.randn((C, d), generator=g, device=dev)
    worst, times = 0.0, {}
    for metric in ("Manhattan", "Chebyshev"):
        for dt in (torch.float32, torch.bfloat16):
            x, y = x32.to(dt), y32.to(dt)
            got = pairwise.l1_linf_pairwise(x, y, metric)
            want = pairwise.l1_linf_pairwise_plain(x, y, metric)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if metric == "Chebyshev":
                assert torch.equal(got, want), f"pairwise {metric} {dt}: not bit-equal"
            else:
                over = err > PAIRWISE_ATOL + PAIRWISE_RTOL * want.abs()
                assert not bool(over.any()), (
                    f"pairwise {metric} {dt}: {int(over.sum())} entries outside rtol "
                    f"{PAIRWISE_RTOL} atol {PAIRWISE_ATOL}")
            worst = max(worst, float(err.max()))
            ms = cuda_ms(torch, lambda: pairwise.l1_linf_pairwise(x, y, metric), 5)
            plain_ms = cuda_ms(torch, lambda: pairwise.l1_linf_pairwise_plain(x, y, metric), 1)
            p = 1.0 if metric == "Manhattan" else float("inf")
            lib_ms = cuda_ms(torch, lambda: torch.cdist(x32, y32, p=p), 3)
            tflops = 3 * Q * C * d / (ms * 1e-3) / 1e12
            name = "bf16" if dt == torch.bfloat16 else "f32"
            log(f"kernel pairwise: Q={Q} C={C} d={d} {metric} {name} "
                f"max_abs_err={float(err.max()):.3e} (Chebyshev bit-equal, Manhattan rtol "
                f"{PAIRWISE_RTOL} atol {PAIRWISE_ATOL}) kernel={ms:.4f} ms "
                f"({tflops:.2f} TFLOP/s as 3 n m d) plain={plain_ms:.4f} ms "
                f"cdist(p={p}, f32)={lib_ms:.4f} ms")
            times[(metric, name)] = (ms, plain_ms, lib_ms, x.element_size())
            del got, want, err
    # The Manhattan phase's stage 1 runs bf16 queries against bf16 centroids.
    ms, plain_ms, lib_ms, size = times[("Manhattan", "bf16")]
    report["pairwise"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms,
                          **bound((Q + C) * d * size + Q * C * 4, 3 * Q * C * d, F32_FLOPS)}


def replica_compare(X, base, C, bt, ki, kr, pi, pr, lam=0.0, terms=False):
    """Kernel vs plain replica lists (X, C: f64 copies of the inputs).

    Ranks of ids in both lists must agree within REPLICA_RTOL of the rank
    or, with ``terms`` (lambda 0, where the rank is D), within NEAREST_RTOL
    of the expansion's terms |x|^2 + |c_j|^2: the nearest centroid's rule
    for D, for inputs whose small D is a cancellation of large terms.  Ids
    must be identical except at near-ties recomputed in f64: an id in only
    one list sits within TIE_TOL of the admission or the closure bound; or
    it is admitted and ties the other list's last kept rank; or it is
    admitted and fills the slot that a bound near-tie freed (the other
    list kept an id that this one rejected at its bound, ranked no later;
    each freed slot explains one id), with its rank within the rank
    tolerance of the f64 rank and no clearly admitted centroid ranked
    before it in f64 left out.  Asserts all of this; returns (rows with a
    near-tie difference, max abs rank error, max rel rank error)."""
    assert not (terms and lam), "the terms rule holds for rank = D only"
    tol = NEAREST_RTOL if terms else REPLICA_RTOL
    x2, c2 = (X * X).sum(1), (C * C).sum(1)

    def scale(p, j, rank):  # what a rank error is relative to
        return x2[p] + c2[j] if terms else np.maximum(np.abs(rank), 1e-6)

    kid = np.where(np.isfinite(kr), ki, -1)
    pid = np.where(np.isfinite(pr), pi, -1)
    fin = (kid >= 0) & (kid == pid)
    diff = np.abs(kr[fin] - pr[fin]).astype(np.float64)
    rows_fin = np.nonzero(fin)[0]
    max_abs = float(diff.max(initial=0.0))
    max_rel = float((diff / scale(rows_fin, kid[fin], pr[fin])).max(initial=0.0))
    rows = np.nonzero((kid != pid).any(axis=1))[0]
    for p in rows:
        kd = {int(j): float(r) for j, r in zip(kid[p], kr[p]) if j >= 0}
        pd = {int(j): float(r) for j, r in zip(pid[p], pr[p]) if j >= 0}
        for j in set(kd) & set(pd):
            max_rel = max(max_rel, abs(kd[j] - pd[j]) / float(scale(p, j, pd[j])))
            max_abs = max(max_abs, abs(kd[j] - pd[j]))
        # The row against every centroid in f64.
        b = int(base[p])
        D = np.maximum(x2[p] + c2 - 2 * (C @ X[p]), 0.0)
        CC = np.maximum(c2[b] + c2 - 2 * (C @ C[b]), 0.0)
        db = D[b]
        rank = D + lam * (0.5 * (db + D - CC)) ** 2 / max(db, 1e-30) if lam else D
        near = ((np.abs(D - bt * db) <= TIE_TOL * np.maximum(np.maximum(bt * db, D), 1e-12))
                | (np.abs(CC - D) <= TIE_TOL * np.maximum(np.maximum(CC, D), 1e-12)))
        admit = (D < bt * db) & (CC >= D)
        admit[b] = False
        clear = admit & ~near
        for mine, other in ((kd, pd), (pd, kd)):
            last = max(other.values()) if len(other) == ki.shape[1] else None
            # Ranks of the slots the other list spent on bound near-ties
            # that this list rejected.
            freed = sorted(other[i] for i in set(other) - set(mine) if near[i])
            for j in sorted(set(mine) - set(other), key=mine.get):
                if near[j]:
                    continue
                assert admit[j], f"replica row {p}: id {j} is not admitted in f64"
                if last is not None and abs(mine[j] - last) <= TIE_TOL * max(last, 1e-12):
                    continue
                fill = next((s for s in freed if s <= mine[j] * (1 + TIE_TOL)), None)
                assert fill is not None, f"replica row {p}: id {j} differs without a near-tie"
                freed.remove(fill)
                assert abs(mine[j] - rank[j]) <= tol * scale(p, j, rank[j]), (
                    f"replica row {p}: id {j} has rank {mine[j]}, {rank[j]} in f64")
                over = set(np.flatnonzero(clear & (rank < rank[j] * (1 - TIE_TOL))).tolist())
                over -= set(mine)
                assert not over, f"replica row {p}: id {j} passes over admitted {sorted(over)[:4]}"
    assert max_rel <= tol, f"replica rank rel err {max_rel} > {tol}"
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


def sweep(torch, index, queries, gt, tag: str, target: float | None = 0.90):
    """nprobe sweep to recall@10 >= ``target``: (nprobe, recall, qps, ids)
    of the first point that clears it, or None.  ``target`` None runs and
    prints the whole sweep."""
    from spfresh_tpu_torch.eval import recall_at_k

    for nprobe in (2, 4, 8, 16, 24, 32, 48, 64):
        ids, _ = index.search(queries, 10, nprobe=nprobe)  # warm
        rec = recall_at_k(ids, gt, 10)
        qps = best_qps(torch, index, queries, nprobe)
        log(f"{tag}: nprobe={nprobe} recall@10={rec:.4f} qps={qps:.1f} (best of 3)")
        if target is not None and rec >= target:
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


def main_config(**clustering) -> dict:
    """``main``'s build config (bench.py:369-384), with clustering params
    overridden (None drops one, leaving SpannIndexBuilder's default)."""
    params = {"distance_metric": "Euclidean", "initialization_method": "KMeans++",
              "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 42, **clustering}
    return {"clustering_params": {k: v for k, v in params.items() if v is not None},
            "storage_dtype": "bfloat16", "search": {"query_batch_size": 8192}}


def phase_main(torch, n: int, nq: int, report) -> None:
    from spfresh_tpu_torch.index import Config, brute_force_search
    from spfresh_tpu_torch.ops import rerank, replica, topk
    from spfresh_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    data, queries = mixture(12345, n, nq)
    log(f"main: corpus n={n} d=128 nq={nq} made in {time.perf_counter() - t0:.2f} s (host)")
    with tempfile.TemporaryDirectory() as out:
        cfg = Config.from_dict({**main_config(), "output_path": out})
        metrics.DEFAULT.reset()
        rerank.launches = 0
        replica.launches = 0
        topk.launches = 0
        index, view = build_logged(torch, cfg, data, "main")

        t0 = time.perf_counter()
        _, gt = brute_force_search(data, queries, 10, device=DEVICE, batch_size=4096)
        log(f"main: exact ground truth on the card in {time.perf_counter() - t0:.2f} s")

        best = sweep(torch, index, queries, gt, "main")
        counts = {"rerank": rerank.launches, "replica": replica.launches,
                  "topk_select": topk.launches}
        log(f"main: kernel launches in the main path {counts}; engines "
            f"{ {k: v for k, v in metrics.snapshot().items() if 'engine' in k} }")
        assert all(c > 0 for c in counts.values()), counts
        assert best is not None, "recall@10 >= 0.90 not reached within nprobe <= 64"
        nprobe, rec, qps, ids = best
        assert_no_duplicates(ids)
        log(f"main: recall point nprobe={nprobe} recall@10={rec:.4f} qps={qps:.1f}; "
            "no result row repeats an id")
        for name, c in counts.items():
            report[name]["launches"] = c
        profile_search(torch, index, queries, nprobe)
        select_launch_check(torch, index, queries, nprobe)
        kernel_rerank_view(torch, view, queries, nprobe, "Euclidean", "main")
        full_probe_check(torch, index, queries)
    return index, data, queries, gt, nprobe, rec


def select_launch_check(torch, index, queries, nprobe: int) -> None:
    """One search at the recall point: each 8,192-query batch selects
    three times (stage 1, the dedup prefilter, its final select), every
    one through the row-select kernel, one row a query each."""
    from spfresh_tpu_torch.ops import topk
    from spfresh_tpu_torch.utils import metrics

    batches = -(-len(queries) // index.config.search.query_batch_size)
    launches, rows = topk.launches, metrics.snapshot().get("topk.select.rows", 0)
    index.search(queries, 10, nprobe=nprobe)
    torch.cuda.synchronize()
    launches = topk.launches - launches
    rows = metrics.snapshot()["topk.select.rows"] - rows
    log(f"main: one search of {len(queries)} queries in {batches} batches launched the row "
        f"select {launches} times over {rows:.0f} rows")
    assert launches == 3 * batches and rows == 3 * len(queries), (launches, rows)


def run_example(torch, name: str, smi: str, *argv):
    """``spfresh_tpu_torch.examples.<name>.main([*argv, "--device", "cuda"])``
    in this process, its stdout captured and logged with its wall; returns
    (stdout, main's return value)."""
    import importlib
    import io

    mod = importlib.import_module(f"spfresh_tpu_torch.examples.{name}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = mod.main([*argv, "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"examples {name}: {line}")
    log(f"examples {name}: wall {wall:.3f} s ({smi})")
    return out, ret


RECORD_MAX_BYTES = 64 * 2**20  # the examples phase re-checks recorded launches up to this


def launches_kernel(name: str, a: dict) -> bool:
    """Whether the wrapper ``name`` launches its kernel on the bound
    arguments ``a`` (the conditions under which it adds to its count)."""
    if name == "padded_rerank_distances":
        return a["rows"].is_cuda and a["rows"].numel() > 0 and a["vectors3d"].shape[1] > 0
    return a["X"].is_cuda


@contextlib.contextmanager
def recorded_launches(torch, funcs, max_bytes: int = RECORD_MAX_BYTES):
    """Records each launch of the wrappers ``funcs`` made through any name
    the port's modules bind them to: the call's arguments (defaults
    applied), each tensor copied at the call when its tensors total at
    most ``max_bytes``, else None.  Yields {function name: [record]};
    every name is restored on exit."""
    import inspect

    records = {f.__name__: [] for f in funcs}
    patched = []
    for f in funcs:
        sig = inspect.signature(f)

        def spy(*args, _f=f, _sig=sig, **kw):
            bound = _sig.bind(*args, **kw)
            bound.apply_defaults()
            a = bound.arguments
            if launches_kernel(_f.__name__, a):
                tensors = [v for v in a.values() if isinstance(v, torch.Tensor)]
                small = sum(t.numel() * t.element_size() for t in tensors) <= max_bytes
                records[_f.__name__].append(
                    {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in a.items()}
                    if small else None)
            return _f(*args, **kw)

        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("spfresh_tpu_torch"):
                for name, val in list(vars(mod).items()):
                    if val is f:
                        setattr(mod, name, spy)
                        patched.append((mod, name, f))
    try:
        yield records
    finally:
        for mod, name, f in patched:
            setattr(mod, name, f)


def check_recorded(torch, records, report, phase: str = "examples") -> dict:
    """Each recorded launch (``recorded_launches``) of ``phase`` again,
    against the plain version on the same inputs: the rerank within
    RERANK_RTOL, the replica lists by replica_compare.  Folds the errors
    into ``report`` and returns {kernel: [launches checked, too large to
    record]}."""
    from spfresh_tpu_torch.ops import replica

    out = {k: [0, 0] for k in ("rerank", "rerank_int8", "replica")}
    for a in records["padded_rerank_distances"]:
        kind = "rerank" if a is None or a["scales"] is None else "rerank_int8"
        if a is None:
            out[kind][1] += 1
            continue
        rel, err = rerank_compare(torch, a["queries"], a["rows"], a["vectors3d"], a["metric"],
                                  scales=a["scales"], centered_queries=a["centered_queries"])
        cpad, pad, d_pad = a["vectors3d"].shape
        assert rel <= RERANK_RTOL, (f"{phase} rerank ({kind}) Q={a['rows'].shape[0]} "
                                    f"nprobe={a['rows'].shape[1]} pad={pad} d_pad={d_pad}: "
                                    f"rel err {rel}")
        report[kind]["max_abs_err"] = max(report[kind]["max_abs_err"], err)
        out[kind][0] += 1
    for a in records["replica_topk"]:
        if a is None:
            out["replica"][1] += 1
            continue
        X, base, cents, lam = a["X"], a["base"], a["cents"], a["soar_lambda"] or 0.0
        args = (X, base, cents, a["bt"], a["n_extra"])
        ki, kr = replica.replica_topk(*args, db=a["db"], soar_lambda=lam)
        pi, pr = replica.replica_topk_plain(*args, db=a["db"], soar_lambda=lam)
        torch.cuda.synchronize()
        Xh, Ch = (t.float().cpu().numpy().astype(np.float64) for t in (X, cents))
        ties, err, rel = replica_compare(Xh, base.cpu().numpy(), Ch, a["bt"],
                                         *(t.cpu().numpy() for t in (ki, kr, pi, pr)), lam)
        log(f"{phase} replica: n={X.shape[0]} C={cents.shape[0]} d={X.shape[1]} {X.dtype} "
            f"n_extra={a['n_extra']} lambda={lam} db {'given' if a['db'] is not None else 'computed'}"
            f": near_tie_rows={ties} max_rank_rel_err={rel:.3e}")
        report["replica"]["max_abs_err"] = max(report["replica"]["max_abs_err"], err)
        out["replica"][0] += 1
    return out


def phase_examples(torch, index, data, queries, gt, nprobe: int, recall: float,
                   smi: str, report) -> dict:
    """The seven example CLIs of spfresh_tpu_torch.examples on the card, in
    this process, the six toy scripts at their own sizes (build_index and
    load_index in a temporary working directory) and sift_eval at main's
    scale through files: main's corpus, SIFT_NQ of its queries and their
    exact top 10 written as fvecs/ivecs with the port's writers and read
    back by the native reader.  Gates: each script's contract; sift_eval
    builds main's clusters (0 differ), its ids at nprobe 32 are main's
    index's up to f64 ties, its printed recall@10 is theirs and at least
    main's at its recall point; every launch of the rerank and replica
    kernels in the phase, recorded at the call, holds against the plain
    version after the counts are read (sift_eval's, at main's shapes, are
    too large to record and are held in `kernels` and `main`).  Returns
    the float rerank, quantized rerank and replica launches of the phase,
    per report entry."""
    import importlib
    import os
    from pathlib import Path

    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.io import write_fvecs, write_ivecs
    from spfresh_tpu_torch.ops import rerank, replica

    # Every module that binds a wrapper's name, imported before the names
    # are recorded.
    for name in ("clustering.hierarchical", "clustering.outofcore", "parallel.cluster_step",
                 "index.spann", "index.lazy", "ops.centroid_scan", "lire", "parallel"):
        importlib.import_module(f"spfresh_tpu_torch.{name}")
    for name in EXAMPLES:
        importlib.import_module(f"spfresh_tpu_torch.examples.{name}")
    rerank.launches = rerank.quantized_launches = replica.launches = 0
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with (tempfile.TemporaryDirectory(dir=scratch, prefix="examples_") as tmp,
          recorded_launches(torch, (rerank.padded_rerank_distances,
                                    replica.replica_topk)) as records):
        cwd = os.getcwd()
        os.chdir(tmp)  # build_index saves to the config's relative output_path
        try:
            out, _ = run_example(torch, "build_index", smi)
            assert "point_id=0" in out, out
            out, _ = run_example(torch, "load_index", smi)
            assert "Nearest neighbour: point_id: 0 " in out, out
        finally:
            os.chdir(cwd)
        out, _ = run_example(torch, "live_updates", smi)
        lines = out.splitlines()
        built = int(lines[1].split()[1])
        after = int(lines[2].split(":")[1].split()[0])
        nearest = [int(i) for i in lines[3].split("[")[1].rstrip("]").split(",")]
        assert after > built and all(10_000 <= i < 10_400 for i in nearest), out
        out, _ = run_example(torch, "disk_updates", smi)
        assert out.splitlines()[-1] == "self-query after compaction returns id 0", out
        out, _ = run_example(torch, "quantized_index", smi)
        q = {line.split()[0]: float(line.split("recall@10=")[1].split()[0])
             for line in out.splitlines()[1:]}
        assert set(q) == {"float32", "int8"} and min(q.values()) > 0.8, out
        out, _ = run_example(torch, "sharded_search", smi)
        assert "self-NN exact for all 16 queries" in out and "search sees id 90000" in out, out

        t0 = time.perf_counter()
        files = {k: os.path.join(tmp, f"{k}.{ext}")
                 for k, ext in (("base", "fvecs"), ("query", "fvecs"), ("gt", "ivecs"))}
        write_fvecs(files["base"], data)
        write_fvecs(files["query"], queries[:SIFT_NQ])
        write_ivecs(files["gt"], gt[:SIFT_NQ].astype(np.int32))
        log(f"examples sift_eval: {len(data)} x {data.shape[1]} corpus, {SIFT_NQ} queries and "
            f"their top 10 written in {time.perf_counter() - t0:.2f} s "
            f"({sum(os.path.getsize(f) for f in files.values()) / 2**20:.1f} MiB)")
        out, built = run_example(torch, "sift_eval", smi, "--base", files["base"], "--query",
                                 files["query"], "--gt", files["gt"], "--cluster-size", "256",
                                 "--initial-k", "16", "--storage-dtype", "bfloat16")
    counts = {"rerank": rerank.launches, "rerank_int8": rerank.quantized_launches,
              "replica": replica.launches}
    log(f"examples: kernel launches in the phase {counts}")
    assert all(c > 0 for c in counts.values()), counts

    differ = cluster_diff(index, built)
    got = out.split("recall@10=")[1].split()[0]
    qs = queries[:SIFT_NQ]
    want_ids, _ = index.search(qs, 10, nprobe=32)
    got_ids, _ = built.search(qs, 10, nprobe=32)
    rows = int((want_ids != got_ids).any(axis=1).sum())
    unexplained = sharded_ties(index, qs, want_ids, got_ids, 32, "examples sift_eval")
    rec = recall_at_k(got_ids, gt[:SIFT_NQ], 10)
    log(f"examples sift_eval: {differ} of {index.num_clusters} clusters differ from main's build; "
        f"ids at nprobe 32 differ from main's index's in {rows} of {SIFT_NQ} rows "
        f"({unexplained} not f64 ties); recall@10 at nprobe 32 {got} (its ids {rec:.4f}) "
        f"against main's {recall:.4f} at nprobe {nprobe}")
    assert differ == 0, f"sift_eval's build differs from main's in {differ} clusters"
    assert unexplained == 0, f"sift_eval's ids differ from main's in {unexplained} rows"
    assert got == f"{rec:.4f}", f"sift_eval printed recall {got}, its ids give {rec:.4f}"
    assert float(got) >= recall, f"sift_eval recall@10 {got} below main's {recall}"
    del built

    checked = check_recorded(torch, records, report)
    log(f"examples: launches held against the plain versions (checked, too large to record) "
        f"{checked}")
    for kind, c in counts.items():
        assert sum(checked[kind]) == c, f"examples {kind}: {checked[kind]} recorded of {c} launches"
        assert checked[kind][0] > 0, f"examples {kind}: no launch small enough to check"
    return counts


def latent_rows(seed: int, n: int, rows: int, d: int = GIST_D, latent: int = GIST_LATENT,
                spread: float = 0.7) -> np.ndarray:
    """The first ``rows`` corpus rows of ``latent_mixture(seed, n, ...)``
    without drawing the rest: numpy fills a draw in order, so the leading
    rows of the ambient noise are those of a shorter draw."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, n // 1000)
    proj = rng.standard_normal((latent, d)).astype(np.float32) / np.sqrt(latent)
    centers = rng.standard_normal((n_centers, latent)).astype(np.float32)
    a = rng.integers(0, n_centers, size=n)[:rows]
    lat = centers[a] + spread * rng.standard_normal((n, latent))[:rows]
    amb = 0.01 * rng.standard_normal((rows, d))
    return (lat.astype(np.float32) @ proj + amb).astype(np.float32)


def build_launches(reset: bool = False) -> dict:
    """The build kernels' launch counts (set to 0 first when ``reset``)."""
    from spfresh_tpu_torch.ops import pairwise, replica

    if reset:
        replica.launches = replica.nearest_launches = pairwise.launches = 0
    return {"replica": replica.launches, "nearest_centroid": replica.nearest_launches,
            "pairwise": pairwise.launches}


def phase_list(profile: dict) -> str:
    return " ".join(f"{k}={v:.3f}" for k, v in sorted(profile.items(), key=lambda kv: -kv[1]))


def timed_build(torch, cfg, data, tag: str, **kw):
    """``SpannIndexBuilder(cfg, **kw).build(save=False)`` on the card, the
    kernels' launch counts set to 0 just before and read just after; logs
    the wall, the counts and the build's phases.  Returns (index, wall,
    launches, builder)."""
    from spfresh_tpu_torch.index import SpannIndexBuilder

    build_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    builder = SpannIndexBuilder(cfg, device=DEVICE, **kw).with_data(data)
    index = builder.build(save=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build_launches()
    log(f"shardbuild {tag}: build wall={wall:.3f} s clusters={index.num_clusters} "
        f"stored={index.num_vectors} launches {launches}; phases {phase_list(index.build_profile)}")
    return index, wall, launches, builder


def cluster_diff(a, b) -> int:
    """Clusters of two indexes that differ in member ids or centroid
    vector (-1 when their cluster ids differ)."""
    if sorted(a.postings) != sorted(b.postings):
        return -1
    return sum(not (np.array_equal(a.postings[c][0], b.postings[c][0])
                    and np.array_equal(a.centroids[c], b.centroids[c])) for c in a.postings)


def kernel_replica_shard(torch, data, index, params, rows: int) -> None:
    """The replica kernel as the in-core build's per-shard pass launches
    it: one shard's rows of main's corpus (bf16), main's centroids, each
    row's nearest centroid as its base, ``db`` computed by the kernel;
    against the plain version with replica_compare, times logged."""
    from spfresh_tpu_torch.ops import replica

    dev = torch.device(DEVICE)
    cents = torch.from_numpy(np.stack([index.centroids[c] for c in sorted(index.centroids)]))
    cents = cents.to(dev).to(torch.bfloat16)
    X = torch.from_numpy(data[:rows]).to(dev).to(torch.bfloat16)
    base, _ = replica.nearest_centroid(X, cents)
    n_extra = min(params.max_replicas - 1, cents.shape[0] - 1)
    bt = float(np.float32(params.boundary_threshold))
    lam = float(params.soar_lambda or 0.0)

    def kernel():
        return replica.replica_topk(X, base, cents, bt, n_extra, soar_lambda=lam)

    def plain():
        return replica.replica_topk_plain(X, base, cents, bt, n_extra, soar_lambda=lam)

    ki, kr, pi, pr = (t.cpu().numpy() for t in (*kernel(), *plain()))
    tie_rows, _, max_rel = replica_compare(
        X.float().cpu().numpy().astype(np.float64), base.cpu().numpy(),
        cents.float().cpu().numpy().astype(np.float64), bt, ki, kr, pi, pr, lam)
    admitted = int(np.isfinite(kr).sum())
    assert admitted > rows // 10, f"only {admitted} replicas admitted: degenerate check"
    log(f"shardbuild kernel replica (a shard, db computed): n={rows} C={cents.shape[0]} "
        f"d={X.shape[1]} bf16 n_extra={n_extra} lambda={lam} admitted={admitted} "
        f"near_tie_rows={tie_rows} max_rank_rel_err={max_rel:.3e} (rtol {REPLICA_RTOL}) "
        f"kernel={cuda_ms(torch, kernel, 3):.4f} ms plain={cuda_ms(torch, plain, 1):.4f} ms")


def kernel_pairwise_shard(torch, X, index, rows: int, k: int) -> None:
    """The L1/Linf kernel as the Manhattan device-list build launches it on
    one shard (``rows`` rows of ``X`` on the bf16 grid, as the build holds
    its corpus, in f32): the assign block against ``k`` of the index's
    centroids (the first round's width), and the replica pass's first row
    block against every centroid.  Within PAIRWISE_RTOL / PAIRWISE_ATOL of
    the plain version (another summation order)."""
    from spfresh_tpu_torch.ops import pairwise, replica

    dev = torch.device(DEVICE)
    cents = torch.from_numpy(np.stack([index.centroids[c] for c in sorted(index.centroids)]))
    cents = cents.to(dev).to(torch.bfloat16).float()
    X = torch.from_numpy(np.ascontiguousarray(X[:rows])).to(dev).to(torch.bfloat16).float()
    tile = max(256, replica.PLAIN_TILE_ELEMS // cents.shape[0])
    for tag, x, c in (("assign block", X, cents[:k]), ("replica row block", X[:tile], cents)):
        got = pairwise.l1_linf_pairwise(x, c, "Manhattan")
        want = pairwise.l1_linf_pairwise_plain(x, c, "Manhattan")
        torch.cuda.synchronize()
        err = (got - want).abs()
        over = int((err > PAIRWISE_ATOL + PAIRWISE_RTOL * want.abs()).sum())
        ms = cuda_ms(torch, lambda: pairwise.l1_linf_pairwise(x, c, "Manhattan"), 3)
        plain_ms = cuda_ms(torch, lambda: pairwise.l1_linf_pairwise_plain(x, c, "Manhattan"), 1)
        log(f"shardbuild kernel pairwise ({tag} of a shard): {x.shape[0]} x {c.shape[0]} x "
            f"{x.shape[1]} f32 Manhattan max_abs_err={float(err.max()):.3e} entries outside "
            f"rtol {PAIRWISE_RTOL} atol {PAIRWISE_ATOL}: {over}; kernel={ms:.4f} ms "
            f"plain={plain_ms:.4f} ms")
        assert over == 0, f"pairwise at a shard's {tag}: {over} entries outside the tolerance"


def phase_shardbuild(torch, index, data, queries, gt, nprobe: int, smi: str) -> dict:
    """The build over a device list of SB_ENTRIES entries, every one cuda:0.
    Gates: main's clusters from the in-core build in both corpus layouts
    (and, replicated, the first entry's corpus handed to the view pack,
    whose slabs equal main's); binary and nested builds equal on one device
    twice and over the list, every point placed, nested clusters within the
    cap, full-probe recall@10 exactly 1.0; the out-of-core build and a
    Manhattan build equal their single-device builds; each kernel of a
    device-list path launched; each kernel held to its plain version at
    the shapes the phase launches it.  Returns the device-list builds'
    launches, per report entry."""
    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import Config

    devices = SB_DEVICES
    E = len(devices)
    total = dict.fromkeys(("replica", "nearest_centroid", "pairwise"), 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    log(f"shardbuild: {E} entries {devices} ({smi}); main's single-device build phases "
        f"{phase_list(index.build_profile)}")
    cfg = Config.from_dict(main_config())
    kernel_replica_shard(torch, data, index, cfg.to_clustering_params(), len(data) // E)
    main_view = index.padded_view()
    for layout in ("sharded", "replicated"):
        built, _, launches, _ = timed_build(torch, cfg, data, f"in-core {layout}",
                                            devices=devices, corpus_layout=layout)
        add(launches)
        assert launches["replica"] == E, f"{layout}: replica launches {launches}, one an entry"
        differ = cluster_diff(index, built)
        if layout == "replicated":
            corpus = built._corpus_cache
            assert corpus is not None and corpus[1].device == built.device, "no corpus handoff"
            view = built.padded_view()
            same = (torch.equal(view.vectors3d, main_view.vectors3d)
                    and torch.equal(view.ids2d, main_view.ids2d))
            log(f"shardbuild in-core replicated: the first entry's corpus "
                f"{tuple(corpus[1].shape)} on {corpus[1].device} packed the view; slabs equal "
                f"main's: {same}")
            assert same, "the replicated build's view differs from main's"
        ids, _ = built.search(queries, 10, nprobe=nprobe)
        rec = recall_at_k(ids, gt, 10)
        log(f"shardbuild in-core {layout}: {differ} of {index.num_clusters} clusters differ from "
            f"main's single-device build; replica launches per entry {launches['replica'] / E:g}; "
            f"recall@10={rec:.4f} at nprobe {nprobe}")
        assert differ == 0, f"{layout}: {differ} clusters differ from the single-device build"
        del built
        torch.cuda.empty_cache()

    q, gt_q = queries[:1000], gt[:1000]
    for mode, over in (("nested", {"replication": "nested", "initial_k": 4,
                                   "desired_cluster_size": None}),
                       ("binary", {"max_split_ways": 2})):
        cfg = Config.from_dict({**main_config(**over), "storage_dtype": "float32"})
        builds = []
        for tag, kw in (("one device", {}), ("one device again", {}),
                        (f"{E} entries", {"devices": devices})):
            built, _, launches, _ = timed_build(torch, cfg, data, f"{mode} {tag}", **kw)
            builds.append(built)
        add(launches)  # the device-list build's
        assert mode == "nested" or launches["replica"] == E, launches
        differ = [cluster_diff(builds[0], b) for b in builds[1:]]
        built = builds[-1]
        placed = len(np.unique(np.concatenate([ids for ids, _ in built.postings.values()])))
        largest = max(len(ids) for ids, _ in built.postings.values())
        cap = round(0.18 * len(data)) if mode == "nested" else None
        full, _ = built.search(q, 10, nprobe=built.num_clusters)
        rec_full = recall_at_k(full, gt_q, 10)
        ids, _ = built.search(q, 10, nprobe=nprobe)
        log(f"shardbuild {mode}: n={len(data)} clusters differ (again, {E} entries) {differ}; "
            f"{placed} points placed; stored {built.num_vectors} "
            f"(x{built.num_vectors / len(data):.2f}); largest posting {largest} (cap {cap}); "
            f"full-probe recall@10={rec_full} and recall@10={recall_at_k(ids, gt_q, 10):.4f} "
            f"at nprobe {nprobe} ({len(q)} queries)")
        assert differ == [0, 0], f"{mode}: builds differ {differ}"
        assert placed == len(data), f"{mode}: {len(data) - placed} points in no cluster"
        assert cap is None or largest <= cap, f"nested: a posting of {largest} past the cap {cap}"
        assert rec_full == 1.0, f"{mode}: full-probe recall@10 {rec_full}"
        del builds, built
        torch.cuda.empty_cache()

    cfg = Config.from_dict({**main_config(), "build_sample_rows": SB_OC_SAMPLE,
                            "build_tile_rows": SB_OC_TILE})
    one, w1, _, _ = timed_build(torch, cfg, data, "out-of-core one device")
    many, wE, launches, builder = timed_build(torch, cfg, data, f"out-of-core {E} entries",
                                              devices=devices)
    add(launches)
    tiles = -(-len(data) // SB_OC_TILE)
    differ = cluster_diff(one, many)
    log(f"shardbuild out-of-core: walls {w1:.3f} s (one device) and {wE:.3f} s ({E} entries); "
        f"{tiles} tiles: nearest-centroid launches per entry {launches['nearest_centroid'] / E:g}, "
        f"replica {(launches['replica'] - 1) / E:g} (and the sample fit's one); "
        f"{differ} of {one.num_clusters} clusters differ")
    assert launches["nearest_centroid"] == tiles and launches["replica"] == tiles + 1, launches
    assert differ == 0, f"out-of-core: {differ} clusters differ over {E} entries"
    kernel_nearest(torch, data, builder.outofcore, SB_OC_TILE)
    kernel_replica_tile(torch, data, many, builder.outofcore, cfg.to_clustering_params(),
                        SB_OC_TILE)
    del one, many, builder

    l1 = latent_rows(12345, 1_000_000, SB_L1_N)
    cfg = Config.from_dict({**main_config(distance_metric="Manhattan")})
    one, _, _, _ = timed_build(torch, cfg, l1, "manhattan one device")
    many, _, launches, _ = timed_build(torch, cfg, l1, f"manhattan {E} entries",
                                       devices=devices)
    add(launches)
    differ = cluster_diff(one, many)
    log(f"shardbuild manhattan: n={SB_L1_N} d={GIST_D}; L1/Linf launches over {E} entries "
        f"{launches['pairwise']}; {differ} of {one.num_clusters} clusters differ")
    assert launches["pairwise"] > 0, "the L1/Linf kernel did not run"
    assert differ == 0, f"manhattan: {differ} clusters differ over {E} entries"
    kernel_pairwise_shard(torch, l1, many, SB_L1_N // E, cfg.to_clustering_params().initial_k)
    return total


def mixture_more(seed: int, n: int, m: int, draw_seed: int, d: int = 128,
                 spread: float = 0.7) -> np.ndarray:
    """m more points of ``mixture(seed, n, ...)``'s mixture (its centers,
    replayed), drawn with their own generator."""
    centers = np.random.default_rng(seed).standard_normal((max(64, n // 1000), d))
    centers = centers.astype(np.float32)
    rng = np.random.default_rng(draw_seed)
    a = rng.integers(0, len(centers), size=m)
    return (centers[a] + spread * rng.standard_normal((m, d))).astype(np.float32)


def repack_gate(fresh, queries, nprobe: int, tag: str):
    """Gate (a): the in-place view's ids equal those of a full repack of
    the same postings (drop_device_views, then the next search packs in
    full).  Returns the number of differing ids."""
    t0 = time.perf_counter()
    inc, _ = fresh.search(queries, 10, nprobe=nprobe)
    with fresh._lock:
        fresh.index.drop_device_views()
        full, _ = fresh.index.search(queries, 10, nprobe=nprobe)
    differ = int((inc != full).sum())
    log(f"{tag}: gate (a) {len(queries)} queries at nprobe={nprobe}: ids of the in-place view "
        f"vs a full repack: {differ} of {inc.size} differ ({time.perf_counter() - t0:.2f} s)")
    return differ, inc


def live_counts(metrics) -> dict:
    snap = metrics.snapshot()
    keys = ("view.append_updates", "view.vectors_appended", "view.append_scale_demotions",
            "view.rows_scattered",
            "view.incremental_updates", "view.full_repacks", "lire.split.ok",
            "lire.reassign.ok", "lire.merge.ok", "lire.split.failed", "lire.merge.failed",
            "lire.reassign.failed", "lire.vectors_moved")
    return {k: int(snap.get(k, 0)) for k in keys}


def phase_live(torch, index, data, queries, gt, nprobe: int, updates: int = 20_000,
               hot_n: int = 4096, int8_n: int = 262_144):
    """Live updates on main's bf16 index through SpFreshIndex, the gates,
    then the int8 repack gate on a 262,144-row index.  Returns ((the
    SpFreshIndex, its store), (that int8 index, its queries)): the sharded
    phase takes its updates through the SpFreshIndex, whose pipeline is
    stopped, and closes and deletes it."""
    import shutil
    from pathlib import Path

    from spfresh_tpu_torch.eval import evaluate
    from spfresh_tpu_torch.index import brute_force_search
    from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex
    from spfresh_tpu_torch.ops import rerank
    from spfresh_tpu_torch.utils import metrics

    store = Path(__file__).resolve().parent / "build" / LIVE_STORE
    shutil.rmtree(store, ignore_errors=True)
    n, batch = len(data), 512
    failures = []
    fresh = None
    try:
        metrics.DEFAULT.reset()
        rerank.launches = 0
        t0 = time.perf_counter()
        fresh = SpFreshIndex(index, str(store), LireConfig(max_partition_size=512,
                                                           min_partition_size=16))
        log(f"live: SpFreshIndex over {index.num_clusters} postings, {index.num_vectors} stored "
            f"vectors, store under build/, in {time.perf_counter() - t0:.2f} s (host)")
        ev0 = evaluate(index, queries, gt, 10, nprobe)

        ins1 = mixture_more(12345, n, updates, 1)
        ins2 = mixture_more(12345, n, updates, 2)
        ids1 = np.arange(n, n + updates)
        ids2 = np.arange(n + updates, n + 2 * updates)
        t0 = time.perf_counter()
        for s in range(0, updates, batch):
            fresh.insert_batch(ins1[s : s + batch], ids1[s : s + batch])
        insert_s = time.perf_counter() - t0
        probe = queries[:8]
        t0 = time.perf_counter()
        for s in range(0, updates, batch):
            fresh.insert_batch(ins2[s : s + batch], ids2[s : s + batch])
            fresh.search(probe, 10, nprobe=nprobe)
        visible_s = time.perf_counter() - t0
        rng = np.random.default_rng(3)
        hot_at = int(rng.integers(n))
        hot = (data[hot_at] + 0.01 * rng.standard_normal((hot_n, data.shape[1]))).astype(
            np.float32)
        hot_ids = np.arange(n + 2 * updates, n + 2 * updates + hot_n)
        t0 = time.perf_counter()
        for s in range(0, hot_n, batch):
            fresh.insert_batch(hot[s : s + batch], hot_ids[s : s + batch])
        hot_s = time.perf_counter() - t0
        # The hot posting's splits drain before the next search packs the
        # view: a view packed mid-split would pad every slab to its width.
        t0 = time.perf_counter()
        fresh.flush()
        got, _ = fresh.search(hot[:8], 10, nprobe=nprobe)
        hot_drain_s = time.perf_counter() - t0
        hot_seen = float(np.isin(got, hot_ids).sum(axis=1).mean())
        del_ids = rng.choice(n, size=updates // 2, replace=False)
        t0 = time.perf_counter()
        deleted = fresh.delete_batch(del_ids)
        delete_s = time.perf_counter() - t0
        fresh.search(probe, 10, nprobe=nprobe)  # deletes land as slab rewrites
        t0 = time.perf_counter()
        deleted += fresh.delete_batch(hot_ids)
        delete_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.flush()
        drain_s = time.perf_counter() - t0
        # Freeze the store: close() would run further repair rounds, and the
        # reopen below must replay exactly the state searched here.
        fresh.pipeline.stop()
        counts = live_counts(metrics)
        log(f"live: inserts {updates / insert_s:.1f}/s ({insert_s:.2f} s); insert-then-visible "
            f"{updates / visible_s:.1f}/s ({visible_s:.2f} s, a search of 8 after each "
            f"{batch}-batch); hot-spot inserts {hot_n / hot_s:.1f}/s ({hot_s:.2f} s, around "
            f"corpus row {hot_at}; drain and search {hot_drain_s:.2f} s; 8 hot queries find "
            f"{hot_seen:.2f} hot ids in their top 10 at nprobe={nprobe}); deletes {deleted / delete_s:.1f}/s ({deleted} of "
            f"{len(del_ids) + hot_n} ids, {delete_s:.2f} s); drain {drain_s:.2f} s")
        log(f"live: postings {index.num_clusters}, stored {index.num_vectors}, slabs "
            f"{tuple(index.padded_view().vectors3d.shape)}; counts {counts}")
        if not (counts["view.append_updates"] > 0 and counts["view.rows_scattered"] > 0):
            failures.append("(b) the in-place view took no append or no slab rewrite")
        for op in ("split", "reassign", "merge"):
            if counts[f"lire.{op}.ok"] < 1:
                failures.append(f"(b) no {op} completed")

        # (e) recall before and after, (d) deleted and repeated ids.
        live = np.ones(n, bool)
        live[del_ids] = False
        all_data = np.concatenate([data[live], ins1, ins2])
        all_ids = np.concatenate([np.arange(n)[live], ids1, ids2])
        t0 = time.perf_counter()
        _, gt_rows = brute_force_search(all_data, queries, 10, device=DEVICE, batch_size=4096)
        gt_s = time.perf_counter() - t0
        ev1 = evaluate(fresh.index, queries, all_ids[gt_rows], 10, nprobe)
        log(f"live: gate (e) recall@10 at nprobe={nprobe}: before {ev0.recall:.4f} "
            f"({ev0.qps:.1f} QPS), after {ev1.recall:.4f} ({ev1.qps:.1f} QPS; eval.evaluate, one "
            f"timed search each; exact ground truth of the mutated corpus, {len(all_data)} rows, "
            f"on the card in {gt_s:.2f} s)")
        ids_after, _ = fresh.search(queries, 10, nprobe=nprobe)
        dead = np.isin(ids_after, np.concatenate([del_ids, hot_ids]))
        srt = np.sort(ids_after, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        log(f"live: gate (d) deleted ids in results: {int(dead.sum())}; rows repeating an id: "
            f"{int(dup.any(axis=1).sum())}")
        if dead.any() or dup.any():
            failures.append("(d) a deleted id was returned or a row repeats an id")

        # (c) each surviving insert finds itself.
        mine = np.concatenate([ins1, ins2])
        mine_ids = np.concatenate([ids1, ids2])
        got, _ = fresh.search(mine, 10, nprobe=nprobe)
        miss = np.flatnonzero(~(got == mine_ids[:, None]).any(axis=1))
        ties = visibility_ties(fresh, mine[miss], mine_ids[miss], nprobe)
        log(f"live: gate (c) {len(mine)} surviving inserts searched for their own vectors at "
            f"nprobe={nprobe}: {len(miss)} not in their top 10, of which {ties} are routing "
            f"near-ties (f64 centroid distances within {TIE_TOL} of the nprobe-th)")
        if ties < len(miss):
            failures.append(f"(c) {len(miss) - ties} inserts not visible without a near-tie")

        differ, _ = repack_gate(fresh, queries, nprobe, "live")
        if differ:
            failures.append(f"(a) {differ} ids differ from the full repack")
        log(f"live: bf16 rerank launches in the phase: {rerank.launches}")
        int8 = live_int8(torch, store.with_name(LIVE_STORE + "_int8"), failures, int8_n)
        assert not failures, f"live gates failed: {failures}"
    except BaseException:
        if fresh is not None:
            fresh.close()
        shutil.rmtree(store, ignore_errors=True)
        raise
    return (fresh, store), int8


def visibility_ties(fresh, vecs, vids, nprobe: int) -> int:
    """How many of the inserts ``vids`` that search missed sit in a
    posting whose centroid ties (within TIE_TOL, in f64) with the
    nprobe-th nearest centroid: a routing near-tie, not a lost insert."""
    if len(vids) == 0:
        return 0
    index = fresh.index
    pids = np.array(sorted(index.centroids))
    C = np.stack([index.centroids[p] for p in pids]).astype(np.float64)
    ties = 0
    for i, (v, vid) in enumerate(zip(vecs, vids)):
        D = ((C - v.astype(np.float64)) ** 2).sum(1)
        kth = np.partition(D, nprobe - 1)[nprobe - 1]
        homes = fresh.storage.postings_of(int(vid))
        best = min((D[np.searchsorted(pids, h)] for h in homes), default=np.inf)
        ties += int(abs(best - kth) <= TIE_TOL * max(kth, 1e-12))
        if i < 20:
            log(f"live: insert {int(vid)} missed: homes {homes}, f64 home centroid distance "
                f"{best:.6f}, {nprobe}-th nearest centroid {kth:.6f}")
    return ties


def live_int8(torch, store, failures, n: int):
    """5,000 inserts and 2,000 deletes on a 262,144-row int8 index (the
    int8 append path and its scale guard), then the repack gate.  Returns
    (the index, its queries)."""
    import shutil

    from spfresh_tpu_torch.index import Config
    from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex
    from spfresh_tpu_torch.utils import metrics

    data, queries = mixture(12345, n, 16_384)
    cfg = Config.from_dict({
        "clustering_params": {
            "distance_metric": "Euclidean", "initialization_method": "KMeans++",
            "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 42,
        },
        "storage_dtype": "int8",
        "search": {"query_batch_size": 8192},
    })
    index, _ = build_logged(torch, cfg, data, "live int8")
    shutil.rmtree(store, ignore_errors=True)
    try:
        metrics.DEFAULT.reset()
        fresh = SpFreshIndex(index, str(store), LireConfig(max_partition_size=512,
                                                           min_partition_size=16))
        ins = mixture_more(12345, n, 5000, 4)
        ins_ids = np.arange(n, n + 5000)
        t0 = time.perf_counter()
        for s in range(0, 5000, 512):
            fresh.insert_batch(ins[s : s + 512], ins_ids[s : s + 512])
            fresh.search(queries[:8], 10, nprobe=8)
        dels = np.random.default_rng(5).choice(n, size=2000, replace=False)
        deleted = fresh.delete_batch(dels)
        fresh.flush()
        fresh.search(queries[:8], 10, nprobe=8)
        log(f"live int8: 5,000 inserts (each batch then searched) and {deleted} of 2,000 deletes "
            f"in {time.perf_counter() - t0:.2f} s; counts {live_counts(metrics)}")
        differ, ids = repack_gate(fresh, queries, 8, "live int8")
        if differ:
            failures.append(f"(a, int8) {differ} ids differ from the full repack")
        if np.isin(ids, dels).any():
            failures.append("(d, int8) a deleted id was returned")
        fresh.close()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return index, queries


def live_vectors(index):
    """(ids, vectors) of every point an index holds, each once: the corpus
    its exact ground truth is taken over after live updates."""
    ids = np.concatenate([p[0] for p in index.postings.values()])
    vecs = np.concatenate([np.asarray(p[1], np.float32) for p in index.postings.values()])
    ids, first = np.unique(ids, return_index=True)
    return ids, vecs[first]


def sharded_ties(index, queries, a, b, nprobe: int, tag: str, prune=None) -> int:
    """Rows where the ids ``a`` and ``b`` of two searches of one bf16 or
    int8 index differ, less those an f64 tie explains: every id in one row
    and not the other is a rank tie (its f64 distance from the f32 query to
    the row its slab holds, within TIE_TOL of the row's 10th: bf16, the
    bf16-rounded vector; int8, the dequantized c + code * s with the
    posting's scale taken from all its residuals, as a pack takes it), a
    routing tie (a posting holding it has its centroid within TIE_TOL of
    the nprobe-th nearest, in f64 as stage 1 takes both: bf16-rounded for
    bf16, f32 for int8) or, with pruning, a threshold tie (within TIE_TOL
    of prune * (nearest centroid + eps)).  Returns the rows left
    unexplained."""
    from spfresh_tpu_torch.core.dtypes import quant_scale_for, quantize_np

    rows = np.flatnonzero((a != b).any(axis=1))
    if not len(rows):
        return 0
    quant = index.policy.quantized
    route = (lambda x: np.asarray(x, np.float64)) if quant else bf16_f64

    def stored(c, j) -> np.ndarray:
        if not quant:
            return bf16_f64(np.asarray(index.postings[c][1][j], np.float32))
        res = np.asarray(index.postings[c][1], np.float32) - index.centroids[c][None, :]
        s = quant_scale_for(res)
        return index.centroids[c].astype(np.float64) + quantize_np(res[j], s).astype(
            np.float64) * s

    cids = np.array(sorted(index.postings))
    C = route(np.stack([index.centroids[c] for c in cids]))
    all_ids = np.concatenate([index.postings[c][0] for c in cids])
    owner = np.repeat(np.arange(len(cids)), [len(index.postings[c][0]) for c in cids])
    at = np.concatenate([np.arange(len(index.postings[c][0])) for c in cids])
    order = np.argsort(all_ids, kind="stable")
    sids = all_ids[order]

    def homes(i):
        lo, hi = np.searchsorted(sids, i), np.searchsorted(sids, i, side="right")
        return order[lo:hi]

    bad = 0
    for r in rows:
        q = queries[r].astype(np.float64)
        Dc = ((C - route(queries[r])) ** 2).sum(1)
        kth_c = np.partition(Dc, min(nprobe, len(Dc)) - 1)[min(nprobe, len(Dc)) - 1]
        both = [int(i) for i in set(a[r].tolist()) | set(b[r].tolist()) if i >= 0]
        dist = {}
        for i in both:
            j = homes(i)[0]
            dist[i] = float(((stored(cids[owner[j]], at[j]) - q) ** 2).sum())
        kth = max(max((dist[int(i)] for i in row if i >= 0), default=0.0) for row in (a[r], b[r]))
        thr = (None if prune is None
               else float(prune) * (float(Dc.min()) + float(np.finfo(np.float32).eps)))
        notes, bad_row = [], False
        for i in sorted(set(a[r].tolist()) ^ set(b[r].tolist()) - {-1}):
            home_d = [float(Dc[owner[j]]) for j in homes(i)]
            rank_tie = abs(dist[i] - kth) <= TIE_TOL * max(kth, 1e-12)
            route_tie = any(abs(h - kth_c) <= TIE_TOL * max(kth_c, 1e-12) for h in home_d)
            thr_tie = thr is not None and abs(dist[i] - thr) <= TIE_TOL * max(thr, 1e-12)
            notes.append((i, round(dist[i], 6), rank_tie, route_tie, thr_tie))
            bad_row = bad_row or not (rank_tie or route_tie or thr_tie)
        bad += int(bad_row)
        if r in rows[:8] or bad_row:
            log(f"{tag}: query {r}: 10th f64 distance {kth:.6f}, {nprobe}-th centroid "
                f"{kth_c:.6f}; (id, f64 distance, rank tie, routing tie, threshold tie) {notes}")
    return bad


def phase_sharded(torch, index, data, queries, gt, nprobe: int, live, int8, smi: str) -> dict:
    """Multi-device serving: main's index as live left it in a
    ShardedSpannIndex, S = 4 shards on cuda:0 when the card is alone (one
    a card otherwise), then updates through live's SpFreshIndex (closed
    and its store deleted after) refreshing the sharded view in place,
    then live's int8 index in 4 shards.  Returns the rerank launches of
    the phase's global-mode searches, per report entry."""
    import shutil

    fresh, store = live
    try:
        return sharded_gates(torch, index, data, queries, nprobe, fresh, int8, smi)
    finally:
        fresh.close()
        shutil.rmtree(store, ignore_errors=True)


def sharded_gates(torch, index, data, queries, nprobe: int, fresh, int8, smi: str) -> dict:
    import types

    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import brute_force_search
    from spfresh_tpu_torch.ops import rerank
    from spfresh_tpu_torch.parallel import ShardedSpannIndex
    from spfresh_tpu_torch.utils import metrics

    count = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(count)] if count > 1 else ["cuda:0"] * 4
    S, bs, failures = len(devices), 8192, []
    log(f"sharded: S={S} shards on {devices} ({smi})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = ShardedSpannIndex(index, devices)
    view = sharded.padded_view()
    torch.cuda.synchronize()
    single = index.padded_view()
    single_mib = sum(t.nbytes for t in (single.centroids, single.cent_valid, single.lens,
                                        single.ids2d, single.vectors3d, single.scales)) / 2**20
    log(f"sharded: view packed in {time.perf_counter() - t0:.2f} s: {S} x "
        f"{tuple(view.shards[0].vectors3d.shape)} {view.shards[0].vectors3d.dtype}, "
        f"{view.nbytes / 2**20:.1f} MiB on the card (the single-device view "
        f"{tuple(single.vectors3d.shape)}: {single_mib:.1f} MiB); postings per shard "
        f"{[len(f) for f in view.free_rows]} free rows, "
        f"{[sum(1 for s, _ in view.cluster_rows.values() if s == k) for k in range(S)]} held")
    ids_all, vec_all = live_vectors(index)
    t0 = time.perf_counter()
    _, gt_rows = brute_force_search(vec_all, queries, 10, device=DEVICE, batch_size=4096)
    gt = ids_all[gt_rows]
    log(f"sharded: exact ground truth of the index as live left it ({len(ids_all)} points) "
        f"in {time.perf_counter() - t0:.2f} s")

    # Global nprobe at main's recall point against the single index.
    launches = {}
    metrics.DEFAULT.reset()
    rerank.launches = 0
    g_ids, _ = sharded.search(queries, 10, nprobe=nprobe, batch_size=bs, nprobe_mode="global")
    torch.cuda.synchronize()
    launches["rerank"] = rerank.launches
    engines = {k: int(v) for k, v in metrics.snapshot().items() if k.startswith("search.engine")}
    batches = -(-len(queries) // bs)
    log(f"sharded: global nprobe={nprobe}, {len(queries)} queries in {batches} batches: rerank "
        f"launches {launches['rerank']} (S x batches = {S * batches}); engines {engines}")
    if launches["rerank"] != S * batches or engines.get("search.engine.cuda", 0) != 1:
        failures.append("the rerank did not launch once per shard and batch on the card")
    assert_no_duplicates(g_ids)
    one_ids, _ = index.search(queries, 10, nprobe=nprobe)
    rec_g, rec_1 = recall_at_k(g_ids, gt, 10), recall_at_k(one_ids, gt, 10)
    log(f"sharded: recall@10 global {rec_g:.4f}, single index {rec_1:.4f} (delta "
        f"{rec_g - rec_1:+.4f}, gate 0.002); ids at the same place "
        f"{float((g_ids == one_ids).mean()):.4f}, rows equal "
        f"{float((g_ids == one_ids).all(axis=1).mean()):.4f}")
    if abs(rec_g - rec_1) > 0.002:
        failures.append(f"global recall {rec_g:.4f} vs single {rec_1:.4f}")
    p_ids, _ = sharded.search(queries, 10, nprobe=nprobe, batch_size=bs)
    rec_p = recall_at_k(p_ids, gt, 10)
    log(f"sharded: recall@10 per_shard {rec_p:.4f} at nprobe={nprobe} ({S * nprobe} lists "
        f"probed), global {rec_g:.4f}")
    if rec_p < rec_g:
        failures.append(f"per_shard recall {rec_p:.4f} < global {rec_g:.4f}")
    # best_qps and profile_search call search(queries, k, nprobe=...).
    glob = types.SimpleNamespace(search=lambda q, k, nprobe: sharded.search(
        q, k, nprobe=nprobe, batch_size=bs, nprobe_mode="global"))
    per = types.SimpleNamespace(search=lambda q, k, nprobe: sharded.search(
        q, k, nprobe=nprobe, batch_size=bs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    qps_g = best_qps(torch, glob, queries, nprobe)
    peak = torch.cuda.max_memory_allocated()
    qps_p = best_qps(torch, per, queries, nprobe)
    qps_1 = best_qps(torch, index, queries, nprobe)
    log(f"sharded: QPS at nprobe={nprobe} (best of 3, {len(queries)} queries, batch {bs}): "
        f"global {qps_g:.1f}, per_shard {qps_p:.1f}, single index {qps_1:.1f} "
        f"(global / single {qps_g / qps_1:.3f}); peak device memory of the global search "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**20:.1f} MiB above its start); {smi}")
    profile_search(torch, glob, queries, nprobe, tag="profile sharded")

    # Full probe (every list), without and with pruning, on 4,096 queries.
    C, qf = index.num_clusters, queries[:4096]
    for prune in (None, 1.2):
        t0 = time.perf_counter()
        a, _ = sharded.search(qf, 10, nprobe=C, prune_factor=prune, batch_size=bs,
                              nprobe_mode="global")
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, _ = index.search(qf, 10, nprobe=C, prune_factor=prune)
        t_1 = time.perf_counter() - t0
        assert_no_duplicates(a)
        bad = sharded_ties(index, qf, a, b, C, f"sharded full probe prune={prune}", prune)
        log(f"sharded: full probe (nprobe={C}) prune={prune}, {len(qf)} queries: "
            f"{int((a != b).sum())} of {a.size} ids differ from the single index, "
            f"{bad} rows not f64 ties ({t_s:.2f} s sharded, {t_1:.2f} s single)")
        if bad:
            failures.append(f"full probe prune={prune}: {bad} rows differ beyond ties")

    # The same shards on the CPU, with the plain versions.
    t0 = time.perf_counter()
    cpu = ShardedSpannIndex(index, ["cpu"] * S)
    want, _ = cpu.search(queries[:1000], 10, nprobe=nprobe, nprobe_mode="global")
    del cpu
    bad = sharded_ties(index, queries[:1000], g_ids[:1000], want, nprobe, "sharded cpu")
    log(f"sharded: ids of 1,000 queries vs {S} shards on the CPU (plain versions, "
        f"{time.perf_counter() - t0:.1f} s): {int((g_ids[:1000] != want).sum())} of "
        f"{want.size} differ, {bad} rows not f64 ties")
    if bad:
        failures.append(f"{bad} rows differ from the CPU beyond ties")

    # Updates through live's SpFreshIndex: the sharded view refreshes in place.
    fresh.pipeline.start()
    metrics.DEFAULT.reset()
    single_gen = index._padded_gen  # the single-device view must not refresh below
    ins = mixture_more(12345, len(data), 10_000, 6)
    ins_ids = np.arange(int(ids_all.max()) + 1, int(ids_all.max()) + 1 + len(ins))
    t0 = time.perf_counter()
    for s in range(0, len(ins), 512):
        fresh.insert_batch(ins[s : s + 512], ins_ids[s : s + 512])
        sharded.search(queries[:64], 10, nprobe=nprobe, nprobe_mode="global")
    dels = np.random.default_rng(7).choice(ids_all, size=2000, replace=False)
    deleted = fresh.delete_batch(dels)
    fresh.flush()
    fresh.pipeline.stop()  # freeze the index for the comparison below
    inc, _ = sharded.search(queries, 10, nprobe=nprobe, batch_size=bs, nprobe_mode="global")
    torch.cuda.synchronize()
    counts = {k: int(v) for k, v in metrics.snapshot().items() if k.startswith(("view.", "lire."))}
    log(f"sharded: {len(ins)} inserts (512-batches, each then searched) and {deleted} of "
        f"{len(dels)} deletes through live's SpFreshIndex in {time.perf_counter() - t0:.2f} s; "
        f"counts {counts}")
    if not (counts.get("view.append_updates", 0) > 0
            and counts.get("view.rows_scattered", 0) > 0):
        failures.append("the sharded view took no append or no slab rewrite")
    if counts.get("view.full_repacks", 0):
        failures.append("the sharded view repacked in full")
    # Both views count under view.*: the counts are the sharded view's only
    # if the single-device view did not refresh in the window.
    if index._padded_gen != single_gen:
        failures.append("the single-device view refreshed during the sharded updates")
    t0 = time.perf_counter()
    rebuilt = ShardedSpannIndex(index, devices)
    new, _ = rebuilt.search(queries, 10, nprobe=nprobe, batch_size=bs, nprobe_mode="global")
    del rebuilt
    bad = sharded_ties(index, queries, inc, new, nprobe, "sharded updates")
    log(f"sharded: in-place view vs a freshly built ShardedSpannIndex of the mutated index "
        f"({time.perf_counter() - t0:.2f} s): {int((inc != new).sum())} of {inc.size} ids "
        f"differ, {bad} rows not f64 ties; deleted ids returned {int(np.isin(inc, dels).sum())}")
    if bad or np.isin(inc, dels).any():
        failures.append(f"in-place view: {bad} rows differ from a fresh pack beyond ties, "
                        "or a deleted id was returned")
    del sharded, view

    # live's int8 index in 4 shards: the quantized rerank per shard.
    idx8, q8 = int8
    sh8 = ShardedSpannIndex(idx8, devices)
    ids8, vec8 = live_vectors(idx8)
    _, gt8 = brute_force_search(vec8, q8, 10, device=DEVICE, batch_size=4096)
    gt8 = ids8[gt8]
    rerank.quantized_launches = 0
    a8, d8 = sh8.search(q8, 10, nprobe=8, batch_size=bs, nprobe_mode="global")
    torch.cuda.synchronize()
    launches["rerank_int8"] = rerank.quantized_launches
    b8, _ = idx8.search(q8, 10, nprobe=8)
    r_s, r_1 = recall_at_k(a8, gt8, 10), recall_at_k(b8, gt8, 10)
    log(f"sharded int8: {S} x {tuple(sh8.padded_view().shards[0].vectors3d.shape)}; global "
        f"nprobe=8 recall@10 {r_s:.4f}, single index {r_1:.4f} (delta {r_s - r_1:+.4f}); ids "
        f"at the same place {float((a8 == b8).mean()):.4f}; quantized rerank launches "
        f"{launches['rerank_int8']} (S x batches = {S * -(-len(q8) // bs)})")
    assert_no_duplicates(a8)
    if abs(r_s - r_1) > 0.002 or launches["rerank_int8"] != S * -(-len(q8) // bs):
        failures.append("int8: recall parity or the quantized launches")
    # The same int8 shards on the CPU, with the plain versions: ids equal up
    # to f64 ties on the dequantized rows, and where a row's ids are equal,
    # its distances within RERANK_RTOL.
    t0 = time.perf_counter()
    cpu8 = ShardedSpannIndex(idx8, ["cpu"] * S)
    want8, wd8 = cpu8.search(q8[:1000], 10, nprobe=8, nprobe_mode="global")
    del cpu8
    bad8 = sharded_ties(idx8, q8[:1000], a8[:1000], want8, 8, "sharded int8 cpu")
    same = (a8[:1000] == want8).all(axis=1)
    err = np.abs(d8[:1000][same] - wd8[same]) / np.maximum(np.abs(wd8[same]), 1e-30)
    off = int((err > RERANK_RTOL).any(axis=1).sum())
    log(f"sharded int8: ids of 1,000 queries vs {S} shards on the CPU (plain versions, "
        f"{time.perf_counter() - t0:.1f} s): {int((a8[:1000] != want8).sum())} of "
        f"{want8.size} differ, {bad8} rows not f64 ties; rows of equal ids with a distance "
        f"past RERANK_RTOL {off} (largest relative error {float(err.max(initial=0.0)):.3g})")
    if bad8 or off:
        failures.append(f"int8: {bad8} rows differ from the CPU beyond ties, {off} rows' "
                        "distances past RERANK_RTOL")
    assert not failures, f"sharded gates failed: {failures}"
    return launches


def disk_log(msg: str) -> None:
    """``log`` with the seconds since the disk phase began."""
    log(f"[{time.perf_counter() - PHASE_T0[0]:.1f} s] {msg}")


def lazy_timed(torch, lazy, queries, nprobe: int, batch: int, tag: str):
    """One warm-up, then one timed lazy search of ``queries`` (host clock,
    ending in a synchronize).  Device memory is read around the timed run:
    the peak above what was allocated at its start is the lazy search's
    own (the routing tier is allocated before).  Returns (ids, qps, peak
    above start, absolute peak)."""
    lazy.search(queries[: 2 * batch], 10, nprobe=nprobe, batch_size=batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids, _ = lazy.search(queries, 10, nprobe=nprobe, batch_size=batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    qps = len(queries) / dt
    per_batch = lazy.last_staged_bytes / max(1, lazy.last_batches)
    log(f"{tag}: lazy search of {len(queries)} queries at nprobe={nprobe} batch={batch} "
        f"prefetch={'on' if lazy._pipeline else 'off'}: {qps:.1f} QPS ({dt:.3f} s); staged "
        f"{per_batch / 2**20:.3f} MiB of slabs a batch ({lazy.last_batches} batches); peak "
        f"device memory {(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB "
        f"allocated at its start ({peak / 2**20:.1f} MiB in all)")
    return ids, qps, peak - base, peak


def lazy_cpu_ids(store, queries, nprobe: int, tag: str, want: np.ndarray) -> int:
    """The same directory opened with device="cpu" (plain versions): the
    number of ids of ``queries`` that differ from ``want``."""
    from spfresh_tpu_torch.index import LazySpannIndex

    t0 = time.perf_counter()
    with LazySpannIndex(str(store), device="cpu") as cpu:
        got, _ = cpu.search(queries, 10, nprobe=nprobe, batch_size=256)
    differ = int((got != want).sum())
    log(f"{tag}: ids of {len(queries)} queries vs the same directory opened on the CPU (plain "
        f"versions, {time.perf_counter() - t0:.1f} s): {differ} of {got.size} differ")
    return differ


def save_packed(index, store, tag: str) -> None:
    import shutil

    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    index.save(str(store), format="packed")
    size = sum(f.stat().st_size for f in store.iterdir())
    log(f"{tag}: saved packed under build/ ({size / 2**30:.3f} GiB) in "
        f"{time.perf_counter() - t0:.2f} s")


def phase_disk(torch, index, data, queries, gt, nprobe: int, inserts: int = 10_000,
               hot_n: int = 4096, deletes: int = 5000) -> None:
    """Main's index saved packed and served from disk by LazySpannIndex on
    the card (the routing tier on the device, slabs staged per batch), then
    LazySpFreshIndex live updates on that directory."""
    import shutil
    from pathlib import Path

    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import LazySpannIndex
    from spfresh_tpu_torch.ops import centroid_scan, rerank

    store = Path(__file__).resolve().parent / "build" / DISK_STORE
    PHASE_T0[0] = time.perf_counter()
    try:
        save_packed(index, store, "disk")
        view = index.padded_view()
        slab_bytes = view.vectors3d.numel() * view.vectors3d.element_size()
        mem_ids, _ = index.search(queries, 10, nprobe=nprobe)
        rec_mem = recall_at_k(mem_ids, gt, 10)
        rerank.launches = rerank.quantized_launches = centroid_scan.launches = 0
        with LazySpannIndex(str(store), prefetch_threads=2, device=DEVICE) as lazy:
            ids, qps2, peak, _ = lazy_timed(torch, lazy, queries, nprobe, 64, "disk")
            counts = {"rerank": rerank.launches, "rerank_int8": rerank.quantized_launches,
                      "centroid_scan": centroid_scan.launches}
            disk_log(f"disk: kernel launches in the lazy searches of the phase {counts}")
            _, qps_big, peak_big, _ = lazy_timed(torch, lazy, queries, nprobe, 1024, "disk")
        with LazySpannIndex(str(store), prefetch_threads=0, device=DEVICE) as lazy0:
            ids0, qps0, _, _ = lazy_timed(torch, lazy0, queries[:TIMING_NQ], nprobe, 64, "disk")
        assert counts["rerank"] > 0, "the float rerank kernel did not run in the lazy search"
        assert_no_duplicates(ids)
        rec = recall_at_k(ids, gt, 10)
        disk_log(f"disk: recall@10 at nprobe={nprobe}: lazy {rec:.4f}, in-memory {rec_mem:.4f}; "
            f"QPS batch 64 prefetch 2 / 0: {qps2:.1f} / {qps0:.1f}, batch 1,024: {qps_big:.1f}; "
            f"peak above start {peak / 2**20:.1f} MiB (batch 1,024: {peak_big / 2**20:.1f} MiB) "
            f"against the in-memory view's slabs {slab_bytes / 2**20:.1f} MiB")
        assert abs(rec - rec_mem) <= 0.01, (rec, rec_mem)
        assert int((ids0 != ids[:TIMING_NQ]).sum()) == 0, "prefetch 0 and 2 returned different ids"
        assert peak < slab_bytes / 8, (peak, slab_bytes)
        differ = lazy_cpu_ids(store, queries[:1000], nprobe, "disk", ids[:1000])
        assert differ <= ids[:1000].size // 1000, f"{differ} ids differ from the CPU path"
        disk_fresh(torch, store, data, queries, nprobe, rec, inserts, hot_n, deletes)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def lazy_visibility(storage, vecs, vids, nprobe: int):
    """Why each insert ``vids`` that its own search missed was missed, in
    f64 against the live centroids: a routing near-tie (a home posting's
    centroid within TIE_TOL of the nprobe-th nearest, as in
    ``visibility_ties``), routed away (every home posting's centroid
    farther than the nprobe-th nearest, so no nprobe-probe search reaches
    it: a merge or split moved the centroid), or neither (a home posting
    was probed, yet the search missed it).  Returns (ties, routed away,
    neither) as lists of positions in ``vids``."""
    _, pids, cents = storage.centroid_matrix()
    order = np.argsort(pids)
    pids = np.asarray(pids)[order]
    C = np.asarray(cents, np.float64)[order]
    ties, away, neither = [], [], []
    for i, (v, vid) in enumerate(zip(vecs, vids)):
        D = ((C - v.astype(np.float64)) ** 2).sum(1)
        kth = np.partition(D, nprobe - 1)[nprobe - 1]
        homes = storage.postings_of(int(vid))
        home_d = [D[np.searchsorted(pids, h)] for h in homes]
        best = min(home_d, default=np.inf)
        if abs(best - kth) <= TIE_TOL * max(kth, 1e-12):
            ties.append(i)
        elif homes and best > kth:
            away.append(i)
        else:
            neither.append(i)
        if i < 20:
            disk_log(f"disk live: insert {int(vid)} "
                f"missed: homes {homes}, f64 home centroid distance {best:.6f}, {nprobe}-th "
                f"nearest centroid {kth:.6f}")
    return ties, away, neither


def store_state(storage) -> dict:
    """Each live posting's live ids and centroid bytes: what a WAL replay
    must restore."""
    out = {}
    for pid in storage.posting_ids():
        ids, _, _ = storage.get_posting(pid)
        out[pid] = (sorted(ids.tolist()), storage.get_posting_centroid(pid).tobytes())
    return out


def bf16_f64(x) -> np.ndarray:
    """``x`` rounded to bf16 (half to even), in f64: what the lazy bf16
    search compares."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float64).numpy()


def tie_explained(storage, vec_of, queries, a, b, nprobe: int, tag: str) -> int:
    """Rows where the ids ``a`` and ``b`` of two searches of one live index
    differ, less those an f64 tie explains.  A row is a tie when every id
    in one result and not the other is a rank tie (its f64 distance from
    the bf16-rounded query to its bf16-rounded vector within TIE_TOL of
    the row's 10th) or a routing tie (a posting holding it has its
    centroid within TIE_TOL of the nprobe-th nearest, as in
    ``visibility_ties``).  Returns the rows left unexplained."""
    _, pids, cents = storage.centroid_matrix()
    order = np.argsort(pids)
    pids = np.asarray(pids)[order]
    C = np.asarray(cents, np.float64)[order]
    bad = 0
    for r in np.flatnonzero((a != b).any(axis=1)):
        q = bf16_f64(queries[r])
        Dc = ((C - queries[r].astype(np.float64)) ** 2).sum(1)
        kth_c = np.partition(Dc, nprobe - 1)[nprobe - 1]
        both = [int(i) for i in set(a[r].tolist()) | set(b[r].tolist()) if i >= 0]
        dist = {i: float(((bf16_f64(vec_of(i)) - q) ** 2).sum()) for i in both}
        kth = max(sorted(dist[int(i)] for i in row if i >= 0)[-1] for row in (a[r], b[r]))
        notes = []
        bad_id = False  # equal sets in another order: the swapped ids tie in f32
        for i in sorted(set(a[r].tolist()) ^ set(b[r].tolist()) - {-1}):
            homes = [h for h in storage.postings_of(i) if h in set(pids.tolist())]
            home_d = [Dc[np.searchsorted(pids, h)] for h in homes]
            rank_tie = abs(dist[i] - kth) <= TIE_TOL * max(kth, 1e-12)
            route_tie = any(abs(h - kth_c) <= TIE_TOL * max(kth_c, 1e-12) for h in home_d)
            notes.append((i, round(dist[i], 6), [round(float(h), 6) for h in home_d],
                          rank_tie, route_tie))
            bad_id = not (rank_tie or route_tie)
            if bad_id:
                break
        bad += int(bad_id)
        log(f"{tag}: query {r}: 10th f64 distance {kth:.6f}, {nprobe}-th centroid "
            f"{kth_c:.6f}; (id, distance, home centroid distances, rank tie, routing tie) "
            f"{notes}")
    return bad


def disk_fresh(torch, store, data, queries, nprobe: int, rec_before: float, inserts: int,
               hot_n: int, deletes: int) -> None:
    """LazySpFreshIndex on the disk phase's directory: ``live``'s traffic at
    smaller counts, then WAL replay on reopen and compact()."""
    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import brute_force_search
    from spfresh_tpu_torch.lire import LazySpFreshIndex, LireConfig
    from spfresh_tpu_torch.ops import rerank
    from spfresh_tpu_torch.utils import metrics

    n, batch = len(data), 512
    lc = LireConfig(max_partition_size=512, min_partition_size=16)
    metrics.DEFAULT.reset()
    rerank.launches = 0
    t0 = time.perf_counter()
    fresh = LazySpFreshIndex(str(store), lire_config=lc, device=DEVICE)
    disk_log(f"disk live: LazySpFreshIndex over {fresh.num_clusters} postings in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    try:
        ins = mixture_more(12345, n, inserts, 21)
        ins_ids = np.arange(n, n + inserts)
        probe = queries[:8]
        t0 = time.perf_counter()
        for s in range(0, inserts, batch):
            fresh.insert_batch(ins[s : s + batch], ins_ids[s : s + batch])
            fresh.search(probe, 10, nprobe=nprobe)
        visible_s = time.perf_counter() - t0
        rng = np.random.default_rng(23)
        hot_at = int(rng.integers(n))
        hot = (data[hot_at] + 0.01 * rng.standard_normal((hot_n, data.shape[1]))).astype(
            np.float32)
        hot_ids = np.arange(n + inserts, n + inserts + hot_n)
        t0 = time.perf_counter()
        for s in range(0, hot_n, batch):
            fresh.insert_batch(hot[s : s + batch], hot_ids[s : s + batch])
        hot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.flush()
        drain_hot_s = time.perf_counter() - t0
        del_ids = rng.choice(n, size=deletes, replace=False)
        t0 = time.perf_counter()
        deleted = fresh.delete_batch(del_ids)
        deleted += fresh.delete_batch(hot_ids)  # as in live: the hot spot goes again
        delete_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.flush()
        drain_s = time.perf_counter() - t0
        # Freeze the store: close() would run further repair rounds, and the
        # reopen below must replay exactly the state searched here.
        fresh.pipeline.stop()
        counts = live_counts(metrics)
        disk_log(f"disk live: insert-then-visible {inserts / visible_s:.1f}/s ({visible_s:.2f} s, "
            f"a search of 8 after each {batch}-batch); hot-spot inserts {hot_n / hot_s:.1f}/s "
            f"({hot_s:.2f} s, drain {drain_hot_s:.2f} s); deletes {deleted / delete_s:.1f}/s "
            f"({deleted} of {deletes + hot_n}, {delete_s:.2f} s); drain {drain_s:.2f} s; postings "
            f"{fresh.num_clusters}, overlay rows {fresh.storage.overlay_rows()}; counts {counts}")
        failures = []
        for op in ("split", "reassign"):
            if counts[f"lire.{op}.ok"] < 1:
                failures.append(f"no {op} completed")

        live = np.ones(n, bool)
        live[del_ids] = False
        all_data = np.concatenate([data[live], ins])
        all_ids = np.concatenate([np.arange(n)[live], ins_ids])
        _, gt_rows = brute_force_search(all_data, queries, 10, device=DEVICE, batch_size=4096)
        after, _ = fresh.search(queries, 10, nprobe=nprobe)
        rec = recall_at_k(after, all_ids[gt_rows], 10)
        dead = np.isin(after, np.concatenate([del_ids, hot_ids]))
        disk_log(f"disk live: recall@10 at nprobe={nprobe} before {rec_before:.4f}, after the "
            f"updates {rec:.4f} (exact ground "
            f"truth of the mutated corpus, {len(all_data)} rows); deleted ids returned "
            f"{int(dead.sum())}")
        if dead.any():
            failures.append("a deleted id was returned")
        try:
            assert_no_duplicates(after)
        except AssertionError as e:
            failures.append(str(e))
        mine, mine_ids = ins, ins_ids
        got, _ = fresh.search(mine, 10, nprobe=nprobe)
        miss = np.flatnonzero(~(got == mine_ids[:, None]).any(axis=1))
        ties, away, neither = lazy_visibility(fresh.storage, mine[miss], mine_ids[miss], nprobe)
        # A routed-away insert must still be stored where a search finds
        # it: one probing every posting (at most 64 of them, one batch).
        far = miss[away[:64]]
        found = fresh.search(mine[far], 10, nprobe=fresh.num_clusters)[0] if len(far) else \
            np.empty((0, 10), np.int64)
        lost = int((~(found == mine_ids[far, None]).any(axis=1)).sum())
        disk_log(f"disk live: {len(mine)} inserts searched "
            f"for their own vectors: {len(miss)} not in their top 10: {len(ties)} routing "
            f"near-ties, {len(away)} routed away (every home centroid farther than the "
            f"{nprobe}-th nearest, in f64), of which a full-probe search misses {lost} of "
            f"{len(far)}, and {len(neither)} neither")
        if neither or lost or len(away) > len(far):
            failures.append(f"inserts not visible: {len(neither)} with a home probed, {lost} "
                            "not found by a full probe")
        disk_log(f"disk live: float rerank launches in the phase's updates and searches: "
                 f"{rerank.launches}")

        def vec_of(i):
            return data[i] if i < n else ins[i - n]

        state = store_state(fresh.storage)
        fresh.close()
        t0 = time.perf_counter()
        fresh = LazySpFreshIndex(str(store), lire_config=lc, device=DEVICE)
        replay_s = time.perf_counter() - t0
        if store_state(fresh.storage) != state:
            failures.append("the reopened store (WAL replay) differs from the one closed")
        reopened, _ = fresh.search(queries, 10, nprobe=nprobe)
        differ = int((reopened != after).sum())
        disk_log(f"disk live: reopen (WAL replay) in {replay_s:.2f} s: {differ} of {after.size} "
                 "ids differ")
        unexplained = tie_explained(fresh.storage, vec_of, queries, after, reopened, nprobe,
                                    "disk live: reopen")
        t0 = time.perf_counter()
        fresh.compact()
        compact_s = time.perf_counter() - t0
        if store_state(fresh.storage) != state:
            failures.append("compact() changed the live postings")
        compacted, _ = fresh.search(queries, 10, nprobe=nprobe)
        differ_c = int((compacted != after).sum())
        disk_log(f"disk live: compact() in {compact_s:.2f} s: {differ_c} of {after.size} ids "
                 f"differ from before the reopen, {int((compacted != reopened).sum())} from after "
                 "it")
        unexplained += tie_explained(fresh.storage, vec_of, queries, after, compacted, nprobe,
                                     "disk live: compact")
        if unexplained:
            failures.append(f"reopen / compact changed {unexplained} rows without an f64 tie")
        assert not failures, f"disk live gates failed: {failures}"
    finally:
        fresh.close()


def phase_metric(torch, metric: str, n: int, nq: int, report, target) -> None:
    """A Manhattan or Chebyshev bf16 build of the GIST-width latent corpus
    through SpannIndexBuilder on the card, ground truth on the card, and
    the nprobe sweep (to recall@10 >= ``target``, or printed in full when
    ``target`` is None).  The L1/Linf kernel must run in the phase."""
    from spfresh_tpu_torch.index import Config, brute_force_search
    from spfresh_tpu_torch.ops import pairwise

    tag = metric.lower()
    t0 = time.perf_counter()
    data, queries = latent_mixture(12345, n, nq)
    log(f"{tag}: corpus n={n} d={GIST_D} latent={GIST_LATENT} nq={nq} made in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    cfg = Config.from_dict({
        "clustering_params": {
            "distance_metric": metric, "initialization_method": "KMeans++",
            "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 42,
        },
        "storage_dtype": "bfloat16",
        "search": {"query_batch_size": 8192},
    })
    pairwise.launches = 0
    index, view = build_logged(torch, cfg, data, tag)
    t0 = time.perf_counter()
    _, gt = brute_force_search(data, queries, 10, metric=metric, device=DEVICE, batch_size=4096)
    log(f"{tag}: exact ground truth on the card in {time.perf_counter() - t0:.2f} s")
    best = sweep(torch, index, queries, gt, tag, target=target)
    launches = pairwise.launches
    log(f"{tag}: L1/Linf pairwise kernel launches in the phase: {launches}")
    assert launches > 0, "the L1/Linf kernel did not run"
    kernel_rerank_view(torch, view, queries, best[0] if best else 48, metric, tag)
    if target is None:
        return
    assert best is not None, f"{tag}: recall@10 >= {target} not reached within nprobe <= 64"
    nprobe, rec, qps, ids = best
    assert_no_duplicates(ids)
    log(f"{tag}: recall point nprobe={nprobe} recall@10={rec:.4f} qps={qps:.1f}; "
        "no result row repeats an id")
    report["pairwise"]["launches"] = launches
    profile_search(torch, index, queries, nprobe, tag=f"profile {tag}")


def kernel_rerank_view(torch, view, queries, nprobe: int, metric: str, tag: str) -> None:
    """The rerank on a phase's own view and rows: its slabs (bf16 at d_pad
    128 in ``main``, 1,024 in ``manhattan`` and ``chebyshev``; int8 in
    ``large``), its first query batch (8,192) and the rows its stage 1
    probes at ``nprobe`` (the windowed scan in ``large``, whose int8 case
    takes the centered queries and ``view.scales[rows]`` as
    ``_search_padded`` builds them), against the plain version within
    RERANK_RTOL.  Logs how the slab-major schedule groups these rows, the
    kernel and plain times and the bound: the probed slabs once, the
    queries (int8: the centered block and scales), rows and output."""
    from spfresh_tpu_torch.ops import rerank
    from spfresh_tpu_torch.ops.topk import centroid_topk

    dev = torch.device(DEVICE)
    Q = min(8192, len(queries))
    qpad = torch.zeros((Q, view.d_pad), device=dev)
    qpad[:, : queries.shape[1]] = torch.from_numpy(queries[:Q]).to(dev)
    _, rows = centroid_topk(qpad.to(view.centroids.dtype), view.centroids, view.cent_valid,
                            nprobe, metric)
    slabs = view.vectors3d
    cpad, pad, d_pad = slabs.shape
    kw = {}
    if slabs.dtype == torch.int8:
        kw = dict(scales=view.scales[rows], centered_queries=qpad[:, None, :] - view.centroids[rows])
    rows = rows.to(torch.int32)
    rel, max_abs = rerank_compare(torch, qpad, rows, slabs, metric, **kw)
    assert rel <= RERANK_RTOL, f"{tag}: rerank {metric} rel err {rel} > {RERANK_RTOL}"
    ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances(qpad, rows, slabs, metric, **kw),
                 10)
    plain_ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances_plain(
        qpad, rows, slabs, metric, **kw), 1)
    probed = int(torch.unique(rows).numel())
    per_pair = 4 + pad * 4 + (d_pad * 4 + 4 if kw else 0)  # row, output (+ centered row, scale)
    b = bound(probed * pad * d_pad * slabs.element_size() + Q * d_pad * 4 + Q * nprobe * per_pair,
              (4 if kw else 3) * Q * nprobe * pad * d_pad, F32_FLOPS)
    gbps = probed * pad * d_pad * slabs.element_size() / (ms * 1e-3) / 1e9
    log(f"{tag}: kernel rerank on the phase's rows: Q={Q} nprobe={nprobe} pad={pad} "
        f"d_pad={d_pad} Cpad={cpad} {slabs.dtype} {metric} max_rel_err={rel:.3e} "
        f"max_abs_err={max_abs:.3e} (rtol {RERANK_RTOL}) kernel={ms:.4f} ms ({gbps:.0f} GB/s of "
        f"probed slabs) plain={plain_ms:.4f} ms bound={b['bound_ms']:.4f} ms ({b['bound_by']}); "
        f"{schedule_stats(torch, rows, cpad)}")
    # Small batches (the live phase searches 8 queries after each insert
    # batch; a 512 batch is the update pipeline's): the wrapper's time, the
    # schedule's alone (a fixed cost of every call) and the bound.
    group = rerank.kernel_geometry(d_pad, slabs.dtype)["group"]
    small = []
    for qs in (512, 8):
        r = rows[:qs].contiguous()
        sub = {key: val[:qs] for key, val in kw.items()}
        s_ms = cuda_ms(torch, lambda: rerank.padded_rerank_distances(qpad[:qs], r, slabs, metric,
                                                                     **sub), 20)
        sched_ms = cuda_ms(torch, lambda: rerank.rerank_schedule(r, cpad, group), 20)
        bs = bound(int(torch.unique(r).numel()) * pad * d_pad * slabs.element_size()
                   + qs * d_pad * 4 + qs * nprobe * per_pair,
                   (4 if kw else 3) * qs * nprobe * pad * d_pad, F32_FLOPS)
        small.append(f"Q={qs}: kernel={s_ms:.4f} ms (schedule alone {sched_ms:.4f} ms) "
                     f"bound={bs['bound_ms']:.4f} ms")
    log(f"{tag}: kernel rerank on the phase's rows, small batches: " + "; ".join(small))


def full_probe_check(torch, index, queries, nq: int = 8192, nsub: int = 64) -> None:
    """A full-probe search of ``nq`` queries in one batch of the phase's
    8,192: the candidate block of all probes would be nq x C x pad x 4 bytes
    for the distances alone, so the search takes the probe axis in chunks
    (``PROBE_CHUNK_BYTES``).  It must complete on the card, give finite
    distances and no repeated id, and its first ``nsub`` rows must equal an
    unchunked search of those queries (the budget monkeypatched up)."""
    from spfresh_tpu_torch.index import spann

    C = index.num_clusters
    view = index.padded_view()
    qs = queries[:nq]
    block = spann._probe_block
    calls = []  # probes of each block the search builds

    def counting(*a, **kw):
        calls.append(a[2].shape[1])
        return block(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    spann._probe_block = counting
    try:
        t0 = time.perf_counter()
        ids, dists = index.search(qs, 10, nprobe=C)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        spann._probe_block = block
    peak = torch.cuda.max_memory_allocated()
    chunk = max(calls)
    assert len(calls) > 1 and sum(calls) == C, (
        f"blocks of {calls[:4]}... probes: the full probe of {C} is not chunked")
    assert np.isfinite(dists).all() and (ids >= 0).all(), "full probe left an empty slot"
    assert_no_duplicates(ids)
    threshold = spann.PROBE_CHUNK_BYTES
    spann.PROBE_CHUNK_BYTES = 1 << 62
    try:
        torch.cuda.reset_peak_memory_stats()
        want, want_d = index.search(qs[:nsub], 10, nprobe=C)
        torch.cuda.synchronize()
        peak_one = torch.cuda.max_memory_allocated()
    finally:
        spann.PROBE_CHUNK_BYTES = threshold
    differ = int((ids[:nsub] != want).sum())
    log(f"main: full probe (nprobe={C}) of {len(qs)} queries in one batch: {chunk} probes per "
        f"chunk ({len(calls)} chunks), {wall:.2f} s, peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the index, "
        f"{(peak - base) / (len(qs) * chunk * view.pad):.1f} bytes per candidate of a chunk "
        f"against a budget of {spann._CAND_BYTES}; the "
        f"unchunked distances alone would be {len(qs) * C * view.pad * 4 / 2**30:.1f} GiB); "
        f"{differ} of {want.size} ids of {nsub} queries differ from an unchunked search "
        f"(peak {peak_one / 2**30:.2f} GiB)")
    assert differ == 0, f"{differ} ids differ between the chunked and unchunked full probe"
    np.testing.assert_array_equal(dists[:nsub], want_d)


def write_corpus(path, n: int, d: int, spread: float, seed: int):
    """benchmarks/outofcore_build_bench.py's gen_corpus: a mixture of
    max(64, min(n // 1000, 65536)) centers written to a memmap in 2^20-row
    chunks; returns the memmap opened read-only."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, min(n // 1000, 65536))
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, d))
    for s in range(0, n, 1 << 20):
        e = min(s + (1 << 20), n)
        a = rng.integers(0, n_centers, e - s)
        mm[s:e] = centers[a] + spread * rng.standard_normal((e - s, d)).astype(np.float32)
    mm.flush()
    del mm
    return np.memmap(path, dtype=np.float32, mode="r", shape=(n, d))


def phase_outofcore(torch, n: int, nq: int, report) -> None:
    """The out-of-core build of the bench's corpus through
    Config.build_sample_rows, its invariants, the nearest-centroid and
    replica kernels against their plain versions on a real tile, and a
    sweep through the windowed stage 1."""
    import gc
    import math
    import shutil
    from pathlib import Path

    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import (
        Config,
        LazySpannIndex,
        SpannIndexBuilder,
        brute_force_search,
    )
    from spfresh_tpu_torch.ops import centroid_scan, replica, rerank, topk

    path = Path(__file__).resolve().parent / "build" / "oc_corpus.f32"
    store = path.parent / OC_STORE
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        data = write_corpus(path, n, OC_D, 0.7, 12345)
        rng = np.random.default_rng(12345 + 1)
        qrows = rng.choice(n, size=nq, replace=False)
        queries = np.asarray(data[np.sort(qrows)]) + 0.1 * rng.standard_normal(
            (nq, OC_D)).astype(np.float32)
        log(f"outofcore: corpus n={n} d={OC_D} ({n * OC_D * 4 / 2**30:.2f} GiB memmap) and "
            f"{nq} queries made in {time.perf_counter() - t0:.2f} s (host)")
        cap = 256
        cfg = Config.from_dict({
            "clustering_params": {
                "distance_metric": "Euclidean", "initialization_method": "KMeans++",
                "initial_k": 16, "desired_cluster_size": cap, "rng_seed": 42,
            },
            "storage_dtype": "bfloat16",
            "build_sample_rows": OC_SAMPLE,
            "build_tile_rows": OC_TILE,
            "search": {"query_batch_size": 8192},
        })
        replica.launches = 0
        replica.nearest_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        builder = SpannIndexBuilder(cfg, device=DEVICE).with_data(data)
        index = builder.build(save=False)
        t_build = time.perf_counter() - t0
        counts = {"nearest_centroid": replica.nearest_launches, "replica": replica.launches}
        result = builder.outofcore
        log(f"outofcore: build wall={t_build:.3f} s clusters={index.num_clusters} "
            f"stored={index.num_vectors} (x{index.num_vectors / n:.4f}) sample={result.sample_rows} "
            f"splits={result.num_splits}; kernel launches {counts}")
        log("outofcore: build phases " + " ".join(
            f"{k}={v:.3f}" for k, v in sorted(index.build_profile.items(), key=lambda kv: -kv[1])))
        tiles = math.ceil(n / OC_TILE)
        assert counts["nearest_centroid"] == tiles, (counts, tiles)
        assert counts["replica"] >= tiles, counts  # the sample fit's pass, then one per tile
        # Both entries time this phase's tile, so their launches are this
        # phase's (main's replica launch is asserted there).
        report["nearest_centroid"]["launches"] = counts["nearest_centroid"]
        report["replica"]["launches"] = counts["replica"]

        # Invariants: one base posting per row, each posting within its budget.
        base = result.base
        C = len(result.clusters)
        assert base.shape == (n,) and base.min() >= 0 and base.max() < C
        limit = math.ceil(cfg.replica_overflow * cap)
        sizes = np.array([len(c) for c in result.clusters])
        assert sizes.max() <= limit, f"a posting holds {sizes.max()} > {limit} members"
        cls = np.repeat(np.arange(C, dtype=np.int64), sizes)
        pts = np.concatenate([c.points for c in result.clusters])
        member = np.zeros(n, np.int64)
        np.add.at(member, pts, 1)
        pair = np.sort(cls * n + pts)
        want = base.astype(np.int64) * n + np.arange(n)
        found = pair[np.minimum(np.searchsorted(pair, want), len(pair) - 1)] == want
        assert found.all(), f"{int((~found).sum())} rows miss their base posting"
        assert member.min() >= 1 and member.max() <= cfg.max_replicas
        log(f"outofcore: every row sits in its base posting and in 1..{member.max()} postings; "
            f"largest posting {sizes.max()} <= ceil({cfg.replica_overflow} * {cap}) = {limit}")

        kernel_nearest(torch, data, result, OC_TILE, report)
        kernel_replica_tile(torch, data, index, result, cfg.to_clustering_params(), OC_TILE,
                            report)

        t0 = time.perf_counter()
        view = index.padded_view()
        torch.cuda.synchronize()
        log(f"outofcore: padded_view from the host corpus in {time.perf_counter() - t0:.2f} s "
            f"slabs={tuple(view.vectors3d.shape)} {view.vectors3d.dtype}")
        assert index.num_clusters > topk.LARGE_C_THRESHOLD
        t0 = time.perf_counter()
        _, gt = brute_force_search(data, queries, 10, device=DEVICE, batch_size=4096)
        log(f"outofcore: exact ground truth on the card in {time.perf_counter() - t0:.2f} s")
        centroid_scan.launches = 0
        sweep(torch, index, queries, gt, "outofcore", target=None)
        assert centroid_scan.launches > 0, "the windowed stage 1 did not run"
        report["centroid_scan"]["launches"] += centroid_scan.launches  # after large's

        # The DEEP-shaped serving path: the index saved packed, the
        # in-memory index and view released, then served from disk.
        mem_ids, _ = index.search(queries, 10, nprobe=OC_NPROBE)
        rec_mem = recall_at_k(mem_ids, gt, 10)
        slab_bytes = view.vectors3d.numel() * view.vectors3d.element_size()
        save_packed(index, store, "outofcore")
        del index, view, builder, result, mem_ids
        gc.collect()
        torch.cuda.empty_cache()
        centroid_scan.launches = rerank.launches = rerank.quantized_launches = 0
        with LazySpannIndex(str(store), prefetch_threads=2, device=DEVICE) as lazy:
            ids, qps2, peak, peak_abs = lazy_timed(torch, lazy, queries, OC_NPROBE, 64,
                                                   "outofcore")
        counts = {"centroid_scan": centroid_scan.launches, "rerank": rerank.launches,
                  "rerank_int8": rerank.quantized_launches}
        with LazySpannIndex(str(store), prefetch_threads=0, device=DEVICE) as lazy0:
            ids0, qps0, _, _ = lazy_timed(torch, lazy0, queries[:TIMING_NQ], OC_NPROBE, 64,
                                          "outofcore")
        rec = recall_at_k(ids, gt, 10)
        log(f"outofcore: lazy kernel launches {counts}; recall@10 at nprobe={OC_NPROBE}: lazy "
            f"{rec:.4f}, in-memory {rec_mem:.4f}; QPS batch 64 prefetch 2 / 0: {qps2:.1f} / "
            f"{qps0:.1f}; peak {peak / 2**20:.1f} MiB above start ({peak_abs / 2**20:.1f} MiB "
            f"in all) against the released view's slabs {slab_bytes / 2**20:.1f} MiB")
        assert counts["centroid_scan"] > 0 and counts["rerank"] > 0, counts
        assert_no_duplicates(ids)
        assert abs(rec - rec_mem) <= 0.01, (rec, rec_mem)
        assert int((ids0 != ids[:TIMING_NQ]).sum()) == 0, "prefetch 0 and 2 returned different ids"
        assert peak_abs < slab_bytes / 8, (peak_abs, slab_bytes)
        differ = lazy_cpu_ids(store, queries[:1000], OC_NPROBE, "outofcore", ids[:1000])
        assert differ <= ids[:1000].size // 1000, f"{differ} ids differ from the CPU path"
    finally:
        path.unlink(missing_ok=True)
        shutil.rmtree(store, ignore_errors=True)


def kernel_nearest(torch, data, result, rows: int, report=None) -> None:
    """The nearest-centroid kernel on the build's first tile (``rows``
    rows) against its plain version, with the centroid set the streamed
    base pass launched with (the sample fit's, bf16, as the build streams
    them); its times go into ``report`` when one is given.  Ids must
    agree except at f32 near-ties: a differing row's two centroids must be
    within TIE_TOL of (|x|^2 + |c|^2) in f64.  Where the ids agree, the
    distances must agree within NEAREST_RTOL of |x|^2 + |c|^2."""
    from spfresh_tpu_torch.ops import replica

    dev = torch.device(DEVICE)
    cents = torch.from_numpy(np.asarray(data[result.sample_centroid_rows]))
    cents = cents.to(dev).to(torch.bfloat16)
    X = torch.from_numpy(np.array(data[:rows])).to(dev).to(torch.bfloat16)
    n, C, d = X.shape[0], cents.shape[0], X.shape[1]
    kb, kd = replica.nearest_centroid(X, cents)
    pb, pd = replica.nearest_centroid_plain(X, cents)
    torch.cuda.synchronize()
    kb, kd, pb, pd = (t.cpu().numpy() for t in (kb, kd, pb, pd))
    Xh = X.float().cpu().numpy().astype(np.float64)
    Ch = cents.float().cpu().numpy().astype(np.float64)
    differ, gap, max_abs, max_rel = nearest_compare(Xh, Ch, kb, kd, pb, pd)
    ms = cuda_ms(torch, lambda: replica.nearest_centroid(X, cents), 5)
    plain_ms = cuda_ms(torch, lambda: replica.nearest_centroid_plain(X, cents), 2)
    g_ms = gemm_ms(torch, [X], cents, 3)
    tflops = 2 * n * C * d / (ms * 1e-3) / 1e12
    b = bound((n + C) * d * 2 + n * 8, 2 * n * C * d, BF16_FLOPS)
    log(f"kernel nearest_centroid: n={n} C={C} (the sample fit's) d={d} bf16 ids "
        f"differing={differ} (all f64 near-ties, max gap {gap:.2e} of |x|^2+|c|^2) "
        f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} of |x|^2+|c|^2 (rtol "
        f"{NEAREST_RTOL}) kernel={ms:.4f} ms ({tflops:.2f} TFLOP/s) plain={plain_ms:.4f} ms "
        f"gemm_ms={g_ms:.4f} bound={b['bound_ms']:.4f} ms")
    if report is None:
        return
    near = report["nearest_centroid"]  # the error stays the worst of every check
    near.update({"max_abs_err": max(near["max_abs_err"], max_abs), "ms": ms,
                 "plain_ms": plain_ms, "library_ms": None, **b})


def nearest_compare(Xh, Ch, kb, kd, pb, pd):
    """Kernel vs plain nearest centroids (f64 copies of the inputs).  Ids
    must agree except at f32 near-ties: a differing row's two centroids
    within TIE_TOL of (|x|^2 + |c|^2) in f64; where they agree, distances
    within NEAREST_RTOL of |x|^2 + |c|^2.  Returns (rows differing, max
    gap, max abs error, max rel error)."""
    same = kb == pb
    scale = (Xh ** 2).sum(1) + (Ch[kb] ** 2).sum(1)  # the size of the expansion's terms
    err = np.abs(kd - pd)[same]
    max_abs = float(err.max())
    max_rel = float((err / scale[same]).max())
    assert max_rel <= NEAREST_RTOL, (
        f"nearest distances: rel err {max_rel} of |x|^2+|c|^2 > {NEAREST_RTOL}")
    gaps = []
    for r in np.flatnonzero(~same):
        dk = float(((Xh[r] - Ch[kb[r]]) ** 2).sum())
        dp = float(((Xh[r] - Ch[pb[r]]) ** 2).sum())
        gaps.append(abs(dk - dp) / scale[r])
        assert gaps[-1] <= TIE_TOL, f"nearest row {r}: ids {kb[r]} vs {pb[r]} without a near-tie"
    return int((~same).sum()), max(gaps, default=0.0), max_abs, max_rel


def kernel_replica_tile(torch, data, index, result, params, rows: int, report=None) -> None:
    """The replica kernel as the streamed replica pass launches it: the
    build's first tile (``rows`` rows), its final (post-rebalance)
    centroids, the tile's base clusters and ``db`` supplied, the build's
    n_extra, threshold and SOAR lambda; against the plain version with
    replica_compare.  Its times and bound go into ``report`` when one is
    given: the out-of-core build launches this shape once per tile."""
    from spfresh_tpu_torch.ops import replica

    dev = torch.device(DEVICE)
    cents = torch.from_numpy(np.stack([index.centroids[c] for c in sorted(index.centroids)]))
    cents = cents.to(dev).to(torch.bfloat16)
    X = torch.from_numpy(np.array(data[:rows])).to(dev).to(torch.bfloat16)
    n, C, d = X.shape[0], cents.shape[0], X.shape[1]
    base = torch.from_numpy(np.ascontiguousarray(result.base[:rows], np.int32)).to(dev)
    db = ((X.float() - cents[base.long()].float()) ** 2).sum(1)
    n_extra = min(params.max_replicas - 1, C - 1)
    bt = float(np.float32(params.boundary_threshold))
    lam = float(params.soar_lambda or 0.0)

    def kernel():
        return replica.replica_topk(X, base, cents, bt, n_extra, db=db, soar_lambda=lam)

    def plain():
        return replica.replica_topk_plain(X, base, cents, bt, n_extra, db=db, soar_lambda=lam)

    ki, kr = kernel()
    pi, pr = plain()
    torch.cuda.synchronize()
    ki, kr, pi, pr = (t.cpu().numpy() for t in (ki, kr, pi, pr))
    tie_rows, max_abs, max_rel = replica_compare(
        X.float().cpu().numpy().astype(np.float64), base.cpu().numpy(),
        cents.float().cpu().numpy().astype(np.float64), bt, ki, kr, pi, pr, lam)
    admitted = int(np.isfinite(kr).sum())
    assert admitted > n // 10, f"only {admitted} replicas admitted: degenerate check"
    ms = cuda_ms(torch, kernel, 3)
    plain_ms = cuda_ms(torch, plain, 1)
    g_ms = gemm_ms(torch, [X, cents[base.long()]], cents, 2)
    b = bound((n + C) * d * 2 + n * 8 + n * n_extra * 8, 4 * n * C * d, BF16_FLOPS)
    log(f"kernel replica (db given): n={n} C={C} (the final set) d={d} bf16 n_extra={n_extra} "
        f"lambda={lam} admitted={admitted} near_tie_rows={tie_rows} "
        f"max_rank_rel_err={max_rel:.3e} max_rank_abs_err={max_abs:.3e} (rtol {REPLICA_RTOL}) "
        f"kernel={ms:.4f} ms ({4 * n * C * d / (ms * 1e-3) / 1e12:.2f} TFLOP/s) "
        f"plain={plain_ms:.4f} ms gemm_ms={g_ms:.4f} bound={b['bound_ms']:.4f} ms")
    if report is None:
        return
    report["replica"].update({"max_abs_err": max(report["replica"]["max_abs_err"], max_abs),
                              "ms": ms, "plain_ms": plain_ms, **b})


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
    large_lazy(torch, index, view, queries, gt, nprobe, rec)
    profile_search(torch, index, queries, nprobe, tag="profile large")
    kernel_rerank_view(torch, view, queries, nprobe, "Euclidean", "large")
    large_int8mxu(torch, index, view, queries, nprobe, report)
    compare_bf16(torch, cfg, data, queries, gt, index, (nprobe, 2 * nprobe))


def large_lazy(torch, index, view, queries, gt, nprobe: int, rec_mem: float) -> None:
    """The phase's int8 index saved packed and searched from disk on the
    card: the windowed stage 1 and the quantized rerank of staged slabs."""
    import shutil
    from pathlib import Path

    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import LazySpannIndex
    from spfresh_tpu_torch.ops import centroid_scan, rerank

    store = Path(__file__).resolve().parent / "build" / LARGE_STORE
    try:
        save_packed(index, store, "large")
        slab_bytes = view.vectors3d.numel() * view.vectors3d.element_size()
        rerank.launches = rerank.quantized_launches = centroid_scan.launches = 0
        with LazySpannIndex(str(store), prefetch_threads=2, device=DEVICE) as lazy:
            ids, qps, peak, _ = lazy_timed(torch, lazy, queries, nprobe, 64, "large")
        counts = {"centroid_scan": centroid_scan.launches,
                  "rerank_int8": rerank.quantized_launches, "rerank": rerank.launches}
        rec = recall_at_k(ids, gt, 10)
        log(f"large: lazy int8 kernel launches {counts}; recall@10 at nprobe={nprobe}: lazy "
            f"{rec:.4f}, in-memory {rec_mem:.4f}; {qps:.1f} QPS; peak above start "
            f"{peak / 2**20:.1f} MiB against the in-memory view's slabs {slab_bytes / 2**20:.1f} "
            "MiB")
        assert counts["centroid_scan"] > 0 and counts["rerank_int8"] > 0, counts
        assert_no_duplicates(ids)
        assert abs(rec - rec_mem) <= 0.01, (rec, rec_mem)
        differ = lazy_cpu_ids(store, queries[:1000], nprobe, "large", ids[:1000])
        assert differ <= ids[:1000].size // 1000, f"{differ} ids differ from the CPU path"
    finally:
        shutil.rmtree(store, ignore_errors=True)


def expansion_topk(torch, view, codesT, norms2, queries, nprobe: int, k: int = 10,
                   elementwise: bool = False):
    """Top-k ids per query over ``view``'s probed slabs, scored by the
    expansion-form scorer (or, ``elementwise``, by the int8 rerank of the
    search path), masked and deduplicated as the search does, in batches of
    8,192 queries.  Returns (ids (Q, k) numpy, the last batch's kernel
    inputs)."""
    from spfresh_tpu_torch.ops import rerank
    from spfresh_tpu_torch.ops.topk import centroid_topk, smallest_k_unique

    dev = torch.device(DEVICE)
    out, last = [], None
    for s in range(0, len(queries), 8192):
        q = torch.zeros((min(8192, len(queries) - s), view.d_pad), device=dev)
        q[:, : queries.shape[1]] = torch.from_numpy(queries[s : s + 8192]).to(dev)
        cent_d, rows = centroid_topk(q, view.centroids, view.cent_valid, nprobe, "Euclidean")
        rows32 = rows.to(torch.int32)
        if elementwise:
            qc = q[:, None, :] - view.centroids[rows]
            dist = rerank.padded_rerank_distances(q, rows32, view.vectors3d, "Euclidean",
                                                  scales=view.scales[rows], centered_queries=qc)
        else:
            qcodes, qscale, qnorm2 = rerank.quantize_centered_queries(q, view.centroids, rows32)
            last = (qcodes, qscale, qnorm2, rows32, codesT, norms2, view.scales)
            dist = rerank.padded_rerank_distances_int8mxu(*last)
        ar = torch.arange(view.pad, device=dev)
        valid = (ar < view.lens[rows][..., None]) & torch.isfinite(cent_d)[..., None]
        cand = torch.where(valid, view.ids2d[rows], torch.full_like(view.ids2d[rows], -1))
        dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
        _, ids = smallest_k_unique(dist.reshape(len(q), -1), cand.reshape(len(q), -1), k,
                                   max_dup=view.max_dup)
        out.append(ids.cpu().numpy())
    return np.concatenate(out), last


def large_int8mxu(torch, index, view, queries, nprobe: int, report) -> None:
    """The expansion-form scorer over the large phase's own int8 view: its
    codes transposed to (Cpad, d_pad, pad) and |r|^2 built on the card; the
    phase's queries scored at its operating nprobe with stage-1 rows from
    its search (the path, counted), the kernel against its plain version
    on the last batch, and how many of each query's top-10 candidates match
    the elementwise int8 rerank's over the same rows (printed, no gate)."""
    from spfresh_tpu_torch.ops import rerank

    t0 = time.perf_counter()
    codesT, norms2 = transposed_codes(torch, view.vectors3d)
    torch.cuda.synchronize()
    log(f"large int8mxu: codes {tuple(view.vectors3d.shape)} -> {tuple(codesT.shape)} and "
        f"|r|^2 {tuple(norms2.shape)} in {time.perf_counter() - t0:.2f} s")
    rerank.int8mxu_launches = 0
    mxu_ids, last = expansion_topk(torch, view, codesT, norms2, queries, nprobe)
    launches = rerank.int8mxu_launches
    assert launches > 0, "the int8mxu scorer did not run"
    report["rerank_int8mxu"]["launches"] = launches
    max_abs, ms, plain_ms = int8mxu_check(torch, last, "large int8mxu")
    Q, np_, d, pad = last[0].shape[0], nprobe, codesT.shape[1], codesT.shape[2]
    b = int8mxu_bound(last[3], Q, np_, d, pad)
    elem_ids, _ = expansion_topk(torch, view, codesT, norms2, queries, nprobe, elementwise=True)
    match = np.array([len(set(a[a >= 0].tolist()) & set(e[e >= 0].tolist()))
                      for a, e in zip(mxu_ids, elem_ids)])
    log(f"large int8mxu: {launches} launches scoring {len(queries)} queries at nprobe={nprobe}; "
        f"last batch Q={Q} Cpad={codesT.shape[0]} d_pad={d} pad={pad}: max_abs_err={max_abs:.3e} "
        f"(bit-equal to the plain version); kernel={ms:.4f} ms "
        f"plain={plain_ms:.4f} ms bound={b['bound_ms']:.4f} ms ({b['bound_by']}, "
        f"{b['probed']} slabs probed); "
        f"{int8mxu_schedule_note(torch, last[3], codesT.shape[0], d, pad)}")
    log(f"large int8mxu: top-10 candidates shared with the elementwise int8 rerank: "
        f"mean {match.mean():.4f} of 10, min {match.min()}, "
        f"{int((match == 10).sum())} of {len(match)} queries all 10")
    del codesT, norms2, last


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
             if any(k in e.key for k in ("rerank_kernel<", "window_scan_kernel<",
                                         "l1_linf_kernel<", "topk_select_kernel<"))]
    assert not any(e.key == "aten::topk" and e.self_device_time_total > 0 for e in events), (
        f"{tag}: torch.topk ran on the card; every select is the row-select kernel's")
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
    for metric in ("Manhattan", "Chebyshev"):
        exact_metric(torch, metric)


def exact_metric(torch, metric: str) -> None:
    """Full-probe search of a 20k x 960 f32 index must return the exact
    top-10 ids.  A miss is allowed only as a tie with the 10th true
    neighbour: exact in f32 for Chebyshev (both sides take the maximum of
    the same f32 |x - y|), within f32 rounding (rel 1e-6, in f64) for
    Manhattan, whose sums run in another order."""
    from spfresh_tpu_torch.eval import recall_at_k
    from spfresh_tpu_torch.index import Config, SpannIndexBuilder, brute_force_search

    data, queries = latent_mixture(7, 20_000, 200)
    cfg = Config.from_dict({
        "clustering_params": {"distance_metric": metric, "initialization_method": "KMeans++",
                              "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 3},
        "storage_dtype": "float32",
    })
    index = SpannIndexBuilder(cfg, device=DEVICE).with_data(data).build(save=False)
    ids, _ = index.search(queries, 10, nprobe=index.num_clusters)
    gd, gt = brute_force_search(data, queries, 10, metric=metric, device=DEVICE)
    assert_no_duplicates(ids)
    ties = []
    for q in range(len(queries)):
        for j in set(ids[q].tolist()) - set(gt[q].tolist()):
            diff = np.abs(data[j] - queries[q])  # f32, as both sides compute it
            kth = gd[q, -1]
            if metric == "Chebyshev":
                dj = float(diff.max())
                assert dj == float(kth), f"exact {metric}: query {q} id {j} is no tie"
            else:
                dj = float(np.abs(data[j].astype(np.float64) - queries[q]).sum())
                dk = float(np.abs(data[gt[q, -1]].astype(np.float64) - queries[q]).sum())
                assert abs(dj - dk) <= 1e-6 * dk, f"exact {metric}: query {q} id {j} is no tie"
            ties.append((q, j, dj, float(kth)))
    rec = recall_at_k(ids, gt, 10)
    log(f"exact: n=20000 d={GIST_D} f32 {metric} clusters={index.num_clusters} full-probe "
        f"id-recall@10={rec} (200 queries); misses {len(ties)}, all ties: {ties[:5]}")


# -- fuzz: the JAX package's model fuzzers, on the card -----------------------


def same_sets(a, b, tag: str) -> None:
    """Each result row of ``a`` holds the ids of ``b``'s, in any order."""
    rows = [r for r in range(len(a)) if set(a[r].tolist()) != set(b[r].tolist())]
    assert not rows, f"{tag}: {len(rows)} rows differ, first {rows[0]}: {a[rows[0]]} vs {b[rows[0]]}"


def same_search(index, oracle, queries, k: int, nprobe: int, tag: str) -> None:
    """The in-place view of ``index`` searches as ``oracle``'s fresh pack:
    the same result sets and, row by row, the same distances (the same
    slab values)."""
    got, got_d = index.search(queries, k, nprobe=nprobe)
    want, want_d = oracle.search(queries, k, nprobe=nprobe)
    same_sets(got, want, tag)
    assert np.array_equal(np.sort(got_d, axis=1), np.sort(want_d, axis=1)), f"{tag}: distances"


def fresh_pack(index):
    """A copy of ``index``'s postings on the card, its view packed from
    scratch at its first search: the oracle of the in-place view."""
    from spfresh_tpu_torch.interop import from_jax_state

    return from_jax_state(index.postings, index.centroids, index.dim, index.config.to_dict(),
                          device=DEVICE)


def view_mutation(index, rng, next_vid: int, spread: float, scale: float) -> int:
    """One random mutation of tests/test_view_update_fuzz.py's kinds and
    odds: members appended near the centroid (``spread``), one member
    rewritten as a fresh id, members shrunk, a new posting (centroid drawn
    at ``scale``), a posting removed, a centroid moved.  Returns the next
    free vid."""
    d = index.dim
    op = rng.choice(["append", "rewrite", "shrink", "new", "remove", "centroid"],
                    p=[0.3, 0.15, 0.2, 0.12, 0.08, 0.15])
    cids = sorted(index.postings)
    if op == "append":
        c = int(rng.choice(cids))
        ids, vecs = index.postings[c]
        kk = int(rng.integers(1, 5))
        add = (index.centroids[c][None, :] + spread * rng.standard_normal((kk, d)))
        index.replace_posting(c, np.concatenate([ids, np.arange(next_vid, next_vid + kk)]),
                              np.concatenate([np.asarray(vecs, np.float32),
                                              add.astype(np.float32)]),
                              centroid=index.centroids[c])
        next_vid += kk
    elif op == "rewrite":  # a value change ships as a fresh id
        c = int(rng.choice(cids))
        ids, vecs = index.postings[c]
        ids, vecs = np.asarray(ids).copy(), np.asarray(vecs, np.float32).copy()
        if len(ids):
            j = int(rng.integers(len(ids)))
            vecs[j] = vecs[j] + 0.05
            ids[j] = next_vid
            next_vid += 1
        index.replace_posting(c, ids, vecs)
    elif op == "shrink":
        c = int(rng.choice(cids))
        ids, vecs = index.postings[c]
        if len(ids) > 2:
            keep = len(ids) - int(rng.integers(1, min(4, len(ids) - 1)))
            index.replace_posting(c, ids[:keep], np.asarray(vecs, np.float32)[:keep])
    elif op == "new":
        kk = int(rng.integers(2, 6))
        cent = (scale * rng.standard_normal(d)).astype(np.float32)
        vs = (cent[None, :] + spread * rng.standard_normal((kk, d))).astype(np.float32)
        index.add_cluster(vs, np.arange(next_vid, next_vid + kk), cent)
        next_vid += kk
    elif op == "remove" and len(cids) > 3:
        index.remove_cluster(int(rng.choice(cids)))
    elif op == "centroid":
        c = int(rng.choice(cids))
        index.replace_posting(c, *index.postings[c], centroid=(
            index.centroids[c] + 0.1 * rng.standard_normal(d)).astype(np.float32))
    return next_vid


def scales_in_step(index, tag: str) -> None:
    """The live int8 view's host copy of its scales (the append path's
    scale guard reads it) equals its device scales; the view is read as it
    stands, refreshed only by the checks' searches."""
    from spfresh_tpu_torch.index import SpannIndex

    view = index._padded_view
    host = SpannIndex._view_scales_host(view)
    assert np.array_equal(host, view.scales.cpu().numpy()), f"{tag}: scales_host drifted"


def fuzz_view_small(scratch, sd: str, seed: int) -> int:
    """tests/test_view_update_fuzz.py's case (seed, storage dtype) on the
    card: its corpus, 40 mutations, every 6th a full-probe and an
    nprobe-2 search of the in-place view against a view packed from
    scratch (same_search).  Returns the checks."""
    from spfresh_tpu_torch.index import Config, SpannIndexBuilder

    rng = np.random.default_rng(5000 + seed)
    centers = 3.0 * rng.standard_normal((6, 8)).astype(np.float32)
    data = (centers[rng.integers(0, 6, 300)] + 0.2 * rng.standard_normal((300, 8)))
    data = data.astype(np.float32)
    cfg = Config.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": 50, "rng_seed": 42},
        "output_path": str(scratch / f"vf_{sd}_{seed}"), "storage_dtype": sd})
    index = SpannIndexBuilder(cfg, device=DEVICE).with_data(data).build(save=False)
    queries = np.concatenate([data[:6], 3.0 * rng.standard_normal((4, 8))]).astype(np.float32)
    checks = 0

    def check(tag):
        nonlocal checks
        oracle = fresh_pack(index)
        same_search(index, oracle, queries, 8, index.num_clusters, tag)
        same_search(index, oracle, queries, 8, 2, f"{tag} nprobe 2")  # the centroids route alike
        checks += 1

    index.padded_view()
    next_vid = 50_000
    for step in range(40):
        next_vid = view_mutation(index, rng, next_vid, 0.2, 3.0)
        tag = f"fuzz view sd={sd} seed={seed} step={step}"
        if sd == "int8":
            scales_in_step(index, tag)
        if step % 6 == 5:
            check(tag)
    check(f"fuzz view sd={sd} seed={seed} final")
    return checks


def fuzz_view_real(torch, scratch, n: int) -> None:
    """The view fuzz at a real size: main's config (bf16, cap 256) on n
    rows of main's generator, FUZZ_REAL_STEPS mutations of the same kinds
    (members at the corpus spread), and every FUZZ_REAL_EVERY steps the
    in-place view's full-probe result sets and distances on 256 queries
    against a view packed from scratch; then an nprobe-8 search of 1,024
    queries with the same ids from both."""
    from spfresh_tpu_torch.index import Config, SpannIndexBuilder
    from spfresh_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    data, queries = mixture(777, n, 1024)
    cfg = Config.from_dict({**main_config(), "output_path": str(scratch / "vf_real")})
    index = SpannIndexBuilder(cfg, device=DEVICE).with_data(data).build(save=False)
    index.padded_view()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(6000)
    next_vid = 10 * n
    before = live_counts(metrics)
    check_s = 0.0
    for step in range(FUZZ_REAL_STEPS):
        next_vid = view_mutation(index, rng, next_vid, 0.7, 1.0)
        if step % FUZZ_REAL_EVERY == FUZZ_REAL_EVERY - 1:
            t1 = time.perf_counter()
            same_search(index, fresh_pack(index), queries[:256], 10, index.num_clusters,
                        f"fuzz view real step={step}")
            check_s += time.perf_counter() - t1
    got, _ = index.search(queries, 10, nprobe=8)
    want, _ = fresh_pack(index).search(queries, 10, nprobe=8)
    differ = int((got != want).sum())
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in live_counts(metrics).items() if k.startswith("view.")}
    inplace = moved["view.incremental_updates"]
    log(f"fuzz view real: {n} x 128 bf16, {index.num_clusters} postings after "
        f"{FUZZ_REAL_STEPS} mutations; {FUZZ_REAL_STEPS // FUZZ_REAL_EVERY} full-probe checks of "
        f"256 queries equal a fresh pack's; nprobe 8 on 1,024 queries: {differ} ids differ; "
        f"the in-place view's refreshes {moved}; build {build_s:.2f} s, checks {check_s:.2f} s, "
        f"wall {time.perf_counter() - t0:.2f} s")
    assert inplace > 0, "the real-size view never refreshed in place"
    assert differ == 0, f"nprobe 8: {differ} ids differ from a fresh pack"


def fuzz_model(scratch, tier: str, sd: str, seed: int, steps: int) -> int:
    """tests/test_spfresh_model_fuzz.py (tier "ram": SpFreshIndex) or
    tests/test_fresh_model_fuzz.py (tier "disk": LazySpFreshIndex, with
    compact and reopen) on the card: their corpora, seeds and odds, a dict
    ``vid -> vector`` as the model.  After every flush: the storage live
    set (and for "ram" the search mirror) equals the model with the
    inserted vectors, no deleted vid is back, and a full-probe
    self-query finds each of 4 vids (distance < 1e-4 for float slabs).
    Returns the checks."""
    from spfresh_tpu_torch.index import Config, SpannIndexBuilder
    from spfresh_tpu_torch.lire import LazySpFreshIndex, LireConfig, SpFreshIndex

    disk = tier == "disk"
    rng = np.random.default_rng((3000 if disk else 4000) + seed)
    data = 2.0 * rng.standard_normal((150, 8)).astype(np.float32)
    out = scratch / f"fz_{tier}_{sd}_{seed}"
    cfg = Config.from_dict({
        "storage_dtype": sd, "output_path": str(out),
        "clustering_params": {"initial_k": 4, "desired_cluster_size": 30, "rng_seed": 42,
                              "max_replicas": 2}})
    index = SpannIndexBuilder(cfg, device=DEVICE).with_data(data).build(save=disk)
    lire = LireConfig(max_partition_size=60, min_partition_size=2)

    def open_index():
        if disk:
            return LazySpFreshIndex(str(out), lire_config=lire, device=DEVICE)
        return SpFreshIndex(index, str(scratch / f"lire_{sd}_{seed}"), lire)

    def live(fresh):
        lives = [store_live(fresh.storage)]
        if not disk:  # the search mirror
            lives.append({int(v): x for v, x in zip(*live_vectors(fresh.index))})
        return lives

    checks = 0

    def check(fresh, tag):
        nonlocal checks
        fresh.flush()
        for got in live(fresh):
            assert set(got) == set(model), (f"{tag}: missing {sorted(set(model) - set(got))[:8]} "
                                            f"extra {sorted(set(got) - set(model))[:8]}")
            assert all(np.array_equal(got[v], x) for v, x in model.items()), f"{tag}: vectors"
            assert not set(got) & deleted, f"{tag}: a deleted vid came back"
        probe = list(model.items())[:4]
        if probe:
            ids, d = fresh.search(np.stack([v for _, v in probe]), 1,
                                  nprobe=fresh.num_clusters if disk else fresh.index.num_clusters)
            assert [int(i) for i in ids[:, 0]] == [v for v, _ in probe], f"{tag}: self-query"
            if sd != "int8":
                assert float(d.max()) < 1e-4, f"{tag}: self-distance {d.max()}"
        checks += 1

    fresh = open_index()
    model = store_live(fresh.storage)
    deleted: set = set()
    next_vid = 10_000
    ops = ["insert", "insert_batch", "delete", "delete_batch"] + (["compact", "reopen"]
                                                                   if disk else [])
    odds = [0.35, 0.2, 0.2, 0.1, 0.08, 0.07] if disk else [0.4, 0.2, 0.27, 0.13]
    every = 12 if disk else 15
    try:
        for step in range(steps):
            op = rng.choice(ops, p=odds)
            if op == "insert":
                v = 2.0 * rng.standard_normal(8).astype(np.float32)
                fresh.insert(v, next_vid)
                model[next_vid] = v
                next_vid += 1
            elif op == "insert_batch":
                kk = int(rng.integers(2, 12))
                vs = 2.0 * rng.standard_normal((kk, 8)).astype(np.float32)
                fresh.insert_batch(vs, list(range(next_vid, next_vid + kk)))
                model.update(zip(range(next_vid, next_vid + kk), vs))
                next_vid += kk
            elif op == "delete" and model:
                vid = int(rng.choice(sorted(model)))
                fresh.delete(vid)
                model.pop(vid)
                deleted.add(vid)
            elif op == "delete_batch" and model:
                vids = [int(v) for v in rng.permutation(sorted(model))[:4]]
                fresh.delete_batch(vids)
                for vid in vids:
                    model.pop(vid)
                    deleted.add(vid)
            elif op == "compact":
                fresh.compact()
            elif op == "reopen":
                fresh.flush()
                fresh.close()
                fresh = open_index()
            if step % every == every - 1:
                check(fresh, f"fuzz {tier} sd={sd} seed={seed} step={step}")
        check(fresh, f"fuzz {tier} sd={sd} seed={seed} final")
        if disk:  # everything survives one more reopen
            fresh.close()
            fresh = open_index()
            check(fresh, f"fuzz {tier} sd={sd} seed={seed} post-final-reopen")
    finally:
        fresh.close()
    return checks


def store_live(storage) -> dict:
    """{vid: vector} over a LIRE store's live entries (replicas collapse)."""
    out = {}
    for pid in storage.posting_ids():
        ids, vecs, _ = storage.get_posting(pid)
        out.update((int(v), np.asarray(x, np.float32)) for v, x in zip(ids, vecs))
    return out


def fuzz_stress(scratch, tier: str, wall: float) -> str:
    """tests/test_concurrent_stress.py on the card: searchers running full
    probes nonstop, a mutator (inserts, deletes, batch deletes of its own
    vids) and, for tier "disk", a compactor on a thread of its own, for
    ``wall`` seconds.  Gates: no thread raises or wedges, no vid deleted
    before a search began is returned by it, no row repeats an id, the
    anchor (vid 0) stays findable, and the flushed live set is the
    build's plus the inserts less the confirmed deletes."""
    import threading
    import traceback

    from spfresh_tpu_torch.index import Config, SpannIndexBuilder
    from spfresh_tpu_torch.lire import LazySpFreshIndex, LireConfig, LireStorageError, SpFreshIndex

    disk = tier == "disk"
    data = 2.0 * np.random.default_rng(0).standard_normal((200, 8)).astype(np.float32)
    out = scratch / f"cc_{tier}"
    cfg = Config.from_dict({"output_path": str(out), "clustering_params": {
        "initial_k": 4, "desired_cluster_size": 40, "rng_seed": 42}})
    index = SpannIndexBuilder(cfg, device=DEVICE).with_data(data).build(save=disk)
    lire = LireConfig(max_partition_size=80, min_partition_size=2)
    fresh = (LazySpFreshIndex(str(out), lire_config=lire, device=DEVICE) if disk
             else SpFreshIndex(index, str(scratch / "cc_lire"), lire))
    nprobe = (lambda: fresh.num_clusters) if disk else (lambda: index.num_clusters)
    initial = set(store_live(fresh.storage))
    stop, lock = threading.Event(), threading.Lock()
    errors, deleted, inserted, searches = [], set(), set(), [0]

    def actor(name, body):
        def run():
            try:
                body()
            except Exception as e:  # reported with the other actors' errors below
                errors.append(f"{name}: {type(e).__name__}: {e}\n{traceback.format_exc()}")
        return threading.Thread(target=run, name=name)

    def searcher(q):
        def body():
            while not stop.is_set():
                with lock:
                    pre = set(deleted)
                ids, _ = fresh.search(q, 8, nprobe=nprobe())
                searches[0] += 1
                for row in ids:
                    real = [int(i) for i in row if i >= 0]
                    assert len(real) == len(set(real)), f"repeated id in {row}"
                bad = set(ids.ravel().tolist()) & pre
                assert not bad, f"deleted vids returned: {vid_state(bad)}"
                assert 0 in ids[0], f"the anchor vanished: {vid_state([0])}"
        return body

    def mutator():
        r = np.random.default_rng(1)
        next_vid, mine = 20_000, []
        while not stop.is_set():
            if mine and r.random() < 0.45:
                if len(mine) >= 3 and r.random() < 0.3:
                    vids = [mine.pop(int(r.integers(len(mine)))) for _ in range(3)]
                    n_del = fresh.delete_batch(vids)
                    gone = [v for v in vids if not fresh.storage.postings_of(v)]
                    assert n_del == len(vids) or len(gone) < len(vids), "delete_batch undercounted"
                    with lock:
                        deleted.update(gone)
                    mine.extend(v for v in vids if v not in gone)
                    continue
                vid = mine.pop(int(r.integers(len(mine))))
                for _ in range(20):
                    try:
                        fresh.delete(vid)
                        break
                    except LireStorageError:
                        continue  # the documented retry contract
                else:
                    raise AssertionError(f"delete({vid}) never converged")
                with lock:
                    deleted.add(vid)
            else:
                fresh.insert(2.0 * r.standard_normal(8).astype(np.float32), next_vid)
                inserted.add(next_vid)
                mine.append(next_vid)
                next_vid += 1

    def compactor():
        while not stop.is_set():
            fresh.compact()
            stop.wait(0.25)

    def vid_state(vids):
        """Where each vid lives at detection time (tests/test_concurrent_stress.py's
        forensics): the store's postings and the search mirror's."""
        try:
            mirror = {} if disk else dict(list(fresh.index.postings.items()))
        except RuntimeError:  # the postings changed while copied
            mirror = {}
        return "; ".join(
            f"vid {v}: storage={fresh.storage.postings_of(int(v))} "
            f"mirror={[c for c, (ids, _) in mirror.items() if (ids == v).any()]}"
            for v in list(vids)[:8])

    threads = [actor("searcher", searcher(data[[0, 5, 9]])), actor("mutator", mutator)]
    if disk:
        threads += [actor("searcher", searcher(data[[0, 17, 42]])), actor("compactor", compactor)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + wall
        while time.monotonic() < deadline and not errors:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads), f"fuzz stress {tier}: a thread wedged"
        assert not errors, errors[:3]
        fresh.flush()
        ids, d = fresh.search(data[:1], 1, nprobe=nprobe())
        assert int(ids[0, 0]) == 0 and float(d[0, 0]) < 1e-4, (ids, d)
        got, want = set(store_live(fresh.storage)), (initial | inserted) - deleted
        assert got == want, f"fuzz stress {tier}: live set off by {len(got ^ want)}"
        postings = len(fresh.storage.posting_ids())
    finally:
        stop.set()
        fresh.close()
    return (f"{searches[0]} searches, {len(inserted)} inserts, {len(deleted)} confirmed deletes, "
            f"{postings} postings after")


def phase_fuzz(torch, report) -> dict:
    """The JAX package's model fuzzers on the card (the CPU twins are
    tests/test_torch_*_fuzz.py and tests/test_torch_concurrent_stress.py):
    the view-update fuzz at the test size (seeds 0, 1, 3 x float32,
    bfloat16, int8) and at FUZZ_REAL_N rows of main's config; SpFreshIndex
    and LazySpFreshIndex model fuzz (seeds 0, 1 x float32, int8,
    MODEL_FUZZ_STEPS steps); the concurrent stress on both tiers
    (FUZZ_STRESS_WALL s each).  Every launch of the rerank (float and
    int8) and replica kernels in the phase is recorded and, after the
    counts are read, held against its plain version (check_recorded).
    Returns the phase's launches, per report entry."""
    import importlib
    import shutil
    from pathlib import Path

    from spfresh_tpu_torch.ops import rerank, replica
    from spfresh_tpu_torch.utils import metrics

    # Every module that binds a wrapper's name, imported before the names
    # are recorded.
    for name in ("clustering.hierarchical", "index.spann", "index.lazy", "ops.centroid_scan",
                 "lire", "interop"):
        importlib.import_module(f"spfresh_tpu_torch.{name}")
    scratch = Path(__file__).resolve().parent / "build" / FUZZ_STORE
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    metrics.DEFAULT.reset()
    rerank.launches = rerank.quantized_launches = replica.launches = 0
    try:
        with recorded_launches(torch, (rerank.padded_rerank_distances, replica.replica_topk),
                               max_bytes=FUZZ_RECORD_MAX_BYTES) as records:
            for sd in ("float32", "bfloat16", "int8"):
                t0 = time.perf_counter()
                checks = [fuzz_view_small(scratch, sd, seed) for seed in FUZZ_SEEDS]
                log(f"fuzz view {sd}: seeds {FUZZ_SEEDS}, 40 mutations each, {sum(checks)} "
                    f"checks (full probe and nprobe 2) equal a fresh pack's "
                    f"({time.perf_counter() - t0:.2f} s)")
            fuzz_view_real(torch, scratch, FUZZ_REAL_N)
            for tier in ("ram", "disk"):
                for sd in ("float32", "int8"):
                    for seed in (0, 1):
                        t0 = time.perf_counter()
                        n = fuzz_model(scratch, tier, sd, seed, MODEL_FUZZ_STEPS)
                        log(f"fuzz model {tier} sd={sd} seed={seed}: {MODEL_FUZZ_STEPS} steps, "
                            f"{n} checks passed ({time.perf_counter() - t0:.2f} s)")
            for tier in ("disk", "ram"):
                t0 = time.perf_counter()
                res = fuzz_stress(scratch, tier, FUZZ_STRESS_WALL)
                log(f"fuzz stress {tier}: {res}; gates passed ({time.perf_counter() - t0:.2f} s)")
        counts = {"rerank": rerank.launches, "rerank_int8": rerank.quantized_launches,
                  "replica": replica.launches}
        log(f"fuzz: kernel launches in the phase {counts}; live counts {live_counts(metrics)}")
        assert all(c > 0 for c in counts.values()), counts
        checked = check_recorded(torch, records, report, "fuzz")
        log(f"fuzz: launches held against the plain versions (checked, too large to record) "
            f"{checked}")
        for kind, c in counts.items():
            assert checked[kind] == [c, 0], f"fuzz {kind}: {checked[kind]} of {c} launches"
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return counts


def main() -> int:
    import torch

    # The builders' progress (the out-of-core phases as they end) on stderr.
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on a GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {smi}")
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count={torch.cuda.device_count()}")

    from concurrent.futures import ThreadPoolExecutor

    from spfresh_tpu_torch import native
    from spfresh_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native.build)  # the disk tier's reader, with g++
        path = _build.build()
        _build.library()
        log(f"build: {len(_build.sources())} sources -> {path.name} in "
            f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])})")
        log(f"build: native host runtime -> {host.result().name} ({native.CXX} "
            f"{' '.join(native.CXX_FLAGS)})")
    native.library()

    assert not torch.backends.cuda.matmul.allow_tf32, "plain versions must not run in TF32"
    report = {}
    main_state = {}
    main_recall = []
    sharded_launches = {}  # the sharded phase's, added to the report at the end
    shardbuild_launches = {}  # the shardbuild phase's device-list builds', likewise
    examples_launches = {}  # the examples phase's, likewise
    fuzz_launches = {}  # the fuzz phase's, likewise

    def run_main():
        *state, rec = phase_main(torch, 1_000_000, 16_384, report)
        main_state.update(zip(("index", "data", "queries", "gt", "nprobe"), state))
        main_recall.append(rec)

    runs = {
        "kernels": lambda: phase_kernels(torch, report),
        "main": run_main,
        "examples": lambda: examples_launches.update(
            phase_examples(torch, **main_state, recall=main_recall[0], smi=smi, report=report)),
        "shardbuild": lambda: shardbuild_launches.update(
            phase_shardbuild(torch, **main_state, smi=smi)),
        "disk": lambda: phase_disk(torch, **main_state),
        "live": lambda: main_state.update(zip(("live", "int8"), phase_live(torch, **main_state))),
        "sharded": lambda: sharded_launches.update(phase_sharded(torch, **main_state, smi=smi)),
        "fuzz": lambda: fuzz_launches.update(phase_fuzz(torch, report)),
        "large": lambda: phase_large(torch, LARGE_N, 16_384, report),
        "manhattan": lambda: phase_metric(torch, "Manhattan", 1_000_000, 16_384, report, 0.90),
        "chebyshev": lambda: phase_metric(torch, "Chebyshev", 262_144, 16_384, report, None),
        "outofcore": lambda: phase_outofcore(torch, OC_N, 16_384, report),
        "exact": lambda: phase_exact(torch),
    }
    for name, run in runs.items():
        t0 = time.perf_counter()
        run()
        if name == "sharded":
            main_state.clear()  # release main's index before the large phase
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")

    for name, c in (*sharded_launches.items(), *shardbuild_launches.items(),
                    *examples_launches.items(), *fuzz_launches.items()):
        report[name]["launches"] += c
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "cases")  # cases: the window scan's timed shapes in both rank modes
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         **{k: report[name][k] for k in keys if k in report[name]}}
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
