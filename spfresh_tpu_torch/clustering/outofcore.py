"""Out-of-core build (counterpart of ``spfresh_tpu/clustering/outofcore.py``):
the corpus stays on the host (an ndarray or an ``np.memmap``) and the card
sees one row tile at a time, the centroid matrix and O(tile) state.

1. **Sample fit**: the in-core ``HierarchicalClustering`` on a seeded
   uniform sample, with the balance cap scaled by the sampling ratio.
2. **Streamed base assignment**: one pass over the corpus in ``tile_rows``
   tiles.  Euclidean takes the nearest-centroid kernel
   (``ops.replica.nearest_centroid``); Manhattan and Chebyshev the chunked
   running argmin, whose distance blocks take the L1/Linf kernel on CUDA.
3. **Host rebalance**: clusters the stream filled past the cap split on the
   host with the in-core tail levels' farthest-point multi-way split.
4. **Streamed replica pass**: the in-core closure rule and budget.
   Euclidean with at most 8 replicas takes the replica kernel with ``db``
   supplied; other metrics and counts the unfused
   ``replica_topk_elementwise``.

With ``devices`` (a list of entries; an entry may repeat a device) the
two streamed passes keep one centroid copy an entry and deal their tiles
round-robin over the entries, each tile's kernel launched on its entry,
with a window of ``max(4, 2 * entries)`` tiles in flight; the results are
identical for any entry count.  The sample fit and the rebalance stay on
the first entry and the host.

Same seeds, draws, tie-breaks and budget as the JAX package, so the same
sample-fit seeds give the same clusters.  Not carried over: the transfer
accounting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import List

import numpy as np
import torch

from spfresh_tpu_torch.clustering.hierarchical import (
    Cluster,
    ClusteringParams,
    HierarchicalClustering,
    _np_rowdist,
    _split_level_multiway_host,
)
from spfresh_tpu_torch.clustering.utils import budget_sort, next_pow2
from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device, resolve_entries
from spfresh_tpu_torch.core.dtypes import bf16_round_np
from spfresh_tpu_torch.ops.distances import EUCLIDEAN, canonical_metric
from spfresh_tpu_torch.ops.replica import (
    MAX_EXTRA,
    chunked_nearest_centroid,
    nearest_centroid,
    replica_topk,
    replica_topk_elementwise,
)

__all__ = ["fit_outofcore", "OutOfCoreResult", "DEFAULT_TILE_ROWS"]

log = logging.getLogger(__name__)

DEFAULT_TILE_ROWS = 65_536
# Host rebalance gathers at most this many member rows per level batch.
_HOST_SPLIT_BATCH_ROWS = 1 << 22


def _dev_dtype(wire: bool, metric: str) -> torch.dtype:
    """Device dtype of streamed tiles and centroids: bf16 when the corpus
    rides the bf16 wire and the metric is Euclidean (the values are
    bf16-representable and the kernels' products exact in f32), else f32."""
    if wire and canonical_metric(metric) == EUCLIDEAN:
        return torch.bfloat16
    return torch.float32


def _stage_tile(data, s: int, e: int, wire: bool, device, dtype) -> torch.Tensor:
    """Rows s..e of the host corpus on ``device`` in ``dtype``.  On the bf16
    wire the tile crosses as bf16, rounded half to even on the host: the
    grid ``bf16_round_np`` gives."""
    Xt = torch.from_numpy(np.array(data[s:e], np.float32))  # a writable copy of a memmap slice
    if wire:
        Xt = Xt.to(torch.bfloat16)
    return Xt.to(device).to(dtype)


@dataclasses.dataclass
class OutOfCoreResult:
    clusters: List[Cluster]
    sample_rows: int
    num_splits: int  # clusters added by the host rebalance
    base: np.ndarray  # (n,) int32 base cluster of every row
    # (C0,) corpus rows of the sample fit's centroids: the centroid set of
    # the streamed base pass, before the rebalance drops and adds clusters.
    sample_centroid_rows: np.ndarray


def fit_outofcore(
    params: ClusteringParams,
    data,
    sample_rows: int,
    tile_rows: int = DEFAULT_TILE_ROWS,
    timer=None,
    device: torch.device | str = DEFAULT_DEVICE,
    devices=None,
) -> OutOfCoreResult:
    """SPANN clusters for a host-resident corpus.

    ``data``: a 2-d float32 array-like with row slicing and fancy row
    indexing (an ndarray, an ``np.memmap``), read in bounded slices and never
    uploaded whole.  ``timer``: a ``PhaseTimer`` for the ``oc/*`` phases.
    ``devices``: entries the streamed passes deal their tiles over (the
    first takes the place of ``device``).  Deterministic for a fixed
    ``params.rng_seed``, whatever the entries."""
    devs = resolve_entries(devices) if devices is not None else [resolve_device(device)]
    device = devs[0]
    n, d = data.shape
    if sample_rows < params.initial_k:
        raise ValueError(f"sample_rows={sample_rows} < initial_k={params.initial_k}")
    cap = params.desired_cluster_size
    if cap is None:
        cap = max(1, int(round(0.18 * n)))
    seed = params.rng_seed if params.rng_seed is not None else 0

    @contextlib.contextmanager
    def _p(name):
        t0 = time.perf_counter()
        with timer.phase(name, block=True) if timer is not None else contextlib.nullcontext():
            yield
        log.info("%s: %.3f s", name, time.perf_counter() - t0)

    wire = params.wire_dtype not in (None, "float32")

    with _p("oc/sample"):
        rng = np.random.Generator(np.random.Philox(key=np.uint64((seed ^ 0x0C0FFEE) & (2**64 - 1))))
        if sample_rows >= n:
            sidx = np.arange(n, dtype=np.int64)
        else:
            sidx = np.sort(rng.choice(n, size=sample_rows, replace=False))
        sample = np.ascontiguousarray(np.asarray(data[sidx], np.float32))
    with _p("oc/sample_fit"):
        sp = dataclasses.replace(
            params, desired_cluster_size=max(1, int(round(cap * len(sidx) / n))))
        hc = HierarchicalClustering(sp, sample, device=device).fit()
        # Centroids come from the wire-rounded sample: the grid the tiles use.
        cent_sample_rows = np.asarray([c.centroid_idx for c in hc.clusters], np.int64)
        cents_np = np.ascontiguousarray(hc._host_data[cent_sample_rows], np.float32)
        cent_rows = sidx[cent_sample_rows]  # global corpus rows
        sample_centroid_rows = cent_rows
        del hc  # frees the sample's device copy

    with _p("oc/assign"):
        base, db = _stream_base(data, cents_np, params.metric, tile_rows, wire, devs)

    with _p("oc/split"):
        cent_rows, cents_np, base, db, num_splits = _host_rebalance(
            data, cent_rows, cents_np, base, db, cap, params, wire, seed)

    C = len(cent_rows)
    n_extra = min(params.max_replicas - 1, C - 1)
    if n_extra > 0:
        with _p("oc/replica"):
            extras = _stream_replicas(data, cents_np, base, db, params, n_extra, tile_rows,
                                      wire, devs)
    else:
        extras = (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32))

    with _p("oc/finalize"):
        clusters = _assemble(n, C, cent_rows, base, extras, cap, params.replica_overflow)
    return OutOfCoreResult(clusters=clusters, sample_rows=len(sidx), num_splits=num_splits,
                           base=base, sample_centroid_rows=sample_centroid_rows)


def _window(devs) -> int:
    """Tiles in flight before the oldest is read back."""
    return max(4, 2 * len(devs))


def _stream_base(data, cents_np, metric, tile_rows, wire, devs):
    """(base (n,) int32, db (n,) f32): the nearest centroid of every row,
    one tile at a time, tiles dealt round-robin over ``devs``."""
    n = data.shape[0]
    metric = canonical_metric(metric)
    dd = _dev_dtype(wire, metric)
    cents = [torch.from_numpy(cents_np).to(dv).to(dd) for dv in devs]
    base = np.empty(n, np.int32)
    db = np.empty(n, np.float32)
    pending = []

    def drain(item):
        s0, e0, b0, d0 = item
        base[s0:e0] = b0.cpu().numpy()
        db[s0:e0] = d0.cpu().numpy()

    for ti, s in enumerate(range(0, n, tile_rows)):
        e = min(s + tile_rows, n)
        dv = devs[ti % len(devs)]
        Xt = _stage_tile(data, s, e, wire, dv, dd)
        if metric == EUCLIDEAN:
            b, dist = nearest_centroid(Xt, cents[ti % len(devs)])
        else:
            b, dist = chunked_nearest_centroid(Xt, cents[ti % len(devs)], metric)
        pending.append((s, e, b, dist))
        if len(pending) >= _window(devs):
            drain(pending.pop(0))
    for item in pending:
        drain(item)
    return base, db


def _host_rebalance(data, cent_rows, cents_np, base, db, cap, params, wire, seed):
    """Drop empty clusters, then split every cluster the streamed assignment
    filled past the cap: level-synchronous host farthest-point splits (the
    in-core tail levels' algorithm, with the quantile fallback for
    degenerate duplicate-heavy clusters).  Updates base/db of the moved rows
    and returns the grown centroid set."""
    cent_rows = np.asarray(cent_rows, np.int64).copy()
    cents_np = np.asarray(cents_np, np.float32).copy()
    C = len(cent_rows)
    counts = np.bincount(base, minlength=C)
    keep = np.flatnonzero(counts > 0)
    if len(keep) < C:
        relabel = np.full(C, -1, np.int64)
        relabel[keep] = np.arange(len(keep))
        base = relabel[base].astype(np.int32)
        cent_rows, cents_np, counts = cent_rows[keep], cents_np[keep], counts[keep]
        C = len(keep)

    num_splits = 0
    max_ways = params.max_split_ways
    rng = np.random.Generator(np.random.Philox(key=np.uint64((seed ^ 0x5EED5EED) & (2**64 - 1))))
    while True:
        oversized = np.flatnonzero(counts > cap)
        if len(oversized) == 0:
            break
        order = np.argsort(base, kind="stable")
        bounds = np.searchsorted(base[order], np.arange(C + 1))
        rows_sorted = np.arange(len(base), dtype=np.int64)[order]
        # Batch oversized clusters so one level's host gather stays bounded.
        batches: List[List[int]] = []
        cur: List[int] = []
        cur_rows = 0
        for ci in oversized:
            sz = int(counts[ci])
            if cur and cur_rows + sz > _HOST_SPLIT_BATCH_ROWS:
                batches.append(cur)
                cur, cur_rows = [], 0
            cur.append(int(ci))
            cur_rows += sz
        batches.append(cur)
        new_rows: List[int] = []
        new_vecs: List[np.ndarray] = []
        for group in batches:
            members = [np.sort(rows_sorted[bounds[ci] : bounds[ci + 1]]) for ci in group]
            lens = np.array([len(m) for m in members])
            m_c = np.clip(np.ceil(lens / cap).astype(np.int64), 2, min(max_ways, int(lens.max())))
            m_c = np.minimum(m_c, lens)
            M = int(next_pow2(int(m_c.max())))
            flat = np.concatenate(members)  # global corpus rows
            cluster_of = np.repeat(np.arange(len(group)), lens)
            Xg = np.asarray(data[flat], np.float32)
            if wire:
                Xg = bf16_round_np(Xg)
            cum = np.zeros(len(group) + 1, np.int64)
            np.cumsum(lens, out=cum[1:])
            offs = rng.integers(0, np.maximum(lens, 1))
            c1_local = (cum[:-1] + offs).astype(np.int64)
            # point_list = LOCAL positions into Xg; returned seeds are local.
            local_pos = np.arange(len(flat), dtype=np.int64)
            assign, seeds_local, cnts, d1 = _split_level_multiway_host(
                Xg, local_pos, cluster_of.astype(np.int64), c1_local, m_c,
                params.metric, nm=len(group), m_ways=M,
            )
            degenerate = cnts.max(axis=1) == lens
            for r, ci in enumerate(group):
                lo, hi = int(cum[r]), int(cum[r + 1])
                if degenerate[r]:
                    # Balanced quantile split on d1 (guaranteed progress).
                    order_r = np.argsort(d1[lo:hi], kind="stable")
                    local_parts = [p for p in np.array_split(order_r, int(m_c[r])) if len(p)]
                    seed_locals = [int(lo + p[0]) for p in local_parts]
                else:
                    a = assign[lo:hi]
                    uniq = np.unique(a)
                    seed_locals = [int(seeds_local[r, j]) for j in uniq]
                    local_parts = [np.flatnonzero(a == j) for j in uniq]
                part_rows = [flat[lo + p] for p in local_parts]
                d_parts = [
                    _np_rowdist(Xg[lo + p], Xg[sl][None, :].repeat(len(p), 0), params.metric)
                    for p, sl in zip(local_parts, seed_locals)
                ]
                # The first child keeps label ci; the others get fresh labels.
                cent_rows[ci] = int(flat[seed_locals[0]])
                cents_np[ci] = Xg[seed_locals[0]]
                base[part_rows[0]] = ci
                db[part_rows[0]] = d_parts[0]
                for j in range(1, len(local_parts)):
                    nc = C + len(new_rows)
                    base[part_rows[j]] = nc
                    db[part_rows[j]] = d_parts[j]
                    new_rows.append(int(flat[seed_locals[j]]))
                    new_vecs.append(Xg[seed_locals[j]])
                    num_splits += 1
        if new_rows:
            cent_rows = np.concatenate([cent_rows, np.asarray(new_rows, np.int64)])
            cents_np = np.concatenate([cents_np, np.stack(new_vecs).astype(np.float32)])
        C = len(cent_rows)
        counts = np.bincount(base, minlength=C)
    return cent_rows, cents_np, base, db, num_splits


def _stream_replicas(data, cents_np, base, db, params, n_extra, tile_rows, wire, devs):
    """Closure replicas of every row, one tile at a time (tiles dealt
    round-robin over ``devs``), with the base distances of the assignment
    (and of the rebalance) supplied as ``db``.  Returns the flat (points,
    clusters, ranks) of every admitted replica."""
    n = data.shape[0]
    metric = canonical_metric(params.metric)
    dd = _dev_dtype(wire, metric)
    cents = [torch.from_numpy(cents_np).to(dv).to(dd) for dv in devs]
    bt = float(np.float32(params.boundary_threshold))
    soar = float(params.soar_lambda or 0.0)
    fused = metric == EUCLIDEAN and n_extra <= MAX_EXTRA
    pts_l: List[np.ndarray] = []
    cls_l: List[np.ndarray] = []
    d_l: List[np.ndarray] = []
    pending = []

    def drain(item):
        s0, e0, i0, d0 = item
        idx, dists = i0.cpu().numpy(), d0.cpu().numpy()
        valid = np.isfinite(dists)
        rows = np.broadcast_to(np.arange(s0, e0)[:, None], idx.shape)
        pts_l.append(rows[valid].astype(np.int64))
        cls_l.append(idx[valid].astype(np.int64))
        d_l.append(dists[valid])

    for ti, s in enumerate(range(0, n, tile_rows)):
        e = min(s + tile_rows, n)
        dv = devs[ti % len(devs)]
        Xt = _stage_tile(data, s, e, wire, dv, dd)
        base_t = torch.from_numpy(np.ascontiguousarray(base[s:e], np.int32)).to(dv)
        db_t = torch.from_numpy(np.ascontiguousarray(db[s:e], np.float32)).to(dv)
        c = cents[ti % len(devs)]
        if fused:
            i0, d0 = replica_topk(Xt, base_t, c, bt, n_extra, db=db_t, soar_lambda=soar)
        else:
            i0, d0 = replica_topk_elementwise(Xt, base_t, c, bt, n_extra, metric, db=db_t,
                                              soar_lambda=soar)
        pending.append((s, e, i0, d0))
        if len(pending) >= _window(devs):
            drain(pending.pop(0))
    for item in pending:
        drain(item)
    return (
        np.concatenate(pts_l) if pts_l else np.empty(0, np.int64),
        np.concatenate(cls_l) if cls_l else np.empty(0, np.int64),
        np.concatenate(d_l) if d_l else np.empty(0, np.float32),
    )


def _assemble(n, C, cent_rows, base, extras, cap, replica_overflow):
    """Base groups plus budgeted closest replicas -> Cluster list (the
    in-core budget rule: members <= ceil(overflow * cap), closest replicas
    win the remaining slots)."""
    order = np.argsort(base, kind="stable")
    bounds = np.searchsorted(base[order], np.arange(C + 1))
    pts_all = np.arange(n, dtype=np.int64)[order]
    e_pts, e_cls, e_d = extras
    limit = max(int(np.ceil(replica_overflow * cap)), 1)
    if len(e_pts):
        eorder = budget_sort(e_cls, e_d)
        e_pts, e_cls = e_pts[eorder], e_cls[eorder]
        ebounds = np.searchsorted(e_cls, np.arange(C + 1))
    clusters: List[Cluster] = []
    for ci in range(C):
        pts = np.sort(pts_all[bounds[ci] : bounds[ci + 1]])
        if len(e_pts):
            budget = max(0, limit - len(pts))
            lo, hi = int(ebounds[ci]), int(ebounds[ci + 1])
            extra = e_pts[lo : lo + min(budget, hi - lo)]
            if len(extra):
                pts = np.sort(np.concatenate([pts, extra]))
        clusters.append(Cluster(int(cent_rows[ci]), pts, 0))
    return clusters
