"""Hierarchical balanced clustering (counterpart of
``spfresh_tpu/clustering/hierarchical.py``).

The build runs:

1. Random or KMeans++ init.  Draws come from a numpy Philox generator
   seeded from ``rng_seed`` (``_level_rng``), not ``jax.random``, so the
   port picks other initial seeds than the JAX package for the same seed;
   the tests inject the reference's seeds to compare the rest.
2. One assignment + medoid update: hard (``_assign_medoid_fused``) for
   ``replication="final"``, with the closure replicas
   (``_assign_with_closure``, then ``_medoid_update``) for ``"nested"``.
3. Subdivision.  Multi-way (``max_split_ways`` > 2, ``"final"``):
   level-synchronous; big levels run on the device (``_split_level_core``),
   levels of at most ``_tail_rows_for`` member rows on the host
   (``_split_level_multiway_host``).  Binary (``max_split_ways`` 2, or
   ``"nested"``): the reference's two-seed split (``_split_level_flat``),
   with the in-split closure under ``"nested"`` and an exact balanced
   median split for a cluster that would not split.  Seeds, tie-breaks and
   the per-level Philox draws are the JAX package's, so the same initial
   seeds give the same clusters.
4. Under ``"final"``, one closure-replica pass and the host per-cluster
   replica budget.  Euclidean with at most 8 replicas takes
   ``ops.replica.replica_topk`` (the CUDA kernel on a CUDA device, its
   plain version on the CPU); Manhattan, Chebyshev and more replicas take
   the unfused ``replica_topk_elementwise``, whose distance blocks launch
   the L1/Linf kernel on a CUDA device.

Over a list of devices (``devices=[...]``, one process driving every
entry; ``spfresh_tpu_torch.parallel``) steps 1-4 run data-sharded with the
same results as on one device.  ``corpus_layout="sharded"`` keeps n/S
corpus rows an entry, ``"replicated"`` a full copy on each (the binary
and nested modes always take it).  Tail levels stay on the host.

Not ported: the device-resident subdivision (single device and mesh).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from spfresh_tpu_torch.clustering.utils import (
    budget_sort,
    masked_means,
    next_pow2,
    seg_max,
    seg_min,
    seg_sum,
)
from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device, resolve_entries
from spfresh_tpu_torch.core.dtypes import bf16_round_np
from spfresh_tpu_torch.ops.distances import (
    EUCLIDEAN,
    canonical_metric,
    pairwise_distance,
    rowwise_distance,
)
from spfresh_tpu_torch.ops.replica import MAX_EXTRA, replica_topk, replica_topk_elementwise
from spfresh_tpu_torch.utils import metrics
from spfresh_tpu_torch.utils.profiling import PhaseTimer


RANDOM = "Random"
KMEANS_PLUS_PLUS = "KMeans++"
INIT_METHODS = (RANDOM, KMEANS_PLUS_PLUS)

# SPANN boundary closure factor.
BOUNDARY_THRESHOLD = 1.1


def canonical_init(name: str) -> str:
    lowered = str(name).strip().lower()
    for m in INIT_METHODS:
        if lowered == m.lower() or lowered == m.replace("++", "plusplus").lower():
            return m
    raise ValueError(f"unknown initialization method {name!r}; expected one of {list(INIT_METHODS)}")


@dataclasses.dataclass
class ClusteringParams:
    """Same fields, defaults and checks as the JAX package's
    ``ClusteringParams``; see there for what each knob does."""

    metric: str = EUCLIDEAN
    initialization_method: str = RANDOM
    desired_cluster_size: Optional[int] = None
    initial_k: int = 4
    rng_seed: Optional[int] = None
    boundary_threshold: float = BOUNDARY_THRESHOLD
    replication: str = "final"
    max_replicas: int = 4
    replica_overflow: float = 1.25
    max_split_ways: int = 8
    wire_dtype: Optional[str] = None
    soar_lambda: Optional[float] = None

    def __post_init__(self):
        self.metric = canonical_metric(self.metric)
        self.initialization_method = canonical_init(self.initialization_method)
        if self.initial_k <= 0:
            raise ValueError("initial_k must be > 0")
        if self.replication not in ("final", "nested"):
            raise ValueError("replication must be 'final' or 'nested'")
        if self.max_replicas < 1:
            raise ValueError("max_replicas must be >= 1")
        if self.max_split_ways < 2:
            raise ValueError("max_split_ways must be >= 2")
        if self.max_split_ways > 128:
            raise ValueError("max_split_ways must be <= 128")
        if self.soar_lambda is not None:
            if self.soar_lambda < 0:
                raise ValueError("soar_lambda must be >= 0")
            if self.soar_lambda and self.metric != "Euclidean":
                raise ValueError("soar_lambda requires the Euclidean metric")


@dataclasses.dataclass
class Cluster:
    """Medoid index + member ids."""

    centroid_idx: int
    points: np.ndarray  # int64 indices into the dataset
    depth: int = 0

    def __len__(self) -> int:
        return int(self.points.shape[0])


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Device building blocks
# ---------------------------------------------------------------------------


def _random_init(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """k distinct rows, uniformly without replacement."""
    return rng.choice(n, size=k, replace=False).astype(np.int64)


def _kmeanspp_init(X: torch.Tensor, k: int, metric: str, rng: np.random.Generator) -> np.ndarray:
    """KMeans++ seeding as a running min-distance recurrence: one O(n d)
    device pass per seed, d^2-weighted sampling drawn on the host from
    ``rng`` (f64 weights, so the draw is the same on every device)."""
    n = X.shape[0]
    first = int(rng.integers(0, n))
    min_d = rowwise_distance(X, X[first][None, :], metric)
    chosen = [first]
    for _ in range(1, k):
        w = _np(min_d).astype(np.float64) ** 2
        total = w.sum()
        # All-zero weights (every point already a centroid / duplicates):
        # fall back to uniform, as the reference does on sampling failure.
        p = w / total if total > 0 else np.full(n, 1.0 / n)
        idx = int(rng.choice(n, p=p))
        chosen.append(idx)
        min_d = torch.minimum(min_d, rowwise_distance(X, X[idx][None, :], metric))
    return np.asarray(chosen, np.int64)


def membership(D, cent_vecs, metric: str, boundary_threshold: float, closure: bool = True):
    """(n, k) bool membership from the distances D (n, k) to ``cent_vecs``:
    the nearest centroid, and under ``closure`` every centroid j with
    D[p, j] < bt * min_dist and dist(c_best, c_j) >= D[p, j] (the
    reference's closure rule)."""
    best = torch.argmin(D, dim=1)
    mask = best[:, None] == torch.arange(D.shape[1], device=D.device)[None, :]
    if not closure:
        return mask
    min_d = torch.amin(D, dim=1)
    cc = pairwise_distance(cent_vecs, cent_vecs, metric)  # (k, k)
    thr = float(np.float32(boundary_threshold)) * min_d
    return mask | ((D < thr[:, None]) & (cc[best] >= D))


def _assign_with_closure(X, cent_vecs, metric: str, boundary_threshold: float):
    """(n, k) bool closure membership of the rows of X (``membership``)."""
    return membership(pairwise_distance(X, cent_vecs, metric), cent_vecs, metric,
                      boundary_threshold)


def _medoid_update(X, member_mask, old_idx, metric: str):
    """Per-cluster mean, then the member point closest to it (ties to the
    lowest row).  Empty clusters keep their centroid."""
    means = masked_means(X, member_mask)  # (k, d)
    Dm = pairwise_distance(X, means, metric)  # (n, k)
    Dm = torch.where(member_mask, Dm, torch.full_like(Dm, float("inf")))
    new_idx = torch.argmin(Dm, dim=0)
    counts = torch.sum(member_mask, dim=0)
    return torch.where(counts > 0, new_idx, old_idx)


def _assign_medoid_fused(X, cents, old_idx, k: int, metric: str):
    """Hard assignment + medoid update; returns (best (n,), new medoids (k,))."""
    D = pairwise_distance(X, cents, metric)  # (n, k)
    best = torch.argmin(D, dim=1)
    mask = best[:, None] == torch.arange(k, device=X.device)[None, :]
    return best, _medoid_update(X, mask, old_idx, metric)


def _split_level_core(X, point_list, cluster_of, c1_idx, seed_valid, metric: str,
                      num_segments: int, m_ways: int):
    """Batched M-way split of every oversized cluster at a level.

    Farthest-point seeds: seed_0 = c1_idx (a random member), seed_j = the
    member farthest from all previous seeds (ties to the earliest position);
    the running min-distance/argmin over seeds is the final nearest-seed
    assignment (ties to the earliest seed).  ``seed_valid`` (S, m_ways)
    masks how many children each cluster wants.  Returns (assign (P,) child
    index, seeds (S, m_ways) dataset rows, counts (S, m_ways), d1 (P,)
    distances to seed 0 for the balanced fallback)."""
    P = point_list.shape[0]
    S = num_segments
    dev = X.device
    pts = X[point_list]  # (P, d)
    pos = torch.arange(P, device=dev)
    seeds = torch.zeros((S, m_ways), dtype=torch.int64, device=dev)
    seeds[:, 0] = c1_idx
    d_min = rowwise_distance(pts, X[c1_idx][cluster_of], metric)  # (P,)
    d1 = d_min
    best_j = torch.zeros(P, dtype=torch.int64, device=dev)
    taken = point_list == c1_idx[cluster_of]
    neg_inf = torch.full((P,), float("-inf"), device=dev)
    for j in range(1, m_ways):
        ok = seed_valid[:, j]  # (S,) does this cluster want a j-th child?
        ok_p = ok[cluster_of]
        d_masked = torch.where(~taken & ok_p, d_min, neg_inf)
        at_max = (d_masked == seg_max(d_masked, cluster_of, S)[cluster_of]) & ~taken & ok_p
        sj_pos = seg_min(torch.where(at_max, pos, torch.full_like(pos, P)), cluster_of, S, P)
        found = sj_pos < P
        sj_pos = torch.clamp(sj_pos, 0, P - 1)
        seed_j = point_list[sj_pos]
        seeds[:, j] = torch.where(found, seed_j, seeds[:, 0])
        use = ok & found
        d_new = rowwise_distance(pts, X[seed_j][cluster_of], metric)
        upd = use[cluster_of] & (d_new < d_min)
        best_j = torch.where(upd, j, best_j)
        d_min = torch.where(upd, d_new, d_min)
        taken = taken | ((pos == sj_pos[cluster_of]) & use[cluster_of])
    counts = torch.bincount(cluster_of * m_ways + best_j, minlength=S * m_ways)
    return best_j, seeds, counts.reshape(S, m_ways), d1


def _split_level_flat(X, point_list, cluster_of, valid, c1_idx, metric: str,
                      boundary_threshold: float, closure: bool, num_segments: int):
    """Batched binary split of every oversized cluster at a level.

    ``point_list`` (P,) holds the members grouped by cluster, ``cluster_of``
    (P,) each member's segment, ``c1_idx`` (S,) the first seed (a random
    member) of each segment.  The second seed is the member farthest from
    the first (ties to the earliest position); each member joins the
    nearer seed (ties to the first), and under ``closure`` also the other
    one when it passes the closure rule.  Returns (m1, m2 (P,) child
    membership, c2_idx (S,) second seeds, degenerate (S,) for a split
    with an empty or a whole child, d1 (P,) seed-1 distances for the
    host's balanced fallback)."""
    P = point_list.shape[0]
    S = num_segments
    dev = X.device
    pts = X[point_list]  # (P, d)
    c1v = X[c1_idx]  # (S, d)
    d1 = rowwise_distance(pts, c1v[cluster_of], metric)
    is_c1 = point_list == c1_idx[cluster_of]
    d1m = torch.where(valid & ~is_c1, d1, torch.full_like(d1, float("-inf")))
    pos = torch.arange(P, device=dev)
    at_max = valid & ~is_c1 & (d1m == seg_max(d1m, cluster_of, S)[cluster_of])
    c2_pos = seg_min(torch.where(at_max, pos, torch.full_like(pos, P)), cluster_of, S, P)
    c2_idx = point_list[torch.clamp(c2_pos, 0, P - 1)]
    c2v = X[c2_idx]
    d2 = rowwise_distance(pts, c2v[cluster_of], metric)
    best2 = d2 < d1
    if closure:
        cc = rowwise_distance(c1v, c2v, metric)[cluster_of]  # (P,)
        bt = float(np.float32(boundary_threshold))
        m1 = valid & (~best2 | (best2 & (d1 < bt * d2) & (cc >= d1)))
        m2 = valid & (best2 | (~best2 & (d2 < bt * d1) & (cc >= d2)))
    else:
        m1 = valid & ~best2
        m2 = valid & best2

    cnt, cnt1, cnt2 = (seg_sum(m.long(), cluster_of, S) for m in (valid, m1, m2))
    degenerate = (cnt1 == cnt) | (cnt2 == cnt) | (cnt1 == 0) | (cnt2 == 0)
    return m1, m2, c2_idx, degenerate, d1


def _np_rowdist(a: np.ndarray, b: np.ndarray, metric: str) -> np.ndarray:
    diff = a - b
    if metric == "Manhattan":
        return np.abs(diff).sum(axis=1)
    if metric == "Chebyshev":
        return np.abs(diff).max(axis=1)
    return (diff * diff).sum(axis=1)


def _split_level_multiway_host(
    X: np.ndarray, point_list, cluster_of, c1_idx, m_c, metric: str,
    nm: int, m_ways: int,
):
    """Numpy mirror of ``_split_level_core`` for small tail levels (same
    seeds, same tie-breaks) — a copy of the JAX package's host pass."""
    P = point_list.shape[0]
    pts = X[point_list]  # (P, d) f32
    pos = np.arange(P)
    seeds = np.zeros((nm, m_ways), np.int32)
    seeds[:, 0] = c1_idx
    d_min = _np_rowdist(pts, X[c1_idx][cluster_of], metric)
    d1 = d_min.copy()
    best_j = np.zeros(P, np.int32)
    taken = point_list == c1_idx[cluster_of]
    for j in range(1, m_ways):
        ok = j < m_c  # (nm,)
        d_masked = np.where(~taken & ok[cluster_of], d_min, -np.inf)
        seg_max = np.full(nm, -np.inf, d_masked.dtype)
        np.maximum.at(seg_max, cluster_of, d_masked)
        at_max = (d_masked == seg_max[cluster_of]) & ~taken & ok[cluster_of]
        sj_pos = np.full(nm, P, np.int64)
        np.minimum.at(sj_pos, cluster_of[at_max], pos[at_max])
        found = sj_pos < P
        sj_pos_c = np.clip(sj_pos, 0, P - 1)
        seed_j = point_list[sj_pos_c].astype(np.int32)
        seeds[:, j] = np.where(found, seed_j, seeds[:, 0])
        use = ok & found
        d_new = _np_rowdist(pts, X[seed_j][cluster_of], metric)
        upd = use[cluster_of] & (d_new < d_min)
        best_j = np.where(upd, j, best_j).astype(np.int32)
        d_min = np.where(upd, d_new, d_min)
        taken = taken | ((pos == sj_pos_c[cluster_of]) & use[cluster_of])
    counts = np.zeros((nm, m_ways), np.int64)
    np.add.at(counts, (cluster_of, best_j), 1)
    return best_j, seeds, counts, d1


# Tail levels at or below this many member rows run on the host.  Scaled by
# 128/d off the CPU (the host pass is O(P d); a device level costs a few
# launches and transfers), flat on the CPU, as in the JAX package.
_HOST_SPLIT_MAX_P = 1 << 17


def _tail_rows_for(platform: str, d: int) -> int:
    """The host-tail row threshold for a device type and dimension."""
    if platform == "cpu":
        return _HOST_SPLIT_MAX_P
    return max(1 << 14, (_HOST_SPLIT_MAX_P * 128) // max(d, 128))


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


class HierarchicalClustering:
    """Balanced hierarchical clustering.  ``data`` is a host (n, d) array;
    it is rounded to the bfloat16 grid first when ``params.wire_dtype``
    asks for it, exactly as the JAX package rounds its corpus upload.

    ``device``: where a single-device build runs.  ``devices``: a list of
    device-list entries (an entry may repeat a device); with two or more
    the build runs data-sharded over them, the first entry in the place of
    ``device``, with the clusters of a single-device build.
    ``corpus_layout`` (device lists only): ``"sharded"`` keeps n/S corpus
    rows an entry (padding rows are copies of row 0, so ties break to the
    real row); ``"replicated"`` a full copy on each.  The binary and
    nested modes take ``"replicated"``, as in the JAX package."""

    def __init__(self, params: ClusteringParams, data,
                 device: torch.device | str = DEFAULT_DEVICE, devices=None,
                 corpus_layout: str = "sharded"):
        if corpus_layout not in ("sharded", "replicated"):
            raise ValueError(f"unknown corpus_layout {corpus_layout!r}")
        if params.replication == "nested" or params.max_split_ways == 2:
            corpus_layout = "replicated"  # the binary split gathers from the whole corpus
        self.params = params
        devs = None
        if devices is not None:
            devs = resolve_entries(devices)
            device = devs[0]
            if len(devs) < 2:
                devs = None  # one entry: the single-device build on it
        self.devices = devs
        self.device = resolve_device(device)
        self._corpus_layout = corpus_layout if devs else "single"
        host = np.asarray(data, np.float32)
        if host.ndim != 2:
            raise ValueError(f"data must be 2-d, got shape {host.shape}")
        if params.wire_dtype not in (None, "float32"):
            host = bf16_round_np(host)
        self._host_data = host
        self._n = int(host.shape[0])
        self.shards: Optional[List[torch.Tensor]] = None
        self.replicas: Optional[List[torch.Tensor]] = None
        if self._corpus_layout == "sharded":
            self.data = None  # no entry holds the whole corpus
            S = len(devs)
            rps = -(-self._n // S)
            self.shards = []
            for s, dv in enumerate(devs):
                block = host[s * rps : (s + 1) * rps]
                if len(block) < rps:
                    block = np.concatenate([block, np.repeat(host[:1], rps - len(block), axis=0)])
                self.shards.append(torch.from_numpy(block).to(dv))
        elif self._corpus_layout == "replicated":
            t = torch.from_numpy(host)
            self.replicas = [t.to(dv) for dv in devs]
            self.data = self.replicas[0]
        else:
            self.data = torch.from_numpy(host).to(self.device)
        self.clusters: List[Cluster] = []
        seed = (params.rng_seed if params.rng_seed is not None
                else np.random.SeedSequence().entropy % (2**63))
        self._seed = int(seed) & 0x7FFFFFFFFFFFFFFF
        self._timer = PhaseTimer(self.device)

    def _level_rng(self, stream: int) -> np.random.Generator:
        """Deterministic host RNG for per-level draws."""
        return np.random.Generator(
            np.random.Philox(key=np.uint64(self._seed ^ (stream * 0x9E3779B9)))
        )

    def fit(self) -> "HierarchicalClustering":
        n = self._n
        k = self.params.initial_k
        if k > n:
            raise ValueError(f"initial_k={k} exceeds number of points n={n}")
        cap = self.params.desired_cluster_size
        if cap is None:
            cap = max(1, int(round(0.18 * n)))
        timer = self._timer
        with timer.phase("fit/init", block=True):
            self._initialize_clusters(k)
        with timer.phase("fit/assign+medoid", block=True):
            if self.devices:
                self._assign_and_update_sharded()
            elif self.params.replication == "nested":
                # Closure masks are multi-membership: the two-step path.
                self._assign_points()
                self._update_centroids()
            else:
                self._assign_and_update_fused()
        with timer.phase("fit/subdivide", block=True):
            self._subdivide_clusters(int(cap))
        if self.params.replication == "final":
            with timer.phase("fit/replica_pass", block=True):
                self._finalize_replication()
        return self

    def labels(self) -> np.ndarray:
        """One hard label per point: among clusters containing the point,
        the nearest centroid; ties -> lowest cluster index.  Distances come
        from the host mirror, as in the JAX package."""
        n = self._n
        cent_vecs = self._host_data[[c.centroid_idx for c in self.clusters]]
        pts = np.concatenate([c.points for c in self.clusters])
        cls = np.concatenate([np.full(len(c.points), ci, dtype=np.int64)
                              for ci, c in enumerate(self.clusters)])
        d = _np_rowdist(self._host_data[pts], cent_vecs[cls], self.params.metric)
        order = np.lexsort((cls, d, pts))  # by point, then dist, then cluster
        pts_o = pts[order]
        first = np.ones(len(pts_o), dtype=bool)
        first[1:] = pts_o[1:] != pts_o[:-1]
        labels = np.zeros(n, dtype=np.int64)
        labels[pts_o[first]] = cls[order][first]
        return labels

    def centroid_vectors(self) -> torch.Tensor:
        """(C, d) centroid vectors on ``device`` (the first entry); in the
        sharded layout gathered from the host mirror, the same grid as
        the shards."""
        idx = np.asarray([c.centroid_idx for c in self.clusters], np.int64)
        if self.data is None:
            return torch.from_numpy(self._host_data[idx]).to(self.device)
        return self.data[torch.from_numpy(idx).to(self.device)]

    # -- internals

    def _row_shards(self) -> List[torch.Tensor]:
        """The corpus as one (rps, d) row block an entry, the last padded
        with copies of row 0: the sharded layout's own blocks, or slices of
        the replicated layout's copies."""
        if self.shards is not None:
            return self.shards
        rps = -(-self._n // len(self.devices))
        out = []
        for s, X in enumerate(self.replicas):
            block = X[s * rps : (s + 1) * rps]
            if block.shape[0] < rps:
                block = torch.cat([block, X[:1].expand(rps - block.shape[0], -1)])
            out.append(block)
        return out

    def _initialize_clusters(self, k: int) -> None:
        rng = self._level_rng(0)
        if self.params.initialization_method == RANDOM:
            idx = _random_init(self._n, k, rng)
        elif self.shards is not None:
            from spfresh_tpu_torch.parallel import build as pbuild

            idx = pbuild.kmeanspp_init_sharded(self.devices, self.shards, k,
                                               self.params.metric, self._n, rng)
        else:
            idx = _kmeanspp_init(self.data, k, self.params.metric, rng)
        self.clusters = [Cluster(int(i), np.empty((0,), np.int64), 0) for i in idx]

    def _assign_points(self) -> None:
        """Closure assignment (``"nested"``): every point joins its nearest
        cluster and each one within the closure rule."""
        mask = _np(_assign_with_closure(self.data, self.centroid_vectors(), self.params.metric,
                                        self.params.boundary_threshold))
        for j, c in enumerate(self.clusters):
            c.points = np.flatnonzero(mask[:, j]).astype(np.int64)

    def _update_centroids(self) -> None:
        """Medoid update from the current (possibly overlapping) members."""
        mask = np.zeros((self._n, len(self.clusters)), dtype=bool)
        for j, c in enumerate(self.clusters):
            mask[c.points, j] = True
        old = torch.as_tensor([c.centroid_idx for c in self.clusters], dtype=torch.int64,
                              device=self.device)
        new = _np(_medoid_update(self.data, torch.from_numpy(mask).to(self.device), old,
                                 self.params.metric))
        for j, c in enumerate(self.clusters):
            c.centroid_idx = int(new[j])

    def _assign_and_update_fused(self) -> None:
        old = torch.as_tensor([c.centroid_idx for c in self.clusters], dtype=torch.int64,
                              device=self.device)
        best_d, new_d = _assign_medoid_fused(
            self.data, self.centroid_vectors(), old, k=len(self.clusters),
            metric=self.params.metric,
        )
        best, new = _np(best_d), _np(new_d)
        for j, c in enumerate(self.clusters):
            c.points = np.flatnonzero(best == j).astype(np.int64)
            c.centroid_idx = int(new[j])

    def _assign_and_update_sharded(self) -> None:
        """Device-list path: one assign + medoid round over the row shards
        (closure replicas under ``"nested"``)."""
        from spfresh_tpu_torch.parallel.cluster_step import sharded_cluster_step

        n = self._n
        masks, _, rows = sharded_cluster_step(
            self.devices, self._row_shards(), self.centroid_vectors(),
            boundary_threshold=self.params.boundary_threshold, metric=self.params.metric,
            closure=self.params.replication == "nested",
        )
        mask = torch.cat([m.cpu() for m in masks]).numpy()[:n]
        rows = _np(rows)
        for j, c in enumerate(self.clusters):
            c.points = np.flatnonzero(mask[:, j]).astype(np.int64)
            if 0 <= rows[j] < n:
                c.centroid_idx = int(rows[j])

    def _replica_topk(self, base: np.ndarray, cents: torch.Tensor, n_extra: int,
                      bf16_wire: bool):
        """(idx, dists) (n, n_extra) of the closure pass, on the host."""
        metric = canonical_metric(self.params.metric)
        soar = float(self.params.soar_lambda or 0.0)
        bt = float(np.float32(self.params.boundary_threshold))
        if self.devices:
            from spfresh_tpu_torch.parallel.cluster_step import sharded_replica_pass

            shards = self._row_shards()
            rps = shards[0].shape[0]
            bp = np.concatenate([base, np.repeat(base[:1], rps * len(shards) - self._n)])
            bp = bp.astype(np.int32)
            X_sh = [x.to(torch.bfloat16) if bf16_wire else x for x in shards]
            b_sh = [torch.from_numpy(bp[s * rps : (s + 1) * rps]).to(x.device)
                    for s, x in enumerate(shards)]
            idx, dists = sharded_replica_pass(self.devices, X_sh, b_sh, cents, metric, bt,
                                              n_extra, soar_lambda=soar)
            return (torch.cat([t.cpu() for t in idx]).numpy()[: self._n],
                    torch.cat([t.cpu() for t in dists]).numpy()[: self._n])
        X = self.data.to(torch.bfloat16) if bf16_wire else self.data
        base_dev = torch.from_numpy(base.astype(np.int32)).to(self.device)
        if metric == EUCLIDEAN and n_extra <= MAX_EXTRA:
            idx, dists = replica_topk(X, base_dev, cents, bt, n_extra, soar_lambda=soar)
        else:
            idx, dists = replica_topk_elementwise(X, base_dev, cents, bt, n_extra, metric,
                                                  soar_lambda=soar)
        return _np(idx), _np(dists)

    def _finalize_replication(self) -> None:
        """One global closure pass adding at most max_replicas - 1 replicas
        per point on top of its base cluster, then the per-cluster budget."""
        n_extra = min(self.params.max_replicas - 1, len(self.clusters) - 1)
        if n_extra <= 0:
            return
        timer = self._timer
        n = self._n
        metric = canonical_metric(self.params.metric)
        # bf16 inputs when the corpus rode the bf16 wire: its coordinates
        # are bf16-representable, so the cast is lossless and the kernel
        # streams half the bytes; products stay exact in f32.
        bf16_wire = self.params.wire_dtype not in (None, "float32") and metric == EUCLIDEAN
        with timer.phase("replica/host_base", block=True):
            base = np.zeros(n, np.int64)
            for ci, c in enumerate(self.clusters):
                base[c.points] = ci
            idx_np = np.asarray([c.centroid_idx for c in self.clusters], np.int64)
            cents = torch.from_numpy(self._host_data[idx_np]).to(self.device)
            if bf16_wire:
                cents = cents.to(torch.bfloat16)
        with timer.phase("replica/device+pull", block=True):
            idx, dists = self._replica_topk(base, cents, n_extra, bf16_wire)
            metrics.inc(f"build.replica_engine.{self.device.type}")
        with timer.phase("replica/host_budget"):
            valid = np.isfinite(dists)
            pts = np.broadcast_to(np.arange(n)[:, None], idx.shape)[valid]
            cls = idx[valid].astype(np.int64)
            dst = dists[valid]
            if not len(pts):
                return
            # Per-cluster replica budget: members <= ceil(overflow * cap);
            # the closest replicas win the remaining slots.
            cap = self.params.desired_cluster_size
            if cap is None:
                cap = max(1, int(round(0.18 * n)))
            limit = max(int(np.ceil(self.params.replica_overflow * cap)), 1)
            order = budget_sort(cls, dst)  # by cluster, then dist ascending
            pts, cls = pts[order], cls[order]
            bounds = np.searchsorted(cls, np.arange(len(self.clusters) + 1))
            for ci, c in enumerate(self.clusters):
                budget = max(0, limit - len(c.points))
                extra = pts[bounds[ci] : bounds[ci] + min(budget, bounds[ci + 1] - bounds[ci])]
                if len(extra):
                    c.points = np.sort(np.concatenate([c.points, extra]))

    def _subdivide_clusters(self, cap: int) -> None:
        if self.params.replication == "nested" or self.params.max_split_ways == 2:
            # The reference's binary splits (the in-split closure needs the
            # two-seed geometry).
            self._subdivide_binary(cap)
        else:
            self._subdivide_multiway(cap)

    def _subdivide_multiway(self, cap: int) -> None:
        """Level-synchronous M-way subdivision: every oversized cluster at a
        level splits into ~ceil(len/cap) (<= max_split_ways) children."""
        timer = self._timer
        level = 0
        tail_max = _tail_rows_for(self.device.type, int(self._host_data.shape[1]))
        while True:
            oversized = [i for i, c in enumerate(self.clusters) if len(c) > cap]
            if not oversized:
                break
            level += 1
            with timer.phase("subdiv/host_prep"):
                members = [self.clusters[i].points for i in oversized]
                nm = len(members)
                lens = np.array([len(m) for m in members])
                m_c, M, S, seed_valid, offs = self._level_split_params(lens, cap, level)
                bounds = np.zeros(nm + 1, np.int64)
                np.cumsum(lens, out=bounds[1:])
                P = int(bounds[-1])
                flat_members = np.concatenate(members)
                cluster_of_np = np.repeat(np.arange(nm, dtype=np.int32), lens)
                c1_idx = np.zeros(S, np.int64)
                c1_idx[:nm] = flat_members[bounds[:-1] + offs]
            if P <= tail_max:
                with timer.phase("subdiv/host_level"):
                    assign, seeds, counts, d1 = _split_level_multiway_host(
                        self._host_data, flat_members, cluster_of_np, c1_idx[:nm], m_c,
                        self.params.metric, nm=nm, m_ways=M,
                    )
            elif self.devices:
                from spfresh_tpu_torch.parallel import build as pbuild

                with timer.phase("subdiv/kernel", block=True):
                    if self.shards is not None:
                        # Members dealt to the shards owning their rows;
                        # numpy out, in member order.
                        assign, seeds, counts, d1 = pbuild.sharded_split_level_rows(
                            self.devices, self.shards, flat_members, cluster_of_np, c1_idx,
                            seed_valid, self.params.metric, num_segments=S, m_ways=M,
                        )
                    else:
                        assign, seeds, counts, d1 = pbuild.sharded_split_level(
                            self.devices, self.replicas, flat_members, cluster_of_np,
                            np.ones(P, bool), c1_idx, seed_valid, self.params.metric,
                            num_segments=S, m_ways=M,
                        )
                with timer.phase("subdiv/transfer"):
                    assign, seeds, counts = _np(assign), _np(seeds), _np(counts)[:nm]
            else:
                dev = self.device
                with timer.phase("subdiv/kernel", block=True):
                    assign, seeds, counts, d1 = _split_level_core(
                        self.data,
                        torch.from_numpy(flat_members).to(dev),
                        torch.from_numpy(cluster_of_np.astype(np.int64)).to(dev),
                        torch.from_numpy(c1_idx).to(dev),
                        torch.from_numpy(seed_valid).to(dev),
                        self.params.metric, num_segments=S, m_ways=M,
                    )
                with timer.phase("subdiv/transfer"):
                    assign, seeds, counts = _np(assign), _np(seeds), _np(counts)[:nm]
            self._finish_multiway_level(
                oversized, members, lens, bounds, m_c, M, nm, cluster_of_np, flat_members,
                assign, seeds, counts, d1,
            )

    def _level_split_params(self, lens: np.ndarray, cap: int, level: int):
        """The per-level split recipe (children per cluster, bucketed M and
        S, seed mask, and the Philox draw of each cluster's first seed),
        byte-identical to the JAX package's."""
        nm = len(lens)
        m_c = np.ceil(lens / cap).astype(np.int64)
        m_c = np.clip(m_c, 2, min(self.params.max_split_ways, int(lens.max())))
        m_c = np.minimum(m_c, lens)
        M = next_pow2(int(m_c.max()))
        S = next_pow2(nm)
        seed_valid = np.zeros((S, M), bool)
        seed_valid[:nm] = np.arange(M)[None, :] < m_c[:, None]
        offs = self._level_rng(1000 + level).integers(0, np.maximum(lens, 1))
        return m_c, M, S, seed_valid, offs

    def _finish_multiway_level(
        self, oversized, members, lens, bounds, m_c, M, nm,
        cluster_of_np, flat_members, assign, seeds, counts, d1,
    ) -> None:
        """Host bookkeeping shared by the device and host split paths:
        degenerate (no-progress) splits fall back to a balanced quantile
        split on d1; children come from one global stable sort."""
        P = flat_members.shape[0]
        with self._timer.phase("subdiv/host_build"):
            assign = np.asarray(assign)[:P]
            seeds = np.asarray(seeds)
            counts = np.asarray(counts)[:nm]
            degenerate = counts.max(axis=1) == lens
            d1 = _np(d1)[:P] if degenerate.any() else None
            key = cluster_of_np * M + assign
            order = np.argsort(key, kind="stable")
            sorted_members = flat_members[order]
            cnt = np.bincount(key, minlength=nm * M)
            parts = np.split(sorted_members, np.cumsum(cnt)[:-1])
            new_tail: List[Cluster] = []
            for r, ci in enumerate(oversized):
                depth = self.clusters[ci].depth + 1
                if degenerate[r]:
                    lo, hi = int(bounds[r]), int(bounds[r + 1])
                    mem = members[r]
                    order_r = np.argsort(d1[lo:hi], kind="stable")
                    qparts = np.array_split(mem[order_r], int(m_c[r]))
                    childs = [(int(p[0]), p) for p in qparts if len(p)]
                else:
                    childs = [
                        (int(seeds[r, j]), parts[r * M + j])
                        for j in range(M)
                        if len(parts[r * M + j])
                    ]
                self.clusters[ci] = Cluster(childs[0][0], childs[0][1], depth)
                for cidx, pts_ in childs[1:]:
                    new_tail.append(Cluster(cidx, pts_, depth))
            self.clusters.extend(new_tail)

    def _subdivide_binary(self, cap: int) -> None:
        """Level-synchronous binary subdivision (``max_split_ways`` 2 or
        ``"nested"``): every oversized cluster splits in two at each level,
        with the in-split closure under ``"nested"``; a split with an empty
        or a whole child falls back to an exact balanced median split on
        the distance to seed 1.  Runs on ``device`` (the replicated
        layout's first copy on a device list)."""
        timer = self._timer
        closure = self.params.replication == "nested"
        dev = self.device
        level = 0
        while True:
            oversized = [i for i, c in enumerate(self.clusters) if len(c) > cap]
            if not oversized:
                break
            level += 1
            with timer.phase("subdiv/host_prep"):
                members = [self.clusters[i].points for i in oversized]
                nm = len(members)
                lens = np.array([len(m) for m in members])
                bounds = np.zeros(nm + 1, np.int64)
                np.cumsum(lens, out=bounds[1:])
                P = int(bounds[-1])
                flat_members = np.concatenate(members)
                cluster_of = np.repeat(np.arange(nm, dtype=np.int64), lens)
                # A random member as seed 1 of each cluster: the same host
                # draw as the multi-way levels.
                offs = self._level_rng(1000 + level).integers(0, np.maximum(lens, 1))
                c1_idx = flat_members[bounds[:-1] + offs]
            with timer.phase("subdiv/kernel", block=True):
                m1, m2, c2_idx, degenerate, d1 = _split_level_flat(
                    self.data,
                    torch.from_numpy(flat_members).to(dev),
                    torch.from_numpy(cluster_of).to(dev),
                    torch.ones(P, dtype=torch.bool, device=dev),
                    torch.from_numpy(c1_idx).to(dev),
                    self.params.metric, self.params.boundary_threshold,
                    closure=closure, num_segments=nm,
                )
            with timer.phase("subdiv/transfer"):
                m1, m2, c2_idx, degenerate = _np(m1), _np(m2), _np(c2_idx), _np(degenerate)
                d1 = _np(d1) if degenerate.any() else None
            with timer.phase("subdiv/host_build"):
                cnt1 = np.add.reduceat(m1.astype(np.int64), bounds[:-1])
                cnt2 = np.add.reduceat(m2.astype(np.int64), bounds[:-1])
                parts1 = np.split(flat_members[m1], np.cumsum(cnt1)[:-1])
                parts2 = np.split(flat_members[m2], np.cumsum(cnt2)[:-1])
                new_tail: List[Cluster] = []
                for r, ci in enumerate(oversized):
                    depth = self.clusters[ci].depth + 1
                    if degenerate[r]:
                        lo, hi = int(bounds[r]), int(bounds[r + 1])
                        mem = members[r]
                        order = np.argsort(d1[lo:hi], kind="stable")
                        sel = np.zeros(len(mem), bool)
                        sel[order[: (len(mem) + 1) // 2]] = True
                        pts1, pts2 = mem[sel], mem[~sel]
                    else:
                        pts1, pts2 = parts1[r], parts2[r]
                    self.clusters[ci] = Cluster(int(c1_idx[r]), pts1, depth)
                    new_tail.append(Cluster(int(c2_idx[r]), pts2, depth))
                self.clusters.extend(new_tail)
