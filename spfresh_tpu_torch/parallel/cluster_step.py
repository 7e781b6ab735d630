"""One assign + medoid round and the closure-replica pass over a list of
devices (counterpart of ``spfresh_tpu/parallel/cluster_step.py``).

The corpus is dealt in equal contiguous row blocks, one a device-list
entry (shard ``s`` holds rows ``s * rps .. (s + 1) * rps``).  Each shard
scores its rows against its own copy of the centroids.  The JAX package
meets the shards in ``psum`` and ``all_gather`` under ``shard_map``; here
each of those is a copy of a small tensor to the first entry and a
reduction there (a sum in shard order, a max or a min), copied back to the
shards that need it.  Nothing in a round waits on the host.

``replicate`` and ``shard_rows`` of the JAX package place arrays on a
``Mesh`` and have no counterpart: the shards are plain tensors, one per
entry.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spfresh_tpu_torch.clustering.hierarchical import membership
from spfresh_tpu_torch.core.device import resolve_entries
from spfresh_tpu_torch.core.dtypes import ACCUM_DTYPE
from spfresh_tpu_torch.ops.distances import EUCLIDEAN, canonical_metric, pairwise_distance
from spfresh_tpu_torch.ops.replica import MAX_EXTRA, replica_topk, replica_topk_elementwise


def as_shards(devices: Sequence[torch.device], X) -> List[torch.Tensor]:
    """The per-shard row blocks ``X``, one an entry, each moved to its
    entry.  Raises unless every shard has the same number of rows (pad
    first)."""
    if len(X) != len(devices):
        raise ValueError(f"{len(X)} shards for {len(devices)} devices")
    shards = [torch.as_tensor(x).to(dv) for x, dv in zip(X, devices)]
    if len({x.shape[0] for x in shards}) != 1:
        raise ValueError(f"ragged shards {[x.shape[0] for x in shards]} (pad first)")
    return shards


def gather_sum(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """The shards' tensors summed on ``dev`` in shard order."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def gather_reduce(parts: Sequence[torch.Tensor], dev: torch.device, op: str) -> torch.Tensor:
    """Elementwise max (``op="max"``) or min of the shards' tensors on
    ``dev``."""
    stacked = torch.stack([p.to(dev) for p in parts])
    return torch.amax(stacked, dim=0) if op == "max" else torch.amin(stacked, dim=0)


def owner_rows(shards: Sequence[torch.Tensor], rows, dev0: torch.device) -> torch.Tensor:
    """Corpus rows (m,) of a row-sharded corpus as (m, d) on ``dev0``: the
    sum of each shard's contribution (its own rows, zeros elsewhere)."""
    rps = shards[0].shape[0]
    parts = []
    for s, x in enumerate(shards):
        r = rows.to(x.device) - s * rps
        mine = (r >= 0) & (r < rps)
        v = x[torch.clamp(r, 0, rps - 1)]
        parts.append(torch.where(mine[..., None], v, torch.zeros_like(v)))
    return gather_sum(parts, dev0)


def sharded_cluster_step(
    devices: Sequence,
    X_shards,
    cents,
    boundary_threshold: float = 1.1,
    metric: str = EUCLIDEAN,
    closure: bool = True,
):
    """One assign + medoid-update round, data-sharded.

    ``X_shards``: the corpus rows (see ``as_shards``); ``cents`` (k, d).
    Returns (member masks, one (rps, k) bool tensor a shard on its entry;
    new centroid vectors (k, d) on the first entry; medoid rows (k,) int64
    on the first entry, -1 for an empty cluster).  ``closure=False`` is
    hard nearest-centroid assignment.  The means are the shards' segment sums added in shard
    order; the medoid is the lexicographic global argmin over (distance,
    global row), the distances and rows gathered as separate tensors;
    its vector comes from the shard that owns the row.  Empty clusters
    keep their centroid."""
    devs = resolve_entries(devices)
    xs = as_shards(devs, X_shards)
    metric = canonical_metric(metric)
    dev0 = devs[0]
    rps = xs[0].shape[0]
    cents0 = torch.as_tensor(cents).to(dev0, ACCUM_DTYPE)
    masks, sums, counts = [], [], []
    for x in xs:
        c = cents0.to(x.device)
        mask = membership(pairwise_distance(x, c, metric), c, metric, boundary_threshold,
                          closure)  # (rps, k)
        m = mask.to(ACCUM_DTYPE)
        sums.append(torch.matmul(m.T, x.to(ACCUM_DTYPE)))  # (k, d)
        counts.append(torch.sum(m, dim=0))
        masks.append(mask)
    total = gather_sum(counts, dev0)
    means = gather_sum(sums, dev0) / torch.clamp_min(total, 1.0)[:, None]

    best_d, best_r = [], []
    for s, (x, mask) in enumerate(zip(xs, masks)):
        Dm = pairwise_distance(x, means.to(x.device), metric)  # (rps, k)
        Dm = torch.where(mask, Dm, torch.full_like(Dm, float("inf")))
        best_d.append(torch.amin(Dm, dim=0))
        best_r.append(torch.argmin(Dm, dim=0) + s * rps)  # global rows
    dists_all = torch.stack([t.to(dev0) for t in best_d])  # (S, k)
    rows_all = torch.stack([t.to(dev0) for t in best_r])
    at_min = dists_all == torch.amin(dists_all, dim=0)[None, :]
    big = torch.full_like(rows_all, torch.iinfo(torch.int64).max)
    best_rows = torch.amin(torch.where(at_min, rows_all, big), dim=0)  # (k,)

    new_cents = owner_rows(xs, best_rows, dev0).to(ACCUM_DTYPE)
    empty = total <= 0
    new_cents = torch.where(empty[:, None], cents0, new_cents)
    return masks, new_cents, torch.where(empty, -1, best_rows)


def sharded_replica_pass(
    devices: Sequence,
    X_shards,
    base_shards,
    cents,
    metric: str = EUCLIDEAN,
    boundary_threshold: float = 1.1,
    n_extra: int = 7,
    soar_lambda: float = 0.0,
):
    """Closure-replica pass, data-sharded: each shard runs the
    single-device pass on its rows against the centroids copied to its
    entry, with no reduction between shards.  Euclidean with at most 8
    replicas takes ``ops.replica.replica_topk`` (the replica kernel on a
    CUDA entry), others ``replica_topk_elementwise`` (the L1/Linf kernel
    for its distance blocks on a CUDA entry).  ``base_shards``: int32 base
    cluster ids, sharded like X.  Returns (idx, dists): one
    (rps, n_extra) int32 and f32 tensor a shard on its entry."""
    devs = resolve_entries(devices)
    xs = as_shards(devs, X_shards)
    bs = as_shards(devs, base_shards)
    metric = canonical_metric(metric)
    bt = float(np.float32(boundary_threshold))
    fused = metric == EUCLIDEAN and n_extra <= MAX_EXTRA
    cents = torch.as_tensor(cents)
    idx, dists = [], []
    for x, b in zip(xs, bs):
        c = cents.to(x.device, x.dtype)
        if fused:
            i, d = replica_topk(x, b, c, bt, n_extra, soar_lambda=soar_lambda)
        else:
            i, d = replica_topk_elementwise(x, b, c, bt, n_extra, metric, soar_lambda=soar_lambda)
        idx.append(i)
        dists.append(d)
    return idx, dists
