"""The build's subdivision levels and KMeans++ seeding over a list of
devices (counterpart of ``spfresh_tpu/parallel/build.py``).

Two corpus layouts, as in the JAX package:

* ``sharded_split_level`` — a full corpus copy on every entry, the level's
  member list dealt over the shards in contiguous blocks (padding entries
  ``valid=False``).
* ``sharded_split_level_rows`` / ``kmeanspp_init_sharded`` — the corpus
  row-sharded (``rps`` rows an entry).  The host deals each member to the
  shard that owns its row; a row another shard needs (a seed vector, a
  KMeans++ draw) is the sum of every shard's contribution, the owner's row
  and zeros elsewhere.

Both run the farthest-point loop ``_fpoint_loop``: each of the ``M - 1``
rounds meets the shards in a segment max, a segment min over the members'
original positions (the single-device tie-break, carried as data so the
deal cannot change it) and a sum of the winner's id and vector, each a copy
of an (S,)- or (S, d)-sized tensor to the first entry and a reduction
there.  The results equal ``hierarchical._split_level_core``'s.  Nothing in
a level waits on the host.

Not ported: the device-resident split and apply calls of the JAX package
(``_resident_split_call``, ``_resident_apply_call``), as the single-device
resident subdivision is not.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spfresh_tpu_torch.clustering.utils import seg_max, seg_min, seg_sum
from spfresh_tpu_torch.core.device import resolve_entries
from spfresh_tpu_torch.ops.distances import canonical_metric, rowwise_distance
from spfresh_tpu_torch.parallel.cluster_step import gather_reduce, gather_sum, owner_rows


def _fpoint_loop(shards: List[dict], c1v: List[torch.Tensor], c1, seed_valid, metric: str,
                 S_seg: int, M: int, pbig: int, dev0: torch.device):
    """The farthest-point M-way split over member entries dealt to shards.

    Each shard dict holds, on its entry: ``pts`` (L, d) member vectors,
    ``gpid`` (L,) their corpus rows, ``co`` (L,) segments, ``valid`` (L,)
    and ``opos`` (L,) the tie-break key (each member's position in the
    single-device member order; ``pbig`` for padding).  ``c1v``: seed-0
    vectors (S_seg, d) on each shard's entry; ``c1`` (S_seg,) and
    ``seed_valid`` (S_seg, M) on ``dev0``.  Returns (best_j, d1) a shard,
    and seeds (S_seg, M), counts (S_seg, M) on ``dev0``."""
    for sh, v in zip(shards, c1v):
        sh["d_min"] = rowwise_distance(sh["pts"], v[sh["co"]], metric)
        sh["d1"] = sh["d_min"]
        sh["best_j"] = torch.zeros_like(sh["co"])
        sh["taken"] = sh["gpid"] == c1.to(sh["pts"].device)[sh["co"]]
        sh["L"] = torch.arange(sh["co"].shape[0], device=sh["co"].device)
    seeds = torch.zeros((S_seg, M), dtype=torch.int64, device=dev0)
    seeds[:, 0] = c1
    for j in range(1, M):
        ok = seed_valid[:, j]
        for sh in shards:
            sh["ok"] = ok.to(sh["co"].device)[sh["co"]]
            sh["cand"] = sh["valid"] & ~sh["taken"] & sh["ok"]
            sh["dm"] = torch.where(sh["cand"], sh["d_min"], torch.full_like(sh["d_min"],
                                                                           float("-inf")))
        gmax = gather_reduce([seg_max(sh["dm"], sh["co"], S_seg) for sh in shards], dev0, "max")
        for sh in shards:
            sh["at_max"] = (sh["dm"] == gmax.to(sh["dm"].device)[sh["co"]]) & sh["cand"]
        gpos = gather_reduce([
            seg_min(torch.where(sh["at_max"], sh["opos"], torch.full_like(sh["opos"], pbig)),
                     sh["co"], S_seg, pbig)
            for sh in shards], dev0, "min")
        found = gpos < pbig
        seed_parts, vec_parts = [], []
        for sh in shards:
            L = sh["co"].shape[0]
            sh["gpos"] = gpos.to(sh["co"].device)[sh["co"]]
            mine = sh["at_max"] & (sh["opos"] == sh["gpos"])  # the unique winner entry
            li = seg_min(torch.where(mine, sh["L"], torch.full_like(sh["L"], L)), sh["co"],
                          S_seg, L)
            own = li < L
            li = torch.clamp(li, max=L - 1)
            seed_parts.append(torch.where(own, sh["gpid"][li], torch.zeros_like(li)))
            v = sh["pts"][li]
            vec_parts.append(torch.where(own[:, None], v, torch.zeros_like(v)))
        seed_j = torch.where(found, gather_sum(seed_parts, dev0), c1)
        seeds[:, j] = seed_j
        vec = gather_sum(vec_parts, dev0)  # winners' vectors (zeros where none)
        use = ok & found
        for sh in shards:
            dv = sh["co"].device
            use_p = use.to(dv)[sh["co"]]
            d_new = rowwise_distance(sh["pts"], vec.to(dv)[sh["co"]], metric)
            upd = use_p & (d_new < sh["d_min"])
            sh["best_j"] = torch.where(upd, j, sh["best_j"])
            sh["d_min"] = torch.where(upd, d_new, sh["d_min"])
            sh["taken"] = sh["taken"] | ((sh["opos"] == sh["gpos"]) & use_p)
    counts = gather_sum([
        seg_sum(sh["valid"].to(torch.int64), sh["co"] * M + sh["best_j"], S_seg * M)
        for sh in shards], dev0).reshape(S_seg, M)
    return [sh["best_j"] for sh in shards], seeds, counts, [sh["d1"] for sh in shards]


def sharded_split_level(
    devices: Sequence,
    X_rep,
    point_list,
    cluster_of,
    valid,
    c1_idx,
    seed_valid,
    metric: str,
    num_segments: int,
    m_ways: int,
):
    """Replicated-corpus counterpart of ``_split_level_core``: ``X_rep`` is
    one full (n, d) corpus copy an entry; the member tables (P,) are
    padded to a multiple of the shard count with ``valid=False`` entries
    and dealt in contiguous blocks.  Returns
    (assign (P,), seeds (S, M), counts (S, M), d1 (P,)) on the first
    entry."""
    devs = resolve_entries(devices)
    S = len(devs)
    dev0 = devs[0]
    metric = canonical_metric(metric)
    reps = [torch.as_tensor(x).to(dv) for x, dv in zip(X_rep, devs)]
    pl = np.asarray(point_list, np.int64)
    co = np.asarray(cluster_of, np.int64)
    vl = np.asarray(valid, bool)
    P = pl.shape[0]
    P_pad = -(-P // S) * S
    if P_pad != P:
        pl = np.concatenate([pl, np.repeat(pl[:1], P_pad - P)])
        co = np.concatenate([co, np.repeat(co[:1], P_pad - P)])
        vl = np.concatenate([vl, np.zeros(P_pad - P, bool)])
    L = P_pad // S
    c1 = torch.from_numpy(np.asarray(c1_idx, np.int64)).to(dev0)
    shards, c1v = [], []
    for s, (X, dv) in enumerate(zip(reps, devs)):
        sl = slice(s * L, (s + 1) * L)
        pid = torch.from_numpy(pl[sl]).to(dv)
        shards.append({"pts": X[pid], "gpid": pid, "co": torch.from_numpy(co[sl]).to(dv),
                       "valid": torch.from_numpy(vl[sl]).to(dv),
                       "opos": torch.arange(s * L, (s + 1) * L, device=dv)})
        c1v.append(X[c1.to(dv)])
    best_j, seeds, counts, d1 = _fpoint_loop(
        shards, c1v, c1, torch.from_numpy(np.asarray(seed_valid, bool)).to(dev0), metric,
        num_segments, m_ways, P_pad, dev0)
    assign = torch.cat([b.to(dev0) for b in best_j])[:P]
    return assign, seeds, counts, torch.cat([d.to(dev0) for d in d1])[:P]


def sharded_split_level_rows(
    devices: Sequence,
    X_shards: Sequence[torch.Tensor],
    flat_members,
    cluster_of,
    c1_idx,
    seed_valid,
    metric: str,
    num_segments: int,
    m_ways: int,
):
    """Row-sharded-corpus counterpart of ``_split_level_core``.

    ``X_shards``: one (rps, d) block an entry (the corpus padded to S *
    rps rows).  The host deals each member entry to the shard owning its
    row (owner = id // rps), padding every shard's list to a common
    length; the members' original positions ride along as the tie-break
    key (``opos``, sentinel P).  Returns (assign (P,), seeds, counts,
    d1 (P,)) as numpy, un-permuted to the caller's member order."""
    devs = resolve_entries(devices)
    S = len(devs)
    dev0 = devs[0]
    metric = canonical_metric(metric)
    X_shards = [x.to(dv) for x, dv in zip(X_shards, devs)]
    rps = X_shards[0].shape[0]
    fm = np.asarray(flat_members, np.int64)
    co_all = np.asarray(cluster_of, np.int64)
    P = fm.shape[0]
    owner = fm // rps
    order = np.argsort(owner, kind="stable")
    cnt = np.bincount(owner, minlength=S)
    L = max(8, -(-int(cnt.max()) // 8) * 8)
    offs = np.zeros(S + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    c1 = torch.from_numpy(np.asarray(c1_idx, np.int64)).to(dev0)
    c1_vecs = owner_rows(X_shards, c1, dev0)
    shards, c1v, opos_h = [], [], []
    for s, (x, dv) in enumerate(zip(X_shards, devs)):
        m = int(cnt[s])
        take = order[offs[s] : offs[s] + m]
        pid = np.zeros(L, np.int64)
        co = np.zeros(L, np.int64)
        valid = np.zeros(L, bool)
        opos = np.full(L, P, np.int64)  # the pbig sentinel for padding
        pid[:m] = fm[take] - s * rps
        co[:m] = co_all[take]
        valid[:m] = True
        opos[:m] = take
        opos_h.append(opos)
        pid_d = torch.from_numpy(pid).to(dv)
        shards.append({"pts": x[pid_d], "gpid": pid_d + s * rps,
                       "co": torch.from_numpy(co).to(dv),
                       "valid": torch.from_numpy(valid).to(dv),
                       "opos": torch.from_numpy(opos).to(dv)})
        c1v.append(c1_vecs.to(dv))
    best_j, seeds, counts, d1 = _fpoint_loop(
        shards, c1v, c1, torch.from_numpy(np.asarray(seed_valid, bool)).to(dev0), metric,
        num_segments, m_ways, P, dev0)
    assign = np.zeros(P, np.int64)
    d1_out = np.zeros(P, np.float32)
    for opos, b, d in zip(opos_h, best_j, d1):
        real = opos < P
        assign[opos[real]] = b.cpu().numpy()[real]
        d1_out[opos[real]] = d.cpu().numpy()[real]
    return assign, seeds.cpu().numpy(), counts.cpu().numpy(), d1_out


def kmeanspp_init_sharded(devices: Sequence, X_shards: Sequence[torch.Tensor], k: int,
                          metric: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """KMeans++ seeding over a row-sharded corpus, equal to the single
    device's ``hierarchical._kmeanspp_init`` for the same ``rng``: each
    shard keeps its rows' running min-distance; the (n,) weights are the
    shards' distances side by side, cut to the ``n`` real rows, drawn on
    the host in f64; the drawn row's vector comes from its owner."""
    devs = resolve_entries(devices)
    dev0 = devs[0]
    metric = canonical_metric(metric)
    X_shards = [x.to(dv) for x, dv in zip(X_shards, devs)]

    def dists_to(row: int) -> List[torch.Tensor]:
        v = owner_rows(X_shards, torch.tensor([row], device=dev0), dev0)  # (1, d)
        return [rowwise_distance(x, v.to(x.device), metric) for x in X_shards]

    first = int(rng.integers(0, n))
    min_d = dists_to(first)
    chosen = [first]
    for _ in range(1, k):
        w = torch.cat([m.cpu() for m in min_d]).numpy()[:n].astype(np.float64) ** 2
        total = w.sum()
        p = w / total if total > 0 else np.full(n, 1.0 / n)
        idx = int(rng.choice(n, p=p))
        chosen.append(idx)
        min_d = [torch.minimum(a, b) for a, b in zip(min_d, dists_to(idx))]
    return np.asarray(chosen, np.int64)
