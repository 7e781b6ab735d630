"""The comparison that decides ``correct``.

It judges the answers the timed searches returned, and the state the writer
left, against the plain reference (``annbench.reference``), which works
everything out again from the inputs the benchmark made: the rows each id
stands for, when each id was inserted and deleted, the live set.  Four
numbers are compared, each with a limit of its own (``limits/<cell>.json``):

* ``dist_err``: over every returned (query, id), the gap between the
  returned distance and the reference's squared L2 from the query to that
  id's row as the configuration stores it, relative to the larger of that
  distance and the median one.
* ``wrong``: answers and acknowledgements that say the wrong thing: an id
  that was not live while its search ran (deleted before it began, inserted
  after it ended, or none at all), an id twice in a row, a missing row or
  slot, a failed request, a delete of a live id that was not acknowledged;
  and, of the state after the window, a live id in no posting (an
  acknowledged insert lost, or a corpus row the build left out) or a deleted
  id still in one.
* ``missed``: of the judged rows, the share of the reference's 10 nearest
  (stored rows, live set) that lie in a posting the query surely probes, are
  closer than the row's own 10th answer, and were not returned.  Which
  postings a query probes follows the program's own postings and centroids
  (the build's clustering is the program's; the reference does not redo it):
  a posting is surely probed when its centroid, at the stored precision, is
  nearer than the (nprobe+1)-th by more than the stage-1 rounding
  (``TOL_PROBE``).  Without a snapshot (an exact search stands in the
  system's place) every live row counts as probed.
* ``stray``: of the state the searches saw, the share of live ids that no
  posting among their ``nprobe`` nearest holds, by the reference's own f64
  scan of every live row against the postings' centroids, so a search for
  the row itself would not reach it; taken apart for corpus rows and for
  acknowledged inserts, and the larger share is compared.  An id put in a
  far posting (by the build, an insert, a split or a reassign) counts here,
  where ``missed``, which follows the program's own postings, cannot see it.

``recall_at_10`` of the judged rows against the reference's exact 10 nearest
of the f32 rows comes out of the same pass.

Residual int8 storage (``reference/sq8.py``) keeps a row once in each
posting that holds it, each copy at a value of its own.  There ``dist_err``
takes, of each returned (query, id), the copy whose reference distance lies
nearest the returned one; ``missed`` ranks each candidate by its nearest
copy among the postings the query surely probes, and routes on the
unrounded f32 queries and centroids, as a store of this kind does.  Without
a snapshot there are no copies: each row is stored once, at the wire
precision.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from annbench.reference import sq8
from annbench.reference.exact import exact_topk, nearest_centroids, prefilter, round_to, \
    sq_l2_f64

TOL_PROBE = 1e-4   # stage-1 rounding, relative to |q|^2 + max |c|^2 (f32 sums: ~1e-6)
TOL_RANK = 1e-4    # a reference neighbour counts as closer than the row's 10th past this
PAIR_CHUNK = 1 << 20


@dataclasses.dataclass
class Answers:
    rows: np.ndarray                 # query-table rows (m,)
    ids: Optional[np.ndarray]        # (m, k) int64, None when the request failed
    dists: Optional[np.ndarray]      # (m, k) f32
    start: float
    end: float
    judged: bool                     # counted in ``missed`` and ``recall_at_10``


@dataclasses.dataclass
class Ledger:
    """Each id's life on the host clock: ``born`` the first moment it may be
    returned (-inf for corpus rows, the start of its insert, +inf if never
    inserted), ``dead`` the end of its acknowledged delete (+inf if never)."""

    born: np.ndarray
    dead: np.ndarray

    @property
    def live(self) -> np.ndarray:
        """Ids inserted (or in the corpus) and not deleted."""
        return ~np.isposinf(self.born) & np.isposinf(self.dead)


def _wrong_slots(a: Answers, ledger: Ledger, k: int) -> int:
    if a.ids is None:
        return len(a.rows) * k
    ids = np.asarray(a.ids)
    wrong = max(0, len(a.rows) - ids.shape[0]) * k + max(0, k - ids.shape[1]) * ids.shape[0]
    n = len(ledger.born)
    inr = (ids >= 0) & (ids < n)
    safe = np.where(inr, ids, 0)
    valid = inr & (ledger.born[safe] <= a.end) & (ledger.dead[safe] >= a.start)
    wrong += int((~valid).sum())
    s = np.sort(np.where(valid, ids, -1), axis=1)
    wrong += int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).sum())
    return wrong


def _returned(answers: List[Answers], n: int):
    """(query rows, ids, distances f64) of every returned in-range id with a
    finite distance, or None where there is none."""
    q_rows, ids, got = [], [], []
    for a in answers:
        if a.ids is None:
            continue
        m = min(len(a.rows), a.ids.shape[0])
        i = np.asarray(a.ids[:m])
        ok = (i >= 0) & (i < n) & np.isfinite(a.dists[:m])
        q_rows.append(np.broadcast_to(a.rows[:m, None], i.shape)[ok])
        ids.append(i[ok])
        got.append(np.asarray(a.dists[:m], np.float64)[ok])
    if not ids or not sum(len(x) for x in ids):
        return None
    return tuple(np.concatenate(x) for x in (q_rows, ids, got))


def _dist_err(rows_all, table, answers: List[Answers], ledger: Ledger, storage) -> float:
    returned = _returned(answers, len(ledger.born))
    if returned is None:
        return float("inf")
    q_rows, ids, got = returned
    dev = rows_all.device
    ref = []
    for s in range(0, len(ids), PAIR_CHUNK):
        qi = torch.from_numpy(q_rows[s:s + PAIR_CHUNK]).to(dev)
        ii = torch.from_numpy(ids[s:s + PAIR_CHUNK]).to(dev)
        ref.append(sq_l2_f64(table[qi], round_to(rows_all[ii], storage)))
    ref = torch.cat(ref)
    got = torch.from_numpy(got).to(dev)
    scale = torch.clamp_min(ref, float(ref.median()))
    return float(((got - ref).abs() / scale).max())


class _Copies:
    """The stored copies of residual int8 storage: the snapshot's (id,
    posting) pairs sorted by id, with every posting's scale worked out
    again from its members (``reference.sq8``)."""

    def __init__(self, rows_all: torch.Tensor, snapshot):
        dev = rows_all.device
        mids, mpost = snapshot.member_ids, snapshot.member_post
        inr = (mids >= 0) & (mids < rows_all.shape[0])
        order = np.argsort(mids[inr], kind="stable")
        self.ids = torch.from_numpy(mids[inr][order]).to(dev)
        self.posts = torch.from_numpy(mpost[inr][order]).to(dev)
        self.rows = rows_all
        self.cent = torch.from_numpy(snapshot.centroids).to(dev)
        self.scales = sq8.posting_scales(rows_all, self.cent, self.ids, self.posts)

    def distances(self, queries: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor):
        """(P, W) f64 squared L2 from ``queries[qidx]`` to each stored copy of
        ``ids`` (P,), and (P, W) the copy's posting; +inf and -1 past an
        id's copies (W at least 1)."""
        lo = torch.searchsorted(self.ids, ids)
        hi = torch.searchsorted(self.ids, ids, right=True)
        width = max(1, int((hi - lo).max()) if ids.numel() else 0)
        dist = torch.full((ids.shape[0], width), float("inf"), dtype=torch.float64,
                          device=ids.device)
        post = torch.full((ids.shape[0], width), -1, dtype=torch.int64, device=ids.device)
        for o in range(width):
            sel = torch.nonzero(lo + o < hi).squeeze(1)
            p = self.posts[lo[sel] + o]
            dist[sel, o] = sq8.copy_distances(queries, qidx[sel], self.rows, self.cent,
                                              self.scales, ids[sel], p)
            post[sel, o] = p
        return dist, post


def _dist_err_copies(table, answers: List[Answers], ledger: Ledger, copies: _Copies) -> float:
    """``dist_err`` where a row has a stored copy in each posting that holds
    it: against the copy whose reference distance lies nearest the returned
    one (an id with no copy reads +inf)."""
    returned = _returned(answers, len(ledger.born))
    if returned is None:
        return float("inf")
    dev = copies.ids.device
    q_rows, ids, got = (torch.from_numpy(x).to(dev) for x in returned)
    dist, _ = copies.distances(table, q_rows, ids)
    j = (got[:, None] - dist).abs().argmin(1, keepdim=True)
    ref = dist.gather(1, j).squeeze(1)
    if not torch.isfinite(ref).all():
        return float("inf")
    scale = torch.clamp_min(ref, float(ref.median()))
    return float(((got - ref).abs() / scale).max())


def _nearest_copies(copies: _Copies, tq: torch.Tensor, cand: torch.Tensor, live: torch.Tensor,
                    nprobe: int, k: int):
    """The reference's k nearest of the candidates ``cand`` (U, c) of the
    queries ``tq`` (U, d), each ranked by its nearest stored copy among the
    postings its query surely probes (routed on the f32 queries and
    centroids), ties to the lower row: (ids (U, k), distances (U, k) f64,
    reachable (U, k): the id has such a copy)."""
    U, c = cand.shape
    probed = _surely_probed(tq.to(torch.float64), copies.cent.to(torch.float64), nprobe)
    qidx = torch.arange(U, device=cand.device).repeat_interleave(c)
    dist, post = copies.distances(tq, qidx, cand.reshape(-1))
    inside = (post >= 0) & probed[qidx[:, None], post.clamp_min(0)]
    e = torch.where(inside, dist, torch.full_like(dist, float("inf"))).min(1).values
    e = e.reshape(U, c).masked_fill(~live[cand], float("inf"))
    order = torch.argsort(cand, dim=1)
    cand, e = torch.gather(cand, 1, order), torch.gather(e, 1, order)
    srt = torch.argsort(e, dim=1, stable=True)[:, :k]
    J, E = torch.gather(cand, 1, srt), torch.gather(e, 1, srt)
    return J, E, torch.isfinite(E)


def _surely_probed(q: torch.Tensor, cent: torch.Tensor, nprobe: int) -> torch.Tensor:
    """(Q, C) bool: posting certainly among each query's nprobe probes."""
    C = cent.shape[0]
    if C <= nprobe:
        return torch.ones((q.shape[0], C), dtype=torch.bool, device=q.device)
    out = []
    c2 = (cent * cent).sum(1)
    for s in range(0, q.shape[0], 1024):
        qb = q[s:s + 1024]
        q2 = (qb * qb).sum(1, keepdim=True)
        d = q2 + c2[None, :] - 2.0 * qb @ cent.T
        thr = torch.topk(d, nprobe + 1, dim=1, largest=False).values[:, nprobe:]
        tol = TOL_PROBE * (q2 + c2.max())
        out.append(d + tol < thr)
    return torch.cat(out)


def _reachable(table, snapshot, uq: np.ndarray, J: torch.Tensor, nprobe: int,
               storage) -> torch.Tensor:
    """(U, 10) bool: each reference neighbour lies in a surely probed posting."""
    dev = J.device
    if snapshot is None:
        return torch.ones_like(J, dtype=torch.bool)
    order = np.argsort(snapshot.member_ids, kind="stable")
    mids, mpost = snapshot.member_ids[order], snapshot.member_post[order]
    q = round_to(table[torch.from_numpy(uq).to(dev)], storage).to(torch.float64)
    cent = round_to(torch.from_numpy(snapshot.centroids).to(dev), storage).to(torch.float64)
    probed = _surely_probed(q, cent, nprobe)                          # (U, C)
    mids_t = torch.from_numpy(mids).to(dev)
    mpost_t = torch.from_numpy(mpost).to(dev)
    lo = torch.searchsorted(mids_t, J)
    hi = torch.searchsorted(mids_t, J, right=True)
    reach = torch.zeros_like(J, dtype=torch.bool)
    width = int((hi - lo).max()) if J.numel() else 0
    rowsel = torch.arange(J.shape[0], device=dev)[:, None].expand_as(J)
    for o in range(width):
        pos = lo + o
        has = pos < hi
        p = mpost_t[torch.clamp(pos, max=len(mids) - 1)]
        reach |= has & probed[rowsel, p]
    return reach


def _stray(rows_all: torch.Tensor, ledger: Ledger, snapshot, r: int) -> float:
    """The larger of the corpus rows' and the inserts' stray shares."""
    if snapshot is None:
        return 0.0
    dev = rows_all.device
    live_ids = np.flatnonzero(ledger.live)
    if not len(live_ids) or not len(snapshot.centroids):
        return float(len(live_ids) > 0)
    near = nearest_centroids(rows_all[torch.from_numpy(live_ids).to(dev)],
                             torch.from_numpy(snapshot.centroids).to(dev), r)   # (L, r)
    slot = np.full(len(ledger.born), -1, np.int64)
    slot[live_ids] = np.arange(len(live_ids))
    held = torch.zeros(len(live_ids), dtype=torch.bool, device=dev)
    mids, mpost = snapshot.member_ids, snapshot.member_post
    inr = (mids >= 0) & (mids < len(slot))
    mids, mpost = mids[inr], mpost[inr]
    at = slot[mids]
    mids, mpost, at = mids[at >= 0], mpost[at >= 0], at[at >= 0]
    for s in range(0, len(at), PAIR_CHUNK):
        a = torch.from_numpy(at[s:s + PAIR_CHUNK]).to(dev)
        p = torch.from_numpy(mpost[s:s + PAIR_CHUNK]).to(dev)
        ok = (near[a] == p[:, None]).any(1)
        held[a[ok]] = True
    stray = ~held.cpu().numpy()
    corpus = np.isneginf(ledger.born[live_ids])
    shares = [float(stray[g].mean()) for g in (corpus, ~corpus) if g.any()]
    return max(shares)


def compare(rows_all: torch.Tensor, table: torch.Tensor, answers: List[Answers],
            ledger: Ledger, snapshot, *, k: int, nprobe: int, storage: torch.dtype,
            failed_slots: int = 0, shortfall: int = 0) -> dict:
    """The compared numbers and recall@k of the judged rows.  ``rows_all``
    (N, d) f32: the row of every id; ``table`` (T, d) f32: the queries;
    ``snapshot``: the postings the judged searches saw, or None."""
    dev = rows_all.device
    wrong = failed_slots + shortfall + sum(_wrong_slots(a, ledger, k) for a in answers)
    live_np = ledger.live
    if snapshot is not None:
        members = np.zeros(len(ledger.born), bool)
        m = snapshot.member_ids
        members[m[(m >= 0) & (m < len(members))]] = True
        wrong += int((live_np & ~members).sum()) + int((~live_np & members).sum())
    copies = None
    if storage == torch.int8:
        if snapshot is None:
            storage = sq8.WIRE   # no postings: each row stored once, at the wire precision
        else:
            copies = _Copies(rows_all, snapshot)
    if copies is None:
        dist_err = _dist_err(rows_all, table, answers, ledger, storage)
    else:
        dist_err = _dist_err_copies(table, answers, ledger, copies)
    stray = _stray(rows_all, ledger, snapshot, nprobe)

    judged = [a for a in answers if a.judged and a.ids is not None]
    if not judged:
        return {"dist_err": dist_err, "wrong": wrong, "missed": float("inf"),
                "stray": stray, "recall_at_10": float("nan")}
    uq = np.unique(np.concatenate([a.rows for a in judged]))
    live = torch.from_numpy(live_np).to(dev)
    tq = table[torch.from_numpy(uq).to(dev)]
    cand = prefilter(rows_all, live, tq, 64)
    gt_ids, _ = exact_topk(rows_all, tq, k, live=live, cand=cand)
    if copies is None:
        J, e = exact_topk(rows_all, tq, k, live=live, cand=cand, round_rows=storage)
        reach = _reachable(table, snapshot, uq, J, nprobe, storage)
    else:
        J, e, reach = _nearest_copies(copies, tq, cand, live, nprobe, k)
    missed = considered = hits = total = 0
    for a in judged:
        m = min(len(a.rows), a.ids.shape[0])
        pos = torch.from_numpy(np.searchsorted(uq, a.rows[:m])).to(dev)
        ids = torch.from_numpy(np.asarray(a.ids[:m], np.int64)).to(dev)
        d = torch.from_numpy(np.asarray(a.dists[:m], np.float64)).to(dev)
        d10 = torch.where((ids >= 0).all(1), d.max(1).values, torch.full_like(d[:, 0], np.inf))
        jj, ee = J[pos], e[pos]
        must = reach[pos] & (ee < d10[:, None] * (1 - TOL_RANK))
        got = (jj[:, :, None] == ids[:, None, :]).any(-1)
        missed += int((must & ~got).sum())
        considered += int(must.sum())
        hits += int((gt_ids[pos][:, :, None] == ids[:, None, :]).any(-1).sum())
        total += m * k
    return {"dist_err": dist_err, "wrong": wrong, "missed": missed / max(1, considered),
            "stray": stray, "recall_at_10": hits / max(1, total)}
