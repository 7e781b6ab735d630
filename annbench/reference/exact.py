"""The plain reference: exact nearest neighbours under squared L2.

Plain PyTorch, independent of the system under test: it imports nothing of
it and reads none of its state.  It takes the rows and queries the benchmark
made and answers from them alone.

``exact_topk`` ranks in float64 after an f32 prefilter (TF32 off), so its
answers are exact wherever the k-th and the prefilter's ``candidates``-th
neighbour are apart by more than the f32 scan's rounding (about 1e-6 of a
distance of ~100 on these corpora; the gap is ~15%).  ``lowp_topk`` is the
same search computed on rows and queries rounded to a lower precision: it
stands in the system's place as the control that the comparison must fail.
"""

from __future__ import annotations

import torch

ROW_CHUNK = 262_144   # corpus rows a step of the prefilter scans
QUERY_BLOCK = 1024    # queries a step of the prefilter takes
ROW_BLOCK = 8192      # rows a step of the centroid scan takes


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32 (None: unchanged)."""
    return x if dtype is None else x.to(dtype).to(torch.float32)


def sq_l2_f64(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row-aligned squared L2 in float64: queries (..., d), rows (..., d)."""
    diff = queries.to(torch.float64) - rows.to(torch.float64)
    return (diff * diff).sum(-1)


def prefilter(rows, live, queries, candidates: int):
    """Top-``candidates`` rows of each query by an f32 expansion scan over
    chunks of the corpus: (Q, candidates) row indices."""
    _no_tf32()
    dev = rows.device
    Q = queries.shape[0]
    n = rows.shape[0]
    c = min(candidates, n)
    out = torch.empty((Q, c), dtype=torch.int64, device=dev)
    for qs in range(0, Q, QUERY_BLOCK):
        q = queries[qs : qs + QUERY_BLOCK].to(torch.float32)
        q2 = (q * q).sum(-1, keepdim=True)
        best_d = torch.full((q.shape[0], 0), float("inf"), device=dev)
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=dev)
        for rs in range(0, n, ROW_CHUNK):
            r = rows[rs : rs + ROW_CHUNK].to(torch.float32)
            d = q2 + (r * r).sum(-1)[None, :] - 2.0 * (q @ r.T)
            if live is not None:
                d = d.masked_fill(~live[rs : rs + ROW_CHUNK][None, :], float("inf"))
            idx = torch.arange(rs, rs + r.shape[0], device=dev).expand(q.shape[0], -1)
            cat_d = torch.cat([best_d, d], 1)
            cat_i = torch.cat([best_i, idx], 1)
            best_d, sel = torch.topk(cat_d, min(c, cat_d.shape[1]), dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, sel)
        out[qs : qs + QUERY_BLOCK] = best_i
    return out


def exact_topk(rows: torch.Tensor, queries: torch.Tensor, k: int, *, live=None,
               round_rows: torch.dtype | None = None, candidates: int = 64, cand=None):
    """The k nearest live rows of each query: (ids (Q, k) int64, squared
    distances (Q, k) f64), ascending, ties to the lower row.

    ``rows`` (N, d) f32 and ``queries`` (Q, d) f32 on one device; ``live``
    (N,) bool or None; ``round_rows``: the rows are ranked as stored in
    that dtype (the queries stay f32), as a store of that width holds them.
    Rows that are not live have +inf distance and come last.  ``cand``:
    the ``prefilter`` of these rows and queries, where it is already made."""
    if cand is None:
        cand = prefilter(rows, live, queries, candidates)
    rr = round_to(rows[cand], round_rows)                 # (Q, c, d)
    d64 = sq_l2_f64(queries[:, None, :], rr)
    if live is not None:
        d64 = d64.masked_fill(~live[cand], float("inf"))
    # Stable ascending sort by (distance, row): rows break ties low.
    order = torch.argsort(cand, dim=1)
    cand, d64 = torch.gather(cand, 1, order), torch.gather(d64, 1, order)
    srt = torch.argsort(d64, dim=1, stable=True)[:, :k]
    return torch.gather(cand, 1, srt), torch.gather(d64, 1, srt)


def lowp_topk(rows: torch.Tensor, queries: torch.Tensor, k: int, *, live=None,
              dtype: torch.dtype = torch.float8_e4m3fn):
    """The exact search computed in a lower precision: rows and queries
    rounded to ``dtype``, products accumulated in f32 (as a tensor core of
    that type would).  Returns (ids (Q, k) int64, distances (Q, k) f32)."""
    _no_tf32()
    dev = rows.device
    out_i, out_d = [], []
    for qs in range(0, queries.shape[0], QUERY_BLOCK):
        q = round_to(queries[qs : qs + QUERY_BLOCK], dtype)
        q2 = (q * q).sum(-1, keepdim=True)
        best_d = torch.full((q.shape[0], 0), float("inf"), device=dev)
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=dev)
        for rs in range(0, rows.shape[0], ROW_CHUNK):
            r = round_to(rows[rs : rs + ROW_CHUNK], dtype)
            d = (q2 + (r * r).sum(-1)[None, :] - 2.0 * (q @ r.T)).clamp_min(0.0)
            if live is not None:
                d = d.masked_fill(~live[rs : rs + ROW_CHUNK][None, :], float("inf"))
            idx = torch.arange(rs, rs + r.shape[0], device=dev).expand(q.shape[0], -1)
            cat_d, cat_i = torch.cat([best_d, d], 1), torch.cat([best_i, idx], 1)
            best_d, sel = torch.topk(cat_d, min(k, cat_d.shape[1]), dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, sel)
        out_i.append(best_i)
        out_d.append(best_d)
    return torch.cat(out_i), torch.cat(out_d)


def nearest_centroids(rows: torch.Tensor, centroids: torch.Tensor, r: int) -> torch.Tensor:
    """(N, r) indices of each row's ``r`` nearest centroids by squared L2 in
    float64, nearest first."""
    c = centroids.to(torch.float64)
    c2 = (c * c).sum(1)
    r = min(r, c.shape[0])
    out = [torch.zeros((0, r), dtype=torch.int64, device=rows.device)]
    for s in range(0, rows.shape[0], ROW_BLOCK):
        x = rows[s : s + ROW_BLOCK].to(torch.float64)
        d = (x * x).sum(1, keepdim=True) + c2[None, :] - 2.0 * (x @ c.T)
        out.append(torch.topk(d, r, dim=1, largest=False).indices)
    return torch.cat(out)
