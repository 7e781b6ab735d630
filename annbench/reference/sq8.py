"""The plain reference of residual int8 storage (IVF-SQ8): each stored copy
of a row worked out again from the rows, the postings' membership and their
centroids, and the squared L2 from a query to it.

A row ``x`` held in posting ``p`` is stored as ``c_p + code * s_p``:

* ``x`` is first taken at the build's wire precision (``WIRE``, bfloat16,
  round half to even), as the build's postings hold it;
* ``s_p = f32(max |x - c_p|) * f32(1/127)`` over the posting's members and
  coordinates, 1.0 where that maximum is 0 (an empty or all-zero posting);
* ``code = clamp(rint((x - c_p) * f32(1 / s_p)), -127, 127)``, ties to even;

each step one f32 operation, as a store of this kind computes it.  So a row
held in two postings has two stored values.  Distances are f64, in blocks,
so that the f64 copies of millions of stored rows never exist whole.

Plain PyTorch, independent of the system under test: it imports nothing of
it and takes none of its scales or codes.  TF32 is off.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact import _no_tf32

WIRE = torch.bfloat16   # the rows' precision before quantizing
COPY_BLOCK = 1 << 18    # copies a step works on


def _residuals(rows: torch.Tensor, centroids: torch.Tensor, ids: torch.Tensor,
               posts: torch.Tensor) -> torch.Tensor:
    """(m, d) f32: each copy's row at the wire precision less its posting's
    centroid."""
    return rows[ids].to(WIRE).to(torch.float32) - centroids[posts]


def posting_scales(rows: torch.Tensor, centroids: torch.Tensor, ids: torch.Tensor,
                   posts: torch.Tensor) -> torch.Tensor:
    """(C,) f32 scale of each posting from its members: ``rows`` (N, d) f32
    raw, ``centroids`` (C, d) f32, ``ids``/``posts`` (m,) int64 the
    (member row, posting) pairs."""
    _no_tf32()
    rowmax = torch.zeros(centroids.shape[0], dtype=torch.float32, device=centroids.device)
    for s in range(0, ids.shape[0], COPY_BLOCK):
        r = _residuals(rows, centroids, ids[s:s + COPY_BLOCK], posts[s:s + COPY_BLOCK])
        rowmax.scatter_reduce_(0, posts[s:s + COPY_BLOCK], r.abs().amax(dim=1), "amax")
    inv127 = torch.tensor(np.float32(1.0 / 127.0), device=rowmax.device)
    return torch.where(rowmax > 0, rowmax * inv127, torch.ones_like(rowmax))


def codes(rows: torch.Tensor, centroids: torch.Tensor, scales: torch.Tensor, ids: torch.Tensor,
          posts: torch.Tensor) -> torch.Tensor:
    """(m, d) int8 codes of the (row, posting) copies."""
    inv = torch.reciprocal(scales)[posts]
    q = torch.round(_residuals(rows, centroids, ids, posts) * inv[:, None])
    return q.clamp_(-127, 127).to(torch.int8)


def stored(rows: torch.Tensor, centroids: torch.Tensor, scales: torch.Tensor,
           ids: torch.Tensor, posts: torch.Tensor) -> torch.Tensor:
    """(m, d) f64 stored value ``c_p + code * s_p`` of each copy."""
    c = codes(rows, centroids, scales, ids, posts).to(torch.float64)
    return centroids[posts].to(torch.float64) + c * scales[posts].to(torch.float64)[:, None]


def copy_distances(queries: torch.Tensor, qidx: torch.Tensor, rows: torch.Tensor,
                   centroids: torch.Tensor, scales: torch.Tensor, ids: torch.Tensor,
                   posts: torch.Tensor) -> torch.Tensor:
    """(m,) f64 squared L2 from query ``queries[qidx[i]]`` (f32) to the
    stored copy of row ``ids[i]`` in posting ``posts[i]``."""
    out = torch.empty(ids.shape[0], dtype=torch.float64, device=ids.device)
    for s in range(0, ids.shape[0], COPY_BLOCK):
        e = s + COPY_BLOCK
        diff = (queries[qidx[s:e]].to(torch.float64)
                - stored(rows, centroids, scales, ids[s:e], posts[s:e]))
        out[s:e] = (diff * diff).sum(-1)
    return out
