"""Closure-replica top-k (counterpart of ``spfresh_tpu/ops/pallas/replica.py``,
``pallas_replica_topk``).

``replica_topk`` launches the CUDA kernel in ``csrc/replica.cu`` for CUDA
tensors and runs ``replica_topk_plain`` for CPU tensors; anything else
raises.  Nothing on the CUDA build path calls the plain version.
"""

from __future__ import annotations

import torch

from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops.distances import EUCLIDEAN, pairwise_distance
from spfresh_tpu_torch.ops.topk import smallest_k

MAX_EXTRA = 8  # the kernel's register lists hold at most 8 replicas
PLAIN_TILE_ELEMS = 1 << 28  # bound on each (t, C) workspace of the plain version

# Kernel launches since the last reset (set to 0 to reset).
launches = 0


def replica_topk_plain(X, base, cents, bt: float, n_extra: int, db=None,
                       soar_lambda: float = 0.0, metric: str = EUCLIDEAN):
    """Plain PyTorch version, the math of the reference's XLA closure pass
    (``_final_replica_pass``): (t, C) distance blocks by the matmul
    expansion, the closure mask, optional SOAR ranking and a tie-stable
    top-``n_extra``.  Row tiles bound the two (t, C) workspaces to
    ``PLAIN_TILE_ELEMS`` f32 values each.  ``metric`` serves the CPU build's L1/Linf closure pass; the
    kernel is Euclidean only.  Returns (idx (n, n_extra) int32, rank (n, n_extra) f32); a
    missing replica has rank +inf (its id is arbitrary)."""
    n = X.shape[0]
    C = cents.shape[0]
    row_tile = max(256, PLAIN_TILE_ELEMS // max(1, C))
    cols = torch.arange(C, device=X.device)
    out_i = torch.empty((n, n_extra), dtype=torch.int32, device=X.device)
    out_d = torch.empty((n, n_extra), dtype=torch.float32, device=X.device)
    for s in range(0, n, row_tile):
        e = min(n, s + row_tile)
        b = base[s:e].long()
        D = pairwise_distance(X[s:e], cents, metric)  # (t, C)
        dbt = D.gather(1, b[:, None])[:, 0] if db is None else db[s:e].to(torch.float32)
        CC = pairwise_distance(cents[b], cents, metric)  # (t, C)
        eligible = (D < (bt * dbt)[:, None]) & (CC >= D) & (cols[None, :] != b[:, None])
        if soar_lambda:
            rdot = 0.5 * (dbt[:, None] + D - CC)
            rank = D + soar_lambda * rdot * rdot / torch.clamp_min(dbt[:, None], 1e-30)
        else:
            rank = D
        vals, idx = smallest_k(torch.where(eligible, rank, torch.full_like(rank, float("inf"))),
                               n_extra)
        out_i[s:e] = idx.to(torch.int32)
        out_d[s:e] = vals
    return out_i, out_d


def _check(X, base, cents, n_extra: int, db) -> None:
    if X.ndim != 2 or cents.ndim != 2 or X.shape[1] != cents.shape[1]:
        raise ValueError(f"expected X (n, d) and cents (C, d); got {tuple(X.shape)}, "
                         f"{tuple(cents.shape)}")
    if X.dtype != cents.dtype or X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X and cents must share float32 or bfloat16; got {X.dtype}, {cents.dtype}")
    if base.shape != (X.shape[0],) or base.dtype != torch.int32:
        raise ValueError(f"base must be int32 of shape ({X.shape[0]},)")
    if db is not None and (db.shape != (X.shape[0],) or db.dtype != torch.float32):
        raise ValueError(f"db must be float32 of shape ({X.shape[0]},)")
    if not 1 <= n_extra <= cents.shape[0]:
        raise ValueError(f"n_extra={n_extra} outside [1, C={cents.shape[0]}]")
    if X.device.type == "cuda" and n_extra > MAX_EXTRA:
        raise ValueError(f"n_extra={n_extra} exceeds the kernel's {MAX_EXTRA}")
    devs = {X.device, base.device, cents.device} | ({db.device} if db is not None else set())
    if len(devs) != 1:
        raise ValueError("X, base, cents and db must be on one device")


def replica_topk(X: torch.Tensor, base: torch.Tensor, cents: torch.Tensor, bt: float,
                 n_extra: int, db: torch.Tensor | None = None, soar_lambda: float = 0.0):
    """Top-``n_extra`` closure replicas per point (squared L2).

    Admits centroid j for point p (base b) when D < bt*db, CC >= D and
    j != b; ranks by D or, with ``soar_lambda`` > 0, by the SOAR score.
    ``db`` supplies dist(p, c_b); None computes it with the same expansion.
    Returns (idx (n, n_extra) int32, rank (n, n_extra) f32), ascending, ties
    to the lower centroid id; missing replicas have rank +inf."""
    global launches
    _check(X, base, cents, n_extra, db)
    if X.device.type == "cpu":
        return replica_topk_plain(X, base, cents, bt, n_extra, db=db, soar_lambda=soar_lambda)
    if X.device.type != "cuda":
        raise ValueError(f"no replica kernel for device {X.device}")
    for name, t in (("X", X), ("base", base), ("cents", cents), ("db", db)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = X.shape
    C = cents.shape[0]
    if max(n * d, C * d) >= 2**31:
        raise ValueError("X or cents exceed 2^31 elements")
    # The kernel gathers base-centroid rows by these ids: check the range
    # (one device sync per call; the build makes one call).
    if n and (int(base.min()) < 0 or int(base.max()) >= C):
        raise ValueError(f"base ids must lie in [0, {C})")
    dev = X.device
    idx = torch.empty((n, n_extra), dtype=torch.int32, device=dev)
    rank = torch.empty((n, n_extra), dtype=torch.float32, device=dev)
    x2 = torch.empty((n,), dtype=torch.float32, device=dev)
    cn2 = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = _build.library()
    rc = lib.spf_replica_topk(
        X.data_ptr(), base.data_ptr(), cents.data_ptr(),
        db.data_ptr() if db is not None else None,
        x2.data_ptr(), cn2.data_ptr(), idx.data_ptr(), rank.data_ptr(),
        n, C, d, n_extra, float(bt), float(soar_lambda or 0.0),
        int(X.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "replica")
    launches += 1
    return idx, rank
