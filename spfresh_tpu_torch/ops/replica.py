"""Closure-replica top-k and nearest centroid (counterparts of
``spfresh_tpu/ops/pallas/replica.py``: ``pallas_replica_topk`` and
``pallas_nearest_centroid``).

``replica_topk`` and ``nearest_centroid`` launch their CUDA kernels in
``csrc/replica.cu`` for CUDA tensors and run ``replica_topk_plain`` and
``nearest_centroid_plain`` for CPU tensors; anything else raises.  Nothing
on a CUDA build path calls a plain version.  bf16 inputs take the
tensor-core kernels: the wrapper zero-pads d to a multiple of 16
(``pad_depth``; zero columns change no dot product) and, for the replica,
gathers the base centroids ``cents[base]`` into a contiguous (n, d) tensor
that the kernel reads like X.  f32 inputs take the CUDA-core kernels.

``replica_topk_elementwise`` is the unfused closure pass of the JAX
package (``_replica_pass_xla`` with ``_replica_select_from_dists``) and
``chunked_nearest_centroid`` its chunked running argmin
(``_oc_base_tile``): the routes of Manhattan and Chebyshev builds, whose
distance blocks come from ``pairwise_distance`` (the L1/Linf kernel on
CUDA), and, for the closure pass, of ``n_extra`` past the kernel's 8.
The plain versions are their squared-L2 cases.
"""

from __future__ import annotations

import torch

from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops.distances import EUCLIDEAN, pairwise_distance
from spfresh_tpu_torch.ops.topk import smallest_k

MAX_EXTRA = 8  # the kernel's register lists hold at most 8 replicas
DEPTH_MULTIPLE = 16  # bf16 kernels: d in whole wgmma k-steps (16 bf16 values)
# Bound on each (t, C) f32 workspace of the unfused closure pass: the JAX
# package's ~1 GB rule, tile = 2^28 // C rows (hierarchical.py:1016,1032).
PLAIN_TILE_ELEMS = 1 << 28
# Centroid rows per step of the chunked running argmin: the JAX package's
# _CENT_CHUNK, cut so a (rows, chunk) block holds at most ENTRY_BUDGET
# values (its _ENTRY_BUDGET rule), but never below MIN_CENT_CHUNK columns.
CENT_CHUNK = 8192
ENTRY_BUDGET = 1 << 27
MIN_CENT_CHUNK = 512

# Kernel launches since the last reset (set to 0 to reset): the replica
# kernel and the nearest-centroid kernel.
launches = 0
nearest_launches = 0


def replica_topk_elementwise(X, base, cents, bt: float, n_extra: int, metric: str = EUCLIDEAN,
                             db=None, soar_lambda: float = 0.0):
    """The unfused closure pass: per row group, ``D = pairwise_distance(X_g,
    cents)`` and ``CC = pairwise_distance(cents[base_g], cents)``, then the
    closure mask, optional SOAR ranking and a tie-stable top-``n_extra`` in
    torch.  Row groups bound the two (t, C) workspaces to
    ``PLAIN_TILE_ELEMS`` f32 values each.  ``db`` supplies dist(p, c_base);
    None takes it from D.  Returns (idx (n, n_extra) int32, rank
    (n, n_extra) f32); a missing replica has rank +inf (its id is
    arbitrary)."""
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


def replica_topk_plain(X, base, cents, bt: float, n_extra: int, db=None,
                       soar_lambda: float = 0.0):
    """Plain PyTorch version of the kernel, the math of the reference's XLA
    closure pass (``_final_replica_pass``): the unfused pass with distance
    blocks by the squared-L2 matmul expansion."""
    return replica_topk_elementwise(X, base, cents, bt, n_extra, EUCLIDEAN, db=db,
                                    soar_lambda=soar_lambda)


def pad_depth(t: torch.Tensor, multiple: int = DEPTH_MULTIPLE) -> torch.Tensor:
    """``t`` (rows, d) with zero columns appended up to a multiple of
    ``multiple``; ``t`` itself when d already is one.  Zero columns change
    no squared norm and no dot product."""
    extra = -t.shape[1] % multiple
    return torch.nn.functional.pad(t, (0, extra)) if extra else t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it, whose data starts on a 16-byte boundary (TMA
    reads whole 16-byte units)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    n = X.shape[0]
    C = cents.shape[0]
    # The kernel gathers base-centroid rows by these ids: check the range
    # (one device sync per call; the build makes one call).
    if n and (int(base.min()) < 0 or int(base.max()) >= C):
        raise ValueError(f"base ids must lie in [0, {C})")
    dev = X.device
    bf16 = X.dtype == torch.bfloat16
    if bf16:
        X, cents = _aligned(pad_depth(X)), _aligned(pad_depth(cents))
    d = X.shape[1]
    if max(n * d, C * d) >= 2**31:  # after padding: the kernels index the padded rows
        raise ValueError("X or cents exceed 2^31 elements")
    # Read like X by the kernel.
    Cb = cents.index_select(0, base.long()) if bf16 else None
    idx = torch.empty((n, n_extra), dtype=torch.int32, device=dev)
    rank = torch.empty((n, n_extra), dtype=torch.float32, device=dev)
    x2 = torch.empty((n,), dtype=torch.float32, device=dev)
    cn2 = torch.empty((C,), dtype=torch.float32, device=dev)
    db_buf = db if db is not None else torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the library launches on the current device
        rc = _build.library().spf_replica_topk(
            X.data_ptr(), base.data_ptr(), cents.data_ptr(),
            Cb.data_ptr() if Cb is not None else None,
            db_buf.data_ptr(), int(db is not None),
            x2.data_ptr(), cn2.data_ptr(), idx.data_ptr(), rank.data_ptr(),
            n, C, d, n_extra, float(bt), float(soar_lambda or 0.0), int(bf16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "replica")
    launches += 1
    return idx, rank


def chunked_nearest_centroid(X, cents, metric: str = EUCLIDEAN):
    """The chunked running argmin of the JAX package's ``_oc_base_tile``:
    (t, chunk) distance blocks by ``pairwise_distance``, a strict-< update
    in ascending chunk order, so equal distances go to the lowest centroid
    id.  The out-of-core base pass of Manhattan and Chebyshev (their blocks
    take the L1/Linf kernel on CUDA).  Returns (base (n,) int32, db (n,)
    f32)."""
    n = X.shape[0]
    chunk = max(MIN_CENT_CHUNK, min(CENT_CHUNK, ENTRY_BUDGET // max(1, n)))
    best_d = torch.full((n,), float("inf"), dtype=torch.float32, device=X.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=X.device)
    for start in range(0, cents.shape[0], chunk):
        D = pairwise_distance(X, cents[start : start + chunk], metric)
        cmin, carg = torch.min(D, dim=1)  # the first minimum of each row
        upd = cmin < best_d
        best_d = torch.where(upd, cmin, best_d)
        best_i = torch.where(upd, (carg + start).to(torch.int32), best_i)
    return best_i, best_d


def nearest_centroid_plain(X, cents):
    """Plain PyTorch version of the nearest-centroid kernel: the chunked
    running argmin with squared-L2 expansion blocks."""
    return chunked_nearest_centroid(X, cents, EUCLIDEAN)


def nearest_centroid(X: torch.Tensor, cents: torch.Tensor):
    """Nearest centroid per row under squared L2: (base (n,) int32, db (n,)
    f32), D = max(|c|^2 + |x|^2 - 2 x.c, 0) in f32, equal D to the lowest
    centroid id.  ``X`` and ``cents`` share float32 or bfloat16."""
    global nearest_launches
    if X.ndim != 2 or cents.ndim != 2 or X.shape[1] != cents.shape[1]:
        raise ValueError(f"expected X (n, d) and cents (C, d); got {tuple(X.shape)}, "
                         f"{tuple(cents.shape)}")
    if X.dtype != cents.dtype or X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X and cents must share float32 or bfloat16; got {X.dtype}, "
                        f"{cents.dtype}")
    if cents.shape[0] == 0:
        raise ValueError("no centroids")
    if X.device != cents.device:
        raise ValueError("X and cents must be on one device")
    if X.device.type == "cpu":
        return nearest_centroid_plain(X, cents)
    if X.device.type != "cuda":
        raise ValueError(f"no nearest-centroid kernel for device {X.device}")
    X, cents = X.contiguous(), cents.contiguous()
    bf16 = X.dtype == torch.bfloat16
    if bf16:
        X, cents = _aligned(pad_depth(X)), _aligned(pad_depth(cents))
    n, d = X.shape
    C = cents.shape[0]
    if max(n * d, C * d) >= 2**31:
        raise ValueError("X or cents exceed 2^31 elements")
    dev = X.device
    base = torch.empty((n,), dtype=torch.int32, device=dev)
    db = torch.empty((n,), dtype=torch.float32, device=dev)
    x2 = torch.empty((n,), dtype=torch.float32, device=dev)
    cn2 = torch.empty((C,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the library launches on the current device
        rc = _build.library().spf_nearest_centroid(
            X.data_ptr(), cents.data_ptr(), x2.data_ptr(), cn2.data_ptr(),
            base.data_ptr(), db.data_ptr(), n, C, d, int(bf16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "nearest centroid")
    nearest_launches += 1
    return base, db
