"""SPANN index (counterpart of ``spfresh_tpu/index/spann.py``).

Canonical posting state lives in host dicts (cluster id -> (ids, vectors),
cluster id -> centroid), exactly as in the JAX package, so ``save``/``load``
are format-compatible with it.  Search runs the padded pipeline of the
reference's ``_search_kernel_padded`` on the index's ``device``:

1. stage 1: centroid scan + tie-stable top-nprobe (``centroid_topk``: a
   dense scan, or past 32,768 centroids the windowed scan kernel or the
   chunked scan);
2. slab rerank of the probed postings (``ops.rerank``: the CUDA kernel on a
   CUDA device, its plain version on the CPU; int8 slabs take its quantized
   path with centered queries and per-posting scales);
3. masking, optional reference-style pruning, and the bounded-dedup global
   top-k (``smallest_k_unique``).

Every posting list is one contiguous (pad, d_pad) slab of a
(Cpad, pad, d_pad) device array (``padded_view``), packed on the device
straight from the build corpus when the index was just built.  int8
storage (IVF-SQ8) packs residual codes ``round((x - c) / s_c)`` with one
scale per posting, bit-identical to the JAX package's pack, and keeps the
centroids in f32.

Live updates (``add_cluster``, ``remove_cluster``, ``replace_posting``)
mark postings dirty; the next ``padded_view()`` writes only those into the
view's tensors in place (``_apply_padded_updates``): appended member rows
alone when a posting only grew, else the posting's whole slab.  A full
repack happens only after a bulk load, or when a posting outgrows its slab
or no free slab row is left.

Not ported: the CSR ``DeviceView`` and its XLA engine (no port path reads
it).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from spfresh_tpu_torch.core.dtypes import DtypePolicy, posting_scales_np, quant_scale_for, quantize_np
from spfresh_tpu_torch.index.config import Config
from spfresh_tpu_torch.index.posting_store import (
    FileBasedPostingListStore,
    PointData,
    read_packed_postings,
    write_packed_postings_streaming,
)
from spfresh_tpu_torch.ops.distances import canonical_metric, pairwise_distance, rowwise_distance
from spfresh_tpu_torch.ops.rerank import padded_rerank_distances
from spfresh_tpu_torch.ops.topk import centroid_topk, smallest_k, smallest_k_unique
from spfresh_tpu_torch.utils import metrics
from spfresh_tpu_torch.utils.profiling import span

MANIFEST = "manifest.json"
CENTROIDS_FILE = "centroids.npy.gz"
PACKED_FILE = "postings.csr"
_F32_EPS = float(np.finfo(np.float32).eps)
_PACK_CHUNK = 1 << 18  # member rows per slab-pack step (bounds the gather)
# Bound on one query batch's candidate block in a search: past it the probe
# axis is taken in chunks (``_search_padded``), as in the reference (~1 GB).
PROBE_CHUNK_BYTES = 1 << 30
# Bytes a candidate holds in the block: its f32 distance, int32 id and the
# int64 key of the tie-stable selection.  The budget counts only these; the
# peak runs higher, with the masks of ``_probe_block`` and the fold's copies
# and key intermediates alive at once (``chip_smoke.py`` logs the peak of
# the full-probe search per candidate of a chunk).
_CAND_BYTES = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _ids_i32(a: np.ndarray) -> np.ndarray:
    """Device views carry point ids as int32; ids must fit."""
    if a.size and (int(a.max()) >= np.iinfo(np.int32).max or int(a.min()) < -1):
        raise ValueError(
            "point ids must fit in int32 for the device view "
            f"(got max {int(a.max())}, min {int(a.min())}); re-map ids"
        )
    return a.astype(np.int32)


def _max_multiplicity(all_ids: np.ndarray) -> int:
    """Largest number of postings any single point id appears in."""
    if all_ids.size == 0:
        return 1
    _, counts = np.unique(all_ids, return_counts=True)
    return int(counts.max())


# ---------------------------------------------------------------------------
# Search pipeline
# ---------------------------------------------------------------------------


def _probe_block(queries, view: "PaddedView", rows, cent_d, metric: str, thr):
    """Distances and ids (Q, n, pad) of the candidates of the probed slabs
    ``rows`` (Q, n): the slab rerank (int8 slabs: the centered queries
    q - c_row and the probed postings' scales), +inf (and id -1) past a
    posting's length or for an invalid probe, +inf past the pruning
    threshold ``thr`` (Q,) when it is given."""
    rows32 = rows.to(torch.int32).contiguous()
    if view.vectors3d.dtype == torch.int8:
        qc = queries[:, None, :] - view.centroids[rows]  # (Q, n, d_pad) f32
        d = padded_rerank_distances(queries, rows32, view.vectors3d, metric,
                                    scales=view.scales[rows], centered_queries=qc)
    else:
        d = padded_rerank_distances(queries, rows32, view.vectors3d, metric)
    ar = torch.arange(view.pad, device=queries.device)
    invalid = (ar >= view.lens[rows][..., None]) | ~torch.isfinite(cent_d)[..., None]
    cand_ids = view.ids2d[rows].masked_fill_(invalid, -1)
    d.masked_fill_(invalid, float("inf"))
    if thr is not None:
        d.masked_fill_(~(d <= thr[:, None, None]), float("inf"))
    return d, cand_ids


def _prune_threshold(nearest, prune_factor: Optional[float]):
    """Reference-style query-aware pruning: keep the candidates within
    ``prune_factor * (nearest-centroid distance + eps)``, per query
    (``nearest`` (Q,)); None without pruning."""
    if prune_factor is None:
        return None
    return float(np.float32(prune_factor)) * (nearest + _F32_EPS)


def _probe_candidates(queries, view: "PaddedView", rows, cent_d, *, k: int, metric: str, thr):
    """Distances and ids (Q, n) of the candidates of the probed slabs
    ``rows`` (Q, nprobe) (``_probe_block``), in probe-major order.

    When the candidate block of all nprobe probes would pass
    ``PROBE_CHUNK_BYTES``, the probes are taken ``probe_chunk`` at a time
    and each chunk is folded into a running tie-stable top-kk per query,
    kk = max(k, min(k * max_dup, nprobe * pad)), as the reference's
    ``_search_kernel_probe_chunked`` does.  The kept candidates precede
    the chunk's and hold the lowest columns among equal values, so the
    running set is the unchunked block's top-kk in its order, and a dedup
    top-k of it (the k-th distinct id lies within rank k * max_dup)
    returns the same ids as of the whole block.  Counts the chunks taken
    in ``search.probe_chunks`` (1 for the whole block)."""
    Q, nprobe = rows.shape
    pad = view.pad
    per_probe = Q * (pad * _CAND_BYTES
                     + (view.d_pad * 4 if view.vectors3d.dtype == torch.int8 else 0))
    probe_chunk = max(1, PROBE_CHUNK_BYTES // max(1, per_probe))
    metrics.inc("search.probe_chunks", -(-nprobe // probe_chunk))
    if probe_chunk >= nprobe:
        d, cand_ids = _probe_block(queries, view, rows, cent_d, metric, thr)
        return d.reshape(Q, nprobe * pad), cand_ids.reshape(Q, nprobe * pad)
    kk = max(k, min(k * view.max_dup, nprobe * pad))
    d = torch.full((Q, kk), float("inf"), device=queries.device)
    cand_ids = torch.full((Q, kk), -1, dtype=view.ids2d.dtype, device=queries.device)
    for s in range(0, nprobe, probe_chunk):
        cd, ci = _probe_block(queries, view, rows[:, s : s + probe_chunk],
                              cent_d[:, s : s + probe_chunk], metric, thr)
        d, idx = smallest_k(torch.cat([d, cd.reshape(Q, -1)], dim=1), kk)
        cand_ids = torch.gather(torch.cat([cand_ids, ci.reshape(Q, -1)], dim=1), 1, idx)
    return d, cand_ids


def _search_padded(queries, view: "PaddedView", *, k: int, nprobe: int, metric: str,
                   prune_factor: Optional[float]):
    """probe -> slab rerank -> masked dedup top-k for one query batch.

    queries (Q, d_pad) f32 on the view's device.  Stage 1 rounds the queries
    to the centroid dtype, as the reference does; the rerank uses the f32
    queries.  Past ``PROBE_CHUNK_BYTES`` the probes are taken in chunks
    (``_probe_candidates``); pruning keeps the first probe's threshold.
    Returns (ids (Q, k) int32 [-1 = no hit], dists (Q, k) f32)."""
    qf = queries.to(view.centroids.dtype)
    cent_d, rows = centroid_topk(qf, view.centroids, view.cent_valid, nprobe, metric)
    thr = _prune_threshold(cent_d[:, 0], prune_factor)
    d, cand_ids = _probe_candidates(queries, view, rows, cent_d, k=k, metric=metric, thr=thr)
    vals, out_ids = smallest_k_unique(d, cand_ids, k, max_dup=view.max_dup)
    out_ids = torch.where(torch.isfinite(vals), out_ids, torch.full_like(out_ids, -1))
    return out_ids, vals


def _brute_force_exact(corpus, queries, k: int, metric: str):
    D = pairwise_distance(queries.to(corpus.dtype), corpus, metric, exact=True)
    return smallest_k(D, k)


def _brute_force_2stage(corpus, queries, k: int, kc: int, metric: str, chunk: int):
    """Large-corpus exact top-k: the fast expansion scan keeps a running
    top-kc over ``chunk``-row corpus blocks, then the elementwise-exact form
    reranks the kc candidates.  Exact as long as the true top-k survive the
    ~1e-3-relative-error prefilter into the top-kc (kc >> k)."""
    n = corpus.shape[0]
    Q = queries.shape[0]
    dev = corpus.device
    qf = queries.to(corpus.dtype)
    best_d = torch.full((Q, kc), float("inf"), device=dev)
    best_i = torch.zeros((Q, kc), dtype=torch.int64, device=dev)
    for start in range(0, n, chunk):
        block = corpus[start : start + chunk]
        D = pairwise_distance(qf, block, metric)  # (Q, chunk)
        col = start + torch.arange(block.shape[0], device=dev)
        cat_d = torch.cat([best_d, D], dim=1)
        cat_i = torch.cat([best_i, col.expand(Q, -1)], dim=1)
        best_d, idx = smallest_k(cat_d, kc)
        best_i = torch.gather(cat_i, 1, idx)
    d_exact = rowwise_distance(corpus[best_i], qf[:, None, :], metric)  # (Q, kc)
    vals, idx = smallest_k(d_exact, k)
    return vals, torch.gather(best_i, 1, idx)


def brute_force_search(corpus, queries, k: int, metric: str = "Euclidean",
                       batch_size: int = 1024, device: torch.device | str = DEFAULT_DEVICE):
    """Exact top-k ground truth on ``device``: (dists (Q, k), ids (Q, k)).

    Up to 10k corpus rows the fully elementwise exact form is used; past
    that a two-stage scan (expansion prefilter to max(32k, 256) candidates
    for Euclidean, then the exact rerank) keeps intermediates bounded."""
    metric = canonical_metric(metric)
    device = resolve_device(device)
    corpus = torch.as_tensor(np.asarray(corpus, np.float32)).to(device)
    queries = np.ascontiguousarray(queries, np.float32)
    n = corpus.shape[0]
    k = min(int(k), n)
    big = n > 10_000
    if metric == "Euclidean":
        kc, chunk = min(max(32 * k, 256), n), 65536
    else:
        kc, chunk = k, 8192
    out_d, out_i = [], []
    for s in range(0, queries.shape[0], batch_size):
        qb = torch.from_numpy(queries[s : s + batch_size]).to(device)
        if big:
            d, i = _brute_force_2stage(corpus, qb, k, kc, metric, chunk)
        else:
            d, i = _brute_force_exact(corpus, qb, k, metric)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d).cpu().numpy(), torch.cat(out_i).cpu().numpy()


def _pack_slabs(vec_source, flat_ids: np.ndarray, slots: np.ndarray, Cpad: int, pad: int,
                d: int, d_pad: int, sd: torch.dtype, device: torch.device, cent=None):
    """Scatter the P member rows into a zeroed (Cpad * pad, d_pad) slab
    array in ``_PACK_CHUNK`` steps, casting to the storage dtype on the
    device.  ``vec_source(s, e)`` returns rows s..e as an f32 device tensor
    (a gather from the device corpus, or an upload of host rows), so peak
    memory is the slabs plus one chunk.

    int8 (``cent`` (Cpad, d) f32 on the device) stores residual codes in
    two passes over the chunks, with the JAX package's f32 expressions:
    exact per-posting abs-maxima of ``x - c_row``, the scale
    ``rowmax * f32(1/127)`` (1.0 for an all-zero posting), then
    ``clamp(round((x - c_row) * (1 / scale)), -127, 127)`` with round half
    to even.  Each step is its own rounded op, so no FMA contracts them.
    Returns (slabs, ids2d, scales (Cpad,) f32; all ones for float
    storage)."""
    P = slots.shape[0]
    v = torch.zeros((Cpad * pad, d_pad), dtype=sd, device=device)
    slots_dev = torch.from_numpy(slots.astype(np.int64)).to(device)
    scales = torch.ones(Cpad, dtype=torch.float32, device=device)
    if sd == torch.int8:
        seg = slots_dev // pad  # slab row of each member

        def residual(s, e):
            return vec_source(s, e) - cent[seg[s:e]]

        rowmax = torch.zeros(Cpad, dtype=torch.float32, device=device)
        for s in range(0, P, _PACK_CHUNK):
            e = min(P, s + _PACK_CHUNK)
            rowmax.scatter_reduce_(0, seg[s:e], residual(s, e).abs().amax(dim=1), "amax")
        inv127 = torch.tensor(np.float32(1.0 / 127.0), device=device)
        scales = torch.where(rowmax > 0, rowmax * inv127, torch.ones_like(rowmax))
        inv = torch.reciprocal(scales)
        for s in range(0, P, _PACK_CHUNK):
            e = min(P, s + _PACK_CHUNK)
            codes = torch.round(residual(s, e) * inv[seg[s:e]][:, None]).clamp_(-127, 127)
            v[slots_dev[s:e], :d] = codes.to(torch.int8)
    else:
        for s in range(0, P, _PACK_CHUNK):
            e = min(P, s + _PACK_CHUNK)
            v[slots_dev[s:e], :d] = vec_source(s, e).to(sd)
    ids = torch.full((Cpad * pad,), -1, dtype=torch.int32, device=device)
    ids[slots_dev] = torch.from_numpy(flat_ids).to(device)
    return v.reshape(Cpad, pad, d_pad), ids.reshape(Cpad, pad), scales


_UPDATE_ROWS = 1024  # slabs per in-place rewrite step (bounds the host block)


def _cast_storage_np(x, sd: torch.dtype, scale) -> torch.Tensor:
    """Host f32 rows in the storage dtype, as a CPU tensor: int8 quantizes
    with ``scale`` (a scalar or per-row array, ``quantize_np``); bf16 rounds
    half to even (a torch cast, as ``ml_dtypes`` does for the JAX
    package)."""
    if sd == torch.int8:
        return torch.from_numpy(quantize_np(x, scale))
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(sd)


@dataclasses.dataclass
class PaddedView:
    """Slab layout: every posting list is one contiguous (pad, d_pad) block
    of a (Cpad, pad, d_pad) device array; d is zero-padded to a multiple of
    128 (zeros cancel in every metric because queries are padded alike).

    The view is updated in place: ``free_rows`` are the unoccupied slab
    rows (Cpad headroom) that postings created by live updates take, and a
    mutated posting is written into its own row."""

    centroids: torch.Tensor  # (Cpad, d_pad) storage dtype (f32 for int8 slabs)
    cent_valid: torch.Tensor  # (Cpad,) bool
    lens: torch.Tensor  # (Cpad,) int32
    ids2d: torch.Tensor  # (Cpad, pad) int32 (-1 = padding)
    vectors3d: torch.Tensor  # (Cpad, pad, d_pad) storage dtype
    scales: torch.Tensor  # (Cpad,) f32 per-posting dequant scales (1.0 = none)
    pad: int
    d_pad: int
    cluster_rows: Dict[int, int] = dataclasses.field(default_factory=dict)
    max_dup: int = 8
    free_rows: List[int] = dataclasses.field(default_factory=list)
    # cid -> the ids its slab held at the last refresh: the next refresh
    # recognizes a pure append and writes only the appended rows.
    snapshot: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # Host copy of ``scales`` for the int8 append path (pulled on first use;
    # slab rewrites keep it in step).
    scales_host: Optional[np.ndarray] = None


@dataclasses.dataclass
class _ViewPlan:
    """What one in-place refresh writes into a slab view
    (``SpannIndex._plan_view_updates``).  A location is a row of the
    single-device view, or a (shard, row) pair of the sharded one."""

    appends: list = dataclasses.field(default_factory=list)  # [(loc, old_len, add_ids, add_vecs f32, centroid)]
    rewrites: list = dataclasses.field(default_factory=list)  # [(cid, loc, (ids, vecs) or None, centroid)]
    grown: list = dataclasses.field(default_factory=list)  # [(cid, ids)]: the appends' new snapshots

    def commit(self, view, release) -> None:
        """Record the written plan in ``view``'s ``cluster_rows`` and
        ``snapshot``; ``release(loc)`` frees the row of a removed posting."""
        for c, ids in self.grown:
            view.snapshot[c] = ids
        for c, loc, posting, _ in self.rewrites:
            if posting is not None:
                view.cluster_rows[c] = loc
                view.snapshot[c] = posting[0]
            else:
                view.cluster_rows.pop(c, None)
                view.snapshot.pop(c, None)
                release(loc)


class _LazyMemberVecs:
    """Posting member vectors materialized on first touch from the build
    corpus (``corpus[ids]``): a fresh build packs its slabs from the device
    corpus, so nothing host-side reads the replicated member vectors unless
    a save or lookup touches them.  An out-of-core build's corpus is a host
    array or ``np.memmap``: a slice gathers only its own rows."""

    __slots__ = ("_corpus", "_ids", "_mat")

    def __init__(self, corpus: np.ndarray, ids: np.ndarray):
        self._corpus = corpus
        self._ids = ids
        self._mat = None

    def _m(self) -> np.ndarray:
        if self._mat is None:
            self._mat = self._corpus[self._ids]
        return self._mat

    def peek(self) -> np.ndarray:
        """Materialize without caching — for streaming consumers (save)."""
        return self._mat if self._mat is not None else self._corpus[self._ids]

    def __array__(self, dtype=None, copy=None):
        m = self._m()
        return m if dtype is None else m.astype(dtype, copy=False)

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, key):
        if self._mat is None and isinstance(key, slice):
            return self._corpus[self._ids[key]]
        return self._m()[key]


class SpannIndex:
    """SPANN index with host posting state and a device slab view on
    ``device``."""

    def __init__(self, config: Optional[Config] = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.metric = canonical_metric(self.config.distance_metric)
        self.policy = DtypePolicy(self.config.storage_dtype)
        self.dim: Optional[int] = None
        # Canonical state: cluster_id -> (ids int64 (m,), vectors f32 (m, d)).
        self.postings: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.centroids: Dict[int, np.ndarray] = {}
        self._next_cluster_id = 0
        self._padded_view: Optional[PaddedView] = None
        self._gen = 0  # bumped on every mutation; the view caches its gen
        self._padded_gen = -1
        # Cluster ids mutated since the view was packed; None means the
        # change was a bulk load and the next view is a full pack.
        self._dirty_padded: Optional[set] = set()
        # cid -> gen of its last mutation / centroid change, and the gen of
        # the last bulk load (the JAX package's journal for external views).
        # A posting whose centroid changed after a view's gen is rewritten
        # there, never appended to.
        self._mutated_gen: Dict[int, int] = {}
        self._centroid_gen: Dict[int, int] = {}
        self._bulk_gen = 0
        # (gen, all_ids, all_vecs) from a bulk load, for the first view pack.
        self._flat_cache = None
        # (gen, device corpus) from the build, for the on-device slab pack.
        self._corpus_cache = None
        # Largest known replica multiplicity of any point id: full packs
        # compute it, live updates report through note_multiplicity.
        self._mult_hint = 1
        self.build_profile: Dict[str, float] = {}

    def note_multiplicity(self, m: int) -> None:
        self._mult_hint = max(self._mult_hint, int(m))

    def _dedup_bound(self) -> int:
        # +1: a Reassign's copy-before-delete window can raise one id's
        # multiplicity for a moment.
        return _next_pow2(self._mult_hint + 1)

    def _mark_dirty(self, cluster_id: int, centroid: bool = False) -> None:
        """Journal a mutation of ``cluster_id``; ``centroid``: its centroid
        changed too."""
        self._gen += 1
        self._corpus_cache = None  # release the build corpus on the device
        self._mutated_gen[cluster_id] = self._gen
        if centroid:
            self._centroid_gen[cluster_id] = self._gen
        if self._dirty_padded is not None:
            self._dirty_padded.add(cluster_id)

    # -- construction ------------------------------------------------------

    def create_posting_lists(self, clusters, data: np.ndarray, corpus_dev=None,
                             lazy_host: bool = False) -> None:
        """Postings from fitted clusters: one bulk id concatenation.
        ``corpus_dev`` is the build corpus already on ``self.device``; when
        given, the first view packs its slabs from it on the device and the
        host member vectors stay lazy.  ``lazy_host`` keeps them lazy views
        over the host corpus without a device corpus (out-of-core builds:
        the corpus may not fit in host memory twice)."""
        data = np.asarray(data, dtype=np.float32)
        self.dim = data.shape[1]
        all_ids = (np.concatenate([np.asarray(c.points, np.int64) for c in clusters])
                   if clusters else np.empty(0, np.int64))
        fresh = self._next_cluster_id == 0
        corpus_ok = corpus_dev is not None and corpus_dev.shape[0] > (
            int(all_ids.max()) if all_ids.size else -1
        )
        lazy = fresh and (corpus_ok or lazy_host)
        all_vecs = _LazyMemberVecs(data, all_ids) if lazy else data[all_ids]
        pos = 0
        for c in clusters:
            m = len(c.points)
            cid = self._next_cluster_id
            self._next_cluster_id += 1
            ids_c = all_ids[pos : pos + m]
            vecs_c = _LazyMemberVecs(data, ids_c) if lazy else all_vecs[pos : pos + m]
            self.postings[cid] = (ids_c, vecs_c)
            self.centroids[cid] = data[c.centroid_idx].copy()
            pos += m
        self._gen += 1
        self._dirty_padded = None  # bulk load: the next view is a full pack
        self._bulk_gen = self._gen
        if fresh and len(self.postings) == len(clusters):
            self._flat_cache = (self._gen, all_ids, all_vecs)
            if corpus_ok:
                self._corpus_cache = (self._gen, corpus_dev)

    def _as_posting_vecs(self, ids, vectors) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if len(ids) == 0:
            return vectors.reshape(0, self.dim or (vectors.shape[-1] if vectors.ndim > 1 else 0))
        return vectors.reshape(len(ids), -1)

    def add_cluster(self, vectors: np.ndarray, ids: np.ndarray, centroid: np.ndarray) -> int:
        cid = self._next_cluster_id
        self._next_cluster_id += 1
        vectors = self._as_posting_vecs(ids, vectors)
        if self.dim is None:
            self.dim = vectors.shape[1]
        self.postings[cid] = (np.asarray(ids, np.int64), vectors)
        self.centroids[cid] = np.asarray(centroid, np.float32)
        self._mark_dirty(cid, centroid=True)
        return cid

    def remove_cluster(self, cluster_id: int) -> None:
        self.postings.pop(cluster_id, None)
        self.centroids.pop(cluster_id, None)
        self._mark_dirty(cluster_id, centroid=True)

    def replace_posting(self, cluster_id: int, ids: np.ndarray, vectors: np.ndarray,
                        centroid: Optional[np.ndarray] = None) -> None:
        self.postings[cluster_id] = (np.asarray(ids, np.int64),
                                     self._as_posting_vecs(ids, vectors))
        moved = False
        if centroid is not None:
            centroid = np.asarray(centroid, np.float32)
            # Only a real centroid change rules out the append path (mirror
            # syncs pass the unchanged centroid every time).
            moved = not np.array_equal(self.centroids.get(cluster_id), centroid)
            self.centroids[cluster_id] = centroid
        self._mark_dirty(cluster_id, centroid=moved)

    def drop_device_views(self) -> None:
        """Release the device view and the build caches; the host posting
        state is untouched and the next search repacks in full."""
        self._padded_view = None
        self._padded_gen = -1
        self._corpus_cache = None
        self._flat_cache = None

    @property
    def num_clusters(self) -> int:
        return len(self.postings)

    @property
    def num_vectors(self) -> int:
        """Total stored vectors including boundary replicas."""
        return sum(len(ids) for ids, _ in self.postings.values())

    # -- device view -------------------------------------------------------

    def padded_view(self) -> PaddedView:
        """The slab layout: (Cpad, pad, d_pad) with Cpad a multiple of 256,
        pad a multiple of 16 with ``slab_growth_slots`` spare slots, d_pad a
        multiple of 128.  After live updates only the mutated postings are
        written into it in place; it is packed in full after a bulk load or
        when the updates do not fit (counted as ``view.full_repacks``).  Each
        refresh is a ``view.refresh`` span over the dirty postings (every
        posting where there was no view to update)."""
        if self._padded_view is not None and self._padded_gen == self._gen:
            return self._padded_view
        stale = self._padded_view is not None and self._dirty_padded is not None
        with span("view.refresh", len(self._dirty_padded) if stale else len(self.postings)):
            return self._refresh_padded_view()

    def _refresh_padded_view(self) -> PaddedView:
        if (self._padded_view is not None and self._dirty_padded is not None
                and self._apply_padded_updates()):
            self._padded_gen = self._gen
            self._dirty_padded = set()
            return self._padded_view
        if self._padded_view is not None:
            metrics.inc("view.full_repacks")
            self._padded_view = None  # free its device memory before the repack
        if not self.postings:
            raise ValueError("index is empty")
        d = self.dim
        d_pad = max(128, _round_up(d, 128))
        cids = sorted(self.postings)
        C = len(cids)
        Cpad = max(8, _round_up(C, 256))
        max_len = max(len(self.postings[c][0]) for c in cids)
        pad = max(16, _round_up(max(1, max_len) + self.config.search.slab_growth_slots, 16))
        if Cpad * pad >= np.iinfo(np.int32).max:
            raise ValueError("padded view exceeds int32 slot space; shard the index")
        lens = np.zeros(Cpad, np.int32)
        cent = np.zeros((Cpad, d_pad), np.float32)
        valid = np.zeros(Cpad, bool)
        lens_l = np.array([len(self.postings[c][0]) for c in cids], np.int64)
        offs_l = np.zeros(C + 1, np.int64)
        np.cumsum(lens_l, out=offs_l[1:])
        P = int(offs_l[-1])
        lens[:C] = lens_l
        valid[:C] = True
        cent[:C, :d] = np.stack([self.centroids[c] for c in cids])
        if self._flat_cache is not None and self._flat_cache[0] == self._gen:
            all_ids, flat_vecs_all = self._flat_cache[1], self._flat_cache[2]
        else:
            all_ids = np.concatenate([self.postings[c][0] for c in cids])
            flat_vecs_all = np.concatenate([np.asarray(self.postings[c][1], np.float32)
                                            for c in cids])
        flat_ids_all = _ids_i32(all_ids)
        row_of = np.repeat(np.arange(C, dtype=np.int64), lens_l)
        within = np.arange(P, dtype=np.int64) - np.repeat(offs_l[:C], lens_l)
        slots = row_of * pad + within
        dev = self.device
        if self._corpus_cache is not None and self._corpus_cache[0] == self._gen:
            # Member vectors are corpus rows (point id == corpus row in a
            # bulk build): gather them on the device, upload only ids.
            corpus = self._corpus_cache[1]
            rows_dev = torch.from_numpy(all_ids.astype(np.int64)).to(dev)

            def source(s, e):
                return corpus[rows_dev[s:e]]
        else:
            def source(s, e):
                return torch.from_numpy(np.asarray(flat_vecs_all[s:e], np.float32)).to(dev)
        sd = self.policy.storage_dtype
        cent_dev = torch.from_numpy(cent).to(dev)
        vecs_dev, ids_dev, scales_dev = _pack_slabs(
            source, flat_ids_all, slots, Cpad, pad, d, d_pad, sd, dev, cent=cent_dev[:, :d])
        self._mult_hint = max(self._mult_hint, _max_multiplicity(all_ids))
        self._padded_view = PaddedView(
            # int8 storage routes on f32 centroids (the reference's
            # _cast_centroids): every distance stays in real units.
            centroids=cent_dev if self.policy.quantized else cent_dev.to(sd),
            cent_valid=torch.from_numpy(valid).to(dev),
            lens=torch.from_numpy(lens).to(dev),
            ids2d=ids_dev,
            vectors3d=vecs_dev,
            scales=scales_dev,
            pad=pad,
            d_pad=d_pad,
            cluster_rows={c: row for row, c in enumerate(cids)},
            max_dup=self._dedup_bound(),
            free_rows=list(range(Cpad - 1, C - 1, -1)),
            snapshot={c: self.postings[c][0] for c in cids},
        )
        self._padded_gen = self._gen
        self._dirty_padded = set()
        # The view is the only consumer of the build caches; release the
        # device corpus they hold.
        self._flat_cache = None
        self._corpus_cache = None
        return self._padded_view

    def _append_scale_ok(self, view: PaddedView, row: int, centroid: np.ndarray, vecs,
                         old_len: int) -> bool:
        """int8 append admission: appended members quantize with the slab's
        existing scale, which is exact only while a full pack would keep
        that scale, i.e. the appended residuals stay within the slab's
        abs-max.  ``posting_scales_np`` is monotone, so the test is
        f(new_max) <= s_old.  A slab pinned at 1.0 (empty or all-zero
        residuals) always takes a rewrite."""
        if not self.policy.quantized:
            return True
        s_old = float(self._view_scales_host(view)[row])
        if s_old == 1.0:
            return False
        res = np.asarray(vecs, np.float32)[old_len:] - centroid[None, :]
        new_max = np.float32(np.max(np.abs(res), initial=0.0))
        return float(posting_scales_np(np.array([new_max]))[0]) <= s_old

    @staticmethod
    def _view_scales_host(view: PaddedView) -> np.ndarray:
        if view.scales_host is None:
            view.scales_host = view.scales.cpu().numpy().copy()
        return view.scales_host

    def _plan_view_updates(self, view, dirty, view_gen: int, take_row,
                           scale_ok) -> Optional[_ViewPlan]:
        """Sort the ``dirty`` postings into a view's two update tiers, for
        the single-device view and the sharded one alike:

        * **append** — a posting whose ids at the last refresh are a prefix
          of its ids now (streaming inserts), with its centroid unchanged
          since ``view_gen`` and, for int8, ``scale_ok(loc, centroid, vecs,
          old_len)``, writes only its appended member rows;
        * **slab rewrite** — anything else (deletes, reassigns, new or
          removed postings) writes the posting's whole (pad, d_pad) slab, a
          new posting at the location ``take_row()`` gives.

        ``view`` needs ``pad``, ``cluster_rows`` (cid -> location) and
        ``snapshot``.  Each posting and centroid is read once, so a mutation
        racing the plan is taken whole or not at all.  Returns None when the
        batch cannot land in place (a posting outgrew the slab width, or
        ``take_row()`` gave None): nothing in the view has changed then."""
        state = {}  # cid -> ((ids, vecs), centroid), or None once removed
        for c in dirty:
            posting, cent = self.postings.get(c), self.centroids.get(c)
            state[c] = None if posting is None or cent is None else (posting, cent)
        if any(st is not None and len(st[0][0]) > view.pad for st in state.values()):
            return None
        plan = _ViewPlan()
        for c in sorted(dirty):
            loc = view.cluster_rows.get(c)
            if state[c] is None:
                if loc is not None:
                    plan.rewrites.append((c, loc, None, None))  # invalidate its row
                continue  # else: created and removed between refreshes
            (ids, vecs), cent = state[c]
            old = view.snapshot.get(c)
            # An id's coordinates never change (updates mint new ids), so an
            # id-prefix match certifies the resident slab rows.
            grown = (loc is not None and old is not None
                     and self._centroid_gen.get(c, 0) <= view_gen
                     and len(ids) > len(old) and np.array_equal(ids[: len(old)], old))
            if grown and scale_ok(loc, cent, vecs, len(old)):
                plan.appends.append((loc, len(old), ids[len(old):],
                                     np.asarray(vecs[len(old):], np.float32), cent))
                plan.grown.append((c, ids))
                continue
            if grown:
                metrics.inc("view.append_scale_demotions")  # int8: past the slab's scale
            if loc is None:
                loc = take_row()
                if loc is None:
                    return None
            plan.rewrites.append((c, loc, (ids, vecs), cent))
        return plan

    def _apply_padded_updates(self) -> bool:
        """Write the dirty postings into the live view's tensors in place
        (``_plan_view_updates``).  Returns False, having changed nothing,
        when the batch cannot land in place (a posting outgrows its slab,
        no free row is left, the dimension grew): the caller then packs in
        full."""
        view = self._padded_view
        dirty = self._dirty_padded
        if not dirty:
            return True
        if self.dim > view.d_pad:
            return False
        free = list(view.free_rows)
        plan = self._plan_view_updates(
            view, dirty, self._padded_gen, take_row=lambda: free.pop() if free else None,
            scale_ok=lambda row, cent, vecs, n: self._append_scale_ok(view, row, cent, vecs, n))
        if plan is None:
            return False
        if plan.appends:
            metrics.inc("view.append_updates")
            metrics.inc("view.vectors_appended", self._write_appends(view, plan.appends))
        items = [(row, posting, cent) for _, row, posting, cent in plan.rewrites]
        for s0 in range(0, len(items), _UPDATE_ROWS):
            self._rewrite_slabs(view, items[s0 : s0 + _UPDATE_ROWS])
        if items:
            metrics.inc("view.rows_scattered", len(items))
        view.free_rows = free
        plan.commit(view, free.append)
        view.max_dup = max(view.max_dup, self._dedup_bound())
        metrics.inc("view.incremental_updates")
        return True

    # The two in-place writers, shared with the sharded view
    # (``parallel/sharded.py``), which calls them once per shard.  Each
    # writes on the device of the view it is given.

    def _write_appends(self, view: PaddedView, appends) -> int:
        """Write appended member rows into ``view`` in place: ``appends`` is
        [(row, old_len, add_ids, add_vecs (k, d) f32, centroid)]; each
        slab's rows ``old_len:old_len + k`` and its length change.  int8
        rows quantize with their slab's existing scale.  Returns the
        number of rows written."""
        d, pad, d_pad = self.dim, view.pad, view.d_pad
        quant = self.policy.quantized
        B = sum(len(a[2]) for a in appends)
        slots = np.empty(B, np.int64)
        vblk = np.zeros((B, d_pad), np.float32)
        iblk = np.empty(B, np.int32)
        pos = 0
        for row, old_len, add_ids, add_vecs, cent_c in appends:
            k = len(add_ids)
            slots[pos : pos + k] = row * pad + old_len + np.arange(k)
            vblk[pos : pos + k, :d] = add_vecs - cent_c[None, :] if quant else add_vecs
            iblk[pos : pos + k] = _ids_i32(add_ids)
            pos += k
        scale = self._view_scales_host(view)[slots // pad][:, None] if quant else 1.0
        dev = view.vectors3d.device
        slots_dev = torch.from_numpy(slots).to(dev)
        view.vectors3d.view(-1, d_pad)[slots_dev] = _cast_storage_np(
            vblk, self.policy.storage_dtype, scale).to(dev)
        view.ids2d.view(-1)[slots_dev] = torch.from_numpy(iblk).to(dev)
        arows = torch.tensor([a[0] for a in appends], dtype=torch.int64)
        alens = torch.tensor([a[1] + len(a[2]) for a in appends], dtype=torch.int32)
        view.lens[arows.to(dev)] = alens.to(dev)
        return B

    def _rewrite_slabs(self, view: PaddedView, items) -> None:
        """Write whole slabs, centroids, lengths and scales into ``view``:
        ``items`` is [(row, (ids, vecs) or None, centroid)], None
        invalidating the row of a removed posting.  int8 slabs take a
        fresh scale from their residuals (``quant_scale_for``), as a full
        pack computes it."""
        d, pad, d_pad = self.dim, view.pad, view.d_pad
        quant = self.policy.quantized
        sd = self.policy.storage_dtype
        B = len(items)
        rows = np.empty(B, np.int64)
        vblk = np.zeros((B, pad, d_pad), np.float32)
        iblk = np.full((B, pad), -1, np.int32)
        lblk = np.zeros(B, np.int32)
        cblk = np.zeros((B, d_pad), np.float32)
        sclblk = np.ones(B, np.float32)
        vldblk = np.zeros(B, bool)
        for i, (row, posting, cent) in enumerate(items):
            rows[i] = row
            if posting is None:
                continue
            ids, vecs = posting
            m = len(ids)
            vecs = np.asarray(vecs, np.float32)
            if quant:
                vblk[i, :m, :d] = vecs - cent[None, :]
                if m:
                    sclblk[i] = quant_scale_for(vblk[i, :m, :d])
            else:
                vblk[i, :m, :d] = vecs
            iblk[i, :m] = _ids_i32(ids)
            lblk[i] = m
            cblk[i, :d] = cent
            vldblk[i] = True
        dev = view.vectors3d.device
        r = torch.from_numpy(rows).to(dev)
        view.vectors3d[r] = _cast_storage_np(vblk, sd, sclblk[:, None, None]).to(dev)
        view.ids2d[r] = torch.from_numpy(iblk).to(dev)
        view.lens[r] = torch.from_numpy(lblk).to(dev)
        view.centroids[r] = torch.from_numpy(cblk).to(dev).to(view.centroids.dtype)
        view.cent_valid[r] = torch.from_numpy(vldblk).to(dev)
        view.scales[r] = torch.from_numpy(sclblk).to(dev)
        if view.scales_host is not None:
            view.scales_host[rows] = sclblk

    # -- search ------------------------------------------------------------

    def search(
        self,
        queries,
        k: int,
        nprobe: Optional[int] = None,
        prune_factor: Optional[float] = None,
        batch_size: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched ANN search.  Returns (ids (Q, k) int64, dists (Q, k) f32);
        id -1 marks an empty slot (fewer than k reachable candidates).

        ``search.query_wire`` picks how query batches cross to the device:
        f32; ``"bfloat16"`` (the search runs on the bf16-rounded queries);
        or ``"int8"`` (per-query codes ``rint(q / s)`` with
        ``s = max|q| / 127``, dequantized on the device as ``codes * s``).
        Results are the exact search at the staged coordinates."""
        with span("search") as sp:
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            sp.items = queries.shape[0]
            if queries.shape[1] != self.dim:
                raise ValueError(f"query dim {queries.shape[1]} != index dim {self.dim}")
            if nprobe is None:
                nprobe = self.config.search.nprobe or k  # reference: nprobe == k
            if prune_factor is None:
                prune_factor = self.config.search.prune_factor
            bs = batch_size or self.config.search.query_batch_size
            view = self.padded_view()
            eff_nprobe = max(1, min(int(nprobe), int(view.centroids.shape[0])))
            out_i, out_d = [], []
            for s in range(0, queries.shape[0], bs):
                qh = queries[s : s + bs]
                with span("search.stage", qh.shape[0]):
                    qb = self._stage_queries(qh, view.d_pad)
                qi, qd = _search_padded(qb, view, k=int(k), nprobe=eff_nprobe,
                                        metric=self.metric, prune_factor=prune_factor)
                out_i.append(qi)
                out_d.append(qd)
            metrics.inc(f"search.engine.{self.device.type}")
            # One device->host copy for the whole call; ids widen to int64.
            with span("search.d2h"):
                return (
                    torch.cat(out_i).cpu().numpy().astype(np.int64),
                    torch.cat(out_d).cpu().numpy(),
                )

    def _stage_queries(self, a: np.ndarray, d_pad: int) -> torch.Tensor:
        """One query batch as f32 on the device, through the configured
        wire, with the JAX package's arithmetic, widened with zero columns
        to ``d_pad`` where that is wider.  The rows cross unpadded and the
        device appends the zero columns: no padded copy is made on the host
        (at 8,192 x 1,024 f32 such a copy is a fresh 32 MiB mapping,
        page-faulted every batch).  Counts the bytes the wire moves to the
        device in ``search.stage.bytes``."""
        a = np.ascontiguousarray(a)
        wire = self.config.search.query_wire
        if wire == "int8":
            s = np.abs(a).max(axis=1, keepdims=True) / np.float32(127.0)
            s = np.maximum(s, np.float32(1e-30)).astype(np.float32)
            codes = np.clip(np.rint(a / s), -127, 127).astype(np.int8)
            metrics.inc("search.stage.bytes", codes.nbytes + s.nbytes)
            q = (torch.from_numpy(codes).to(self.device).to(torch.float32)
                 * torch.from_numpy(s).to(self.device))
        else:
            # torch.from_numpy takes the caller's buffer, and wants it writeable.
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
            if wire == "bfloat16":
                t = t.to(torch.bfloat16)
            metrics.inc("search.stage.bytes", t.numel() * t.element_size())
            q = t.to(self.device).to(torch.float32)
        return torch.nn.functional.pad(q, (0, d_pad - a.shape[1])) if d_pad > a.shape[1] else q

    def find_k_nearest_neighbor_spann(self, query, k: int) -> Optional[List[PointData]]:
        """Single-query reference-parity API: nprobe = k and 1.2x pruning;
        returns None when pruning leaves no candidates."""
        ids, _ = self.search(
            np.asarray(query, np.float32)[None, :], k, nprobe=k, prune_factor=1.2
        )
        hits = [int(i) for i in ids[0] if i >= 0]
        if not hits:
            return None
        vec_by_id = self._vectors_for(hits)
        return [PointData(i, vec_by_id[i]) for i in hits]

    def _vectors_for(self, point_ids: List[int]) -> Dict[int, np.ndarray]:
        """Resolve result ids to vectors via a gen-cached sorted id -> cid map."""
        if getattr(self, "_id_map_gen", None) != self._gen:
            cids = sorted(self.postings)
            all_ids = np.concatenate([self.postings[c][0] for c in cids])
            all_cids = np.repeat(np.fromiter(cids, np.int64, len(cids)),
                                 [len(self.postings[c][0]) for c in cids])
            order = np.argsort(all_ids, kind="stable")
            self._id_map = (all_ids[order], all_cids[order])
            self._id_map_gen = self._gen
        sids, scids = self._id_map
        out: Dict[int, np.ndarray] = {}
        for pid in point_ids:
            j = int(np.searchsorted(sids, pid))
            if j < len(sids) and sids[j] == pid:
                ids, vecs = self.postings[int(scids[j])]
                row = int(np.nonzero(ids == pid)[0][0])
                out[int(pid)] = np.asarray(vecs[row : row + 1])[0]
        return out

    # -- persistence -------------------------------------------------------

    def save(self, directory: Optional[str] = None, format: str = "packed") -> str:
        """Persist the index in the JAX package's formats: ``packed`` writes
        one CSR file, ``per_cluster`` one file per posting list."""
        directory = directory or self.config.output_path
        os.makedirs(directory, exist_ok=True)
        cids = sorted(self.postings)
        cent = np.stack([self.centroids[c] for c in cids]).astype(np.float32)
        with gzip.open(os.path.join(directory, CENTROIDS_FILE), "wb") as f:
            np.save(f, cent)

        def _vecs(c):
            v = self.postings[c][1]
            return v.peek() if isinstance(v, _LazyMemberVecs) else np.asarray(v, np.float32)

        if format == "packed":
            lens = np.array([len(self.postings[c][0]) for c in cids], np.int64)
            offsets = np.zeros(len(cids) + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
            ids = np.concatenate([self.postings[c][0] for c in cids])
            write_packed_postings_streaming(
                os.path.join(directory, PACKED_FILE), cids, offsets, ids,
                (_vecs(c) for c in cids), self.dim or 0,
            )
        elif format == "per_cluster":
            store = FileBasedPostingListStore(directory)
            for c in cids:
                store.insert_posting_list(c, self.postings[c][0], _vecs(c))
        else:
            raise ValueError(f"unknown save format {format!r}")
        manifest = {
            "format_version": 1,
            "layout": format,
            "dim": self.dim,
            "num_clusters": len(cids),
            "cluster_ids": cids,
            "next_cluster_id": self._next_cluster_id,
            "config": self.config.to_dict(),
            "max_dup": int(_max_multiplicity(
                np.concatenate([np.asarray(self.postings[c][0]) for c in cids]))),
        }
        with open(os.path.join(directory, MANIFEST), "w") as f:
            json.dump(manifest, f)
        return directory

    @classmethod
    def load(cls, directory: str, config: Optional[Config] = None,
             device: torch.device | str = DEFAULT_DEVICE) -> "SpannIndex":
        with open(os.path.join(directory, MANIFEST)) as f:
            manifest = json.load(f)
        cfg = config or Config.from_dict(manifest.get("config", {}))
        idx = cls(cfg, device=device)
        idx.dim = manifest["dim"]
        idx._next_cluster_id = manifest.get("next_cluster_id", 0)
        with gzip.open(os.path.join(directory, CENTROIDS_FILE), "rb") as f:
            cent = np.load(f)
        for c, v in zip((int(c) for c in manifest["cluster_ids"]), cent):
            idx.centroids[c] = v
        if manifest["layout"] == "packed":
            pcids, offsets, ids, vecs = read_packed_postings(os.path.join(directory, PACKED_FILE))
            for i, c in enumerate(pcids):
                s, e = int(offsets[i]), int(offsets[i + 1])
                idx.postings[int(c)] = (np.array(ids[s:e]), np.array(vecs[s:e]))
        else:
            store = FileBasedPostingListStore.load_from_directory(directory)
            for c in store.cluster_ids():
                got = store.get_posting_list(c)
                if got is not None:
                    idx.postings[c] = got
        idx._next_cluster_id = max([idx._next_cluster_id] + [c + 1 for c in idx.postings])
        idx._gen += 1
        return idx
