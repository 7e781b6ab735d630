"""Disk-backed lazy search (counterpart of ``spfresh_tpu/index/lazy.py``).

Only the routing tier lives on the device; posting lists stay on disk and
are paged in per query batch, so a corpus larger than the card (the
DEEP-100M shape) searches in O(centroids) device memory:

  device: the f32 centroid matrix (and its validity mask under an overlay)
  disk:   the packed CSR postings file, mmap'd through the native reader
          (``spfresh_tpu_torch.native``, built at first use; no fallback)
  query:  stage 1 on the device (``ops.topk.centroid_topk``: the dense scan,
          or past 32,768 clusters the window scan kernel) -> the host stages
          the batch's UNIQUE probed slabs (native gather thread, overlay
          patches, cast to the storage dtype, zero-padded to ``d_pad``) ->
          upload -> the slab rerank kernel on the staged batch
          (``ops.rerank.padded_rerank_distances``, float or quantized, with
          the (Q, nprobe) table of staged rows) -> masking + dedup top-k.

Batches are pipelined: while the device reranks batch i, batch i+1's slabs
are gathered on the native thread and patched, cast and uploaded on a
worker thread.  On a CUDA device the worker copies from pinned host buffers
on a stream of its own; the compute stream waits on the copy's event.

Semantics by storage dtype, as in the JAX package: f32 slabs rerank f32
queries; bf16 slabs rerank bf16-rounded queries (the JAX lazy path rounds
them, its in-memory padded engine does not); int8 slabs are residual codes
against the route centroid with one scale per staged slab from its real
rows (``quantize_staged``, the expressions of ``posting_scales_np`` /
``quantize_np``), reranked by the quantized
path with ``scales[inv]`` and ``q - centroid[inv]``.

Not carried over: the compile-shape buckets of the JAX version (the
unique-slab round-up to a multiple of 64 and the padded scatter of the
routing refresh); they change no result.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spfresh_tpu_torch import native
from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from spfresh_tpu_torch.core.dtypes import DtypePolicy
from spfresh_tpu_torch.index.config import Config
from spfresh_tpu_torch.index.posting_store import read_packed_postings
from spfresh_tpu_torch.index.spann import (
    CENTROIDS_FILE,
    MANIFEST,
    PACKED_FILE,
    _ids_i32,
    _max_multiplicity,
    _round_up,
)
from spfresh_tpu_torch.ops.distances import canonical_metric
from spfresh_tpu_torch.ops.rerank import padded_rerank_distances
from spfresh_tpu_torch.ops.topk import centroid_topk, smallest_k_unique
from spfresh_tpu_torch.utils import metrics

# Staged rows are zero-padded to a multiple of this many elements: 16 bytes
# or more of every slab dtype, as the rerank kernel's row loads need.
D_ALIGN = 16


def quantize_staged(vecs: torch.Tensor, lens: torch.Tensor, cents: torch.Tensor):
    """IVF-SQ8 codes of a staged batch on the host: residuals of ``vecs``
    (U, pad, d) f32 against ``cents`` (U, d), one scale per slab from the
    abs-maxima of its ``lens`` real rows (padding rows are zeros, whose
    residual is -centroid, so they stay out of the maximum).  The same f32
    expressions as ``posting_scales_np`` and ``quantize_np`` (scale
    ``rowmax * f32(1/127)``, 1.0 for an all-zero slab; codes
    ``clip(rint(res * (1 / scale)), -127, 127)``, half to even), in torch
    ops that use the host's cores.  Returns (codes int8, scales f32 (U,))."""
    res = vecs - cents[:, None, :]
    real = torch.arange(res.shape[1])[None, :, None] < lens[:, None, None]
    rowmax = res.abs().masked_fill_(~real, 0.0).amax(dim=(1, 2)) if res.numel() else \
        torch.zeros(res.shape[0])
    scales = torch.where(rowmax > 0, rowmax * torch.tensor(np.float32(1.0 / 127.0)),
                         torch.ones_like(rowmax))
    inv = torch.tensor(np.float32(1.0)) / scales
    codes = torch.round(res.mul_(inv[:, None, None])).clamp_(-127, 127).to(torch.int8)
    return codes, scales


class _RwGate:
    """Many-readers / one-writer gate (writer-preferring).

    Searches read; ``reload_base`` (and the compact + reload window of
    ``LazySpFreshIndex``) writes.  Without it a search staging batches
    across a concurrent compact would fetch post-compact (empty) overlay
    patches for pre-compact base slabs and transiently resurrect folded-in
    tombstones."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._writer = True  # gate new readers out first, then drain
            while self._readers:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


def _gather_plain(offsets, ids, vectors, rows: np.ndarray, pad: int, dim: int):
    """Plain version of the native padded gather: postings ``rows`` of the
    packed CSR arrays into (vecs (m, pad, dim) f32 zero-padded, ids (m, pad)
    int64 -1-padded, lens (m,) int32), each posting cut at ``pad``."""
    flat = np.asarray(rows).reshape(-1)
    m = len(flat)
    vecs = np.zeros((m, pad, dim), np.float32)
    out_ids = np.full((m, pad), -1, np.int64)
    lens = np.empty((m,), np.int32)
    offs = np.asarray(offsets)
    for i, r in enumerate(flat):
        s, e = int(offs[r]), int(offs[r + 1])
        ln = min(e - s, pad)
        lens[i] = ln
        vecs[i, :ln] = vectors[s : s + ln]
        out_ids[i, :ln] = ids[s : s + ln]
    return vecs, out_ids, lens


def _apply_patches(vecs, ids, lens, pids, patches, pad: int, dim: int):
    """Overwrite staged base slabs with the live-update overlay: tombstoned
    entries drop, appended vectors extend the tail, split/merge successor
    postings (no base rows) replace the whole slab.  Host-side; rewrites
    only the batch's patched rows, in place (a row's stale tail past its
    new length is zeroed), with the results of the JAX package's version."""
    if not vecs.flags.writeable:
        vecs = vecs.copy()
    if not ids.flags.writeable:
        ids = ids.copy()
    if not lens.flags.writeable:
        lens = lens.copy()
    for j, pid in enumerate(pids):
        p = patches.get(int(pid))
        if p is None:
            continue
        mode, payload = p
        old = int(lens[j])
        if mode == "replace":
            nids, nvecs = payload
            n = min(len(nids), pad)
            vecs[j, :n] = nvecs[:n]
            ids[j, :n] = nids[:n]
        else:  # "patch": dead-base mask + appended tail
            mask, aids, avecs = payload
            nb = old
            if mask is not None:
                keep = np.flatnonzero(~mask[:old])
                nb = len(keep)
                if nb < old:
                    vecs[j, :nb] = vecs[j, keep]
                    ids[j, :nb] = ids[j, keep]
            nb = min(nb, pad)
            na = min(len(aids), pad - nb)
            vecs[j, nb : nb + na] = avecs[:na]
            ids[j, nb : nb + na] = aids[:na]
            n = nb + na
        if n < old:
            vecs[j, n:old] = 0
        ids[j, n:] = -1
        lens[j] = n
    return vecs, ids, lens


class _RouteSnap(NamedTuple):
    """One search's view of the routing tier, captured under
    ``_refresh_lock`` so its fields agree; every batch of a search reads
    this, never ``self``.  The device tensors are never written in place
    (refreshes build new ones), so a concurrent refresh cannot tear it."""

    centroids: torch.Tensor  # (Cpad, d) f32 on the device
    cent_valid: Optional[torch.Tensor]  # (Cpad,) bool on the device, or None
    route_pids: np.ndarray  # (Cpad,) row -> live pid (-1 = free slot)
    row_base: np.ndarray  # (Cpad,) row -> base CSR row (-1 = overlay-only)
    cent_host: Optional[np.ndarray]  # host mirror (overlay mode) or None
    num_clusters: int
    pad: int
    max_dup: int


class _Staged(NamedTuple):
    """One batch's unique probed slabs on the device."""

    vecs: torch.Tensor  # (U, pad, d_pad) storage dtype
    ids: torch.Tensor  # (U, pad) int32, -1 past a posting's length
    lens: torch.Tensor  # (U,) int32
    scales: Optional[torch.Tensor]  # (U,) f32 (int8 slabs)
    cents: Optional[torch.Tensor]  # (U, d_pad) f32 residual origins (int8 slabs)


class LazySpannIndex:
    """Open a saved packed index without loading posting vectors into memory.

    With ``overlay=`` (a ``PackedLireStorage``) the search stays
    live-update-aware: the device centroid matrix refreshes per topology
    generation (splits and merges take free rows of a padded matrix), and
    staged slabs are patched against the overlay's appends and tombstones
    before upload, so the disk-backed index serves SPFresh updates without
    materializing the corpus."""

    def __init__(self, directory: str, config: Optional[Config] = None, pad: Optional[int] = None,
                 prefetch_threads: Optional[int] = None, overlay=None,
                 device: torch.device | str = DEFAULT_DEVICE):
        if prefetch_threads is None:
            # The pipeline only helps when staging can run on a spare core.
            prefetch_threads = 2 if (os.cpu_count() or 1) > 1 else 0
        self.device = resolve_device(device)
        self._directory = str(directory)
        with open(os.path.join(directory, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["layout"] != "packed":
            raise ValueError("lazy mode requires the 'packed' save layout")
        self.config = config or Config.from_dict(manifest.get("config", {}))
        self.metric = canonical_metric(self.config.distance_metric)
        self.policy = DtypePolicy(self.config.storage_dtype)
        self.dim = int(manifest["dim"])
        self.d_pad = _round_up(self.dim, D_ALIGN)
        with gzip.open(os.path.join(directory, CENTROIDS_FILE), "rb") as f:
            cent = np.load(f)
        path = os.path.join(directory, PACKED_FILE)
        self._native = native.NativeCsr(path)
        # numpy mmaps of the same file: the ids/offsets metadata.
        self._cids, self._offsets, self._ids, _ = read_packed_postings(path, mmap=True)
        # The routing tier on the device (f32, real units; int8 applies only
        # to the staged slabs).
        self._centroids = torch.from_numpy(np.ascontiguousarray(cent, np.float32)).to(self.device)
        # Host mirror: the int8 staging residualizes against these rows.
        self._cent_np = np.asarray(cent, np.float32)
        lens = np.asarray(self._offsets[1:]) - np.asarray(self._offsets[:-1])
        self._lens = lens.astype(np.int32)
        self.num_clusters = len(self._cids)
        self.pad = pad or max(8, _round_up(int(lens.max(initial=1)), 8))
        # Replica-multiplicity bound for dedup: from the manifest when the
        # writer recorded it, else a scan on open.
        md = manifest.get("max_dup")
        self.max_dup = max(1, int(md)) if md is not None else _max_multiplicity(
            np.asarray(self._ids))
        # prefetch_threads = 0 stages each batch in line (no overlap).  One
        # worker serves every search of the index (it starts on first use).
        self._pipeline = prefetch_threads > 0
        self._executor = ThreadPoolExecutor(max_workers=1) if self._pipeline else None
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        # Bytes of slabs uploaded by the last search, and its batches.
        self.last_staged_bytes = 0
        self.last_batches = 0
        # Live-update overlay: route rows may diverge from base CSR rows
        # once splits and merges land.
        self._overlay = overlay
        self._overlay_gen = None
        self._cent_valid: Optional[torch.Tensor] = None
        self._cent_host: Optional[np.ndarray] = None  # host mirror for incremental refresh
        self._base_pos = {int(c): i for i, c in enumerate(self._cids)}
        self._route_pids = np.asarray(self._cids, np.int64)
        self._row_base = np.arange(self.num_clusters, dtype=np.int64)
        # Searches read, reload_base (compact swap) writes.
        self._gate = _RwGate()
        # Serializes routing-tier refreshes and snapshot capture.
        self._refresh_lock = threading.Lock()
        if overlay is not None:
            self._refresh_overlay()

    # -- routing tier ------------------------------------------------------

    def _refresh_overlay(self) -> None:
        """Sync the device routing tier and the staging bounds with the
        overlay.  Topology changes (split, merge, centroid moves) update the
        padded centroid matrix, incrementally when they touch few rows,
        else by a rebuild (first sync, growth past the pad, bulk churn).
        Appends and tombstones only move the scalar bounds (pad, dedup);
        the slab patches are fetched per batch."""
        with self._refresh_lock:
            self._refresh_overlay_locked()

    def _routing_snapshot(self) -> _RouteSnap:
        with self._refresh_lock:
            return _RouteSnap(
                self._centroids, self._cent_valid, self._route_pids, self._row_base,
                self._cent_host, self.num_clusters, self.pad, self.max_dup,
            )

    def _refresh_overlay_locked(self) -> None:
        ov = self._overlay
        gen = ov.topology_gen()
        if gen != self._overlay_gen:
            _, pids, cents = ov.centroid_matrix()
            pids = np.asarray(pids, np.int64)
            cents = np.asarray(cents, np.float32)
            if not self._refresh_routing_incremental(pids, cents):
                C = len(pids)
                Cpad = max(8, _round_up(C, 256))
                centp = np.zeros((Cpad, self.dim), np.float32)
                centp[:C] = cents
                self._centroids = torch.from_numpy(centp).to(self.device)
                self._cent_valid = torch.from_numpy(np.arange(Cpad) < C).to(self.device)
                self._cent_host = centp
                rp = np.full(Cpad, -1, np.int64)  # a masked row maps to pid -1
                rp[:C] = pids
                self._route_pids = rp
                rb = np.full(Cpad, -1, np.int64)
                for i, p in enumerate(pids):
                    rb[i] = self._base_pos.get(int(p), -1)
                self._row_base = rb
                self.num_clusters = C
            self._overlay_gen = gen
        need = ov.max_live_len()
        if need > self.pad:
            self.pad = max(8, _round_up(need, 64))
        md = ov.mult_hint()
        if md > self.max_dup:
            self.max_dup = md

    def _refresh_routing_incremental(self, pids, cents) -> bool:
        """Write only the changed routing rows, copy-on-write.

        Slots are stable across refreshes: retired pids free their row, new
        pids take free rows, so a background split touches ~3 rows, not C.
        The device matrix is never written in place: a search's snapshot
        holds the old tensor, so the update builds a new one
        (``index_put`` out of place), and likewise the mask and the host
        mirror.  Returns False (the caller rebuilds) on first sync, when new
        pids exceed the free rows, or when the churn nears a rebuild's
        cost."""
        cent_host = self._cent_host
        if cent_host is None or self._cent_valid is None:
            return False
        slot_pids = self._route_pids
        Cpad = len(slot_pids)
        order = np.argsort(slot_pids, kind="stable")
        sp_sorted = slot_pids[order]
        pos = np.minimum(np.searchsorted(sp_sorted, pids), Cpad - 1)
        has = sp_sorted[pos] == pids
        slot_for = order[pos]
        alive = np.zeros(Cpad, bool)
        alive[slot_for[has]] = True
        removed = np.flatnonzero((slot_pids >= 0) & ~alive)
        new_idx = np.flatnonzero(~has)
        free = np.concatenate([removed, np.flatnonzero(slot_pids < 0)])
        if len(new_idx) > len(free):
            return False  # grew past the pad: rebuild with a bigger Cpad
        ex_slots = slot_for[has]
        changed = np.any(cent_host[ex_slots] != cents[has], axis=1)
        upd_slots = ex_slots[changed]
        if (len(upd_slots) + len(new_idx) + len(removed)) * 4 > Cpad:
            return False  # bulk churn: one upload beats many row writes
        assign = free[: len(new_idx)]
        # A freed slot reassigned in the same refresh takes the new
        # centroid, not the zeroing write.
        zero_slots = np.setdiff1d(removed, assign, assume_unique=True)
        rows = np.concatenate([upd_slots, assign, zero_slots])
        if len(rows) == 0:
            self.num_clusters = len(pids)
            return True
        vals = np.concatenate([
            cents[has][changed],
            cents[new_idx],
            np.zeros((len(zero_slots), self.dim), np.float32),
        ])
        slot_pids = slot_pids.copy()
        slot_pids[removed] = -1
        slot_pids[assign] = pids[new_idx]
        cent_host = cent_host.copy()
        cent_host[rows] = vals
        self._cent_host = cent_host
        rb = self._row_base.copy()
        rb[removed] = -1
        rb[assign] = [self._base_pos.get(int(p), -1) for p in pids[new_idx]]
        rows_t = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        self._centroids = self._centroids.index_put(
            (rows_t,), torch.from_numpy(np.ascontiguousarray(vals)).to(self.device))
        self._cent_valid = torch.from_numpy(slot_pids >= 0).to(self.device)
        self._route_pids = slot_pids
        self._row_base = rb
        self.num_clusters = len(pids)
        metrics.inc("lazy.routing_rows_written", len(rows))
        return True

    @staticmethod
    def _centroid_topk(qb, centroids, cent_valid, nprobe: int, metric: str):
        """Stage 1: ``ops.topk.centroid_topk`` (the window scan kernel past
        32,768 clusters for Euclidean nprobe <= 128, else the chunked or
        dense scan); ``cent_valid`` masks the padding rows of an
        overlay-refreshed matrix (None without an overlay)."""
        return centroid_topk(qb, centroids, cent_valid, nprobe, metric)

    # -- staging -----------------------------------------------------------

    def _cent_rows_host(self, route_rows: np.ndarray, snap: _RouteSnap) -> np.ndarray:
        """Host centroid rows of the given route rows: the int8 residual
        origin, shipped with the batch so quantize and rerank agree."""
        if self._overlay is not None and snap.cent_host is not None:
            return snap.cent_host[route_rows, : self.dim]
        return self._cent_np[route_rows]

    def _batch_pad(self, stage_rows: np.ndarray, patch_info, cap: int) -> int:
        """The batch's slab width: its widest probed posting, before and
        after the overlay patches, rounded up to 8 and at most ``cap``, the
        index's pad (where a longer posting is cut, as in the JAX
        package).  Every posting then stages as it would at ``cap``; the
        slabs are just no wider than the batch needs, whatever posting
        once grew the index's pad."""
        width = np.minimum(self._lens[stage_rows], cap).astype(np.int64)
        if patch_info is not None:
            pids, patches = patch_info
            for j, pid in enumerate(pids):
                p = patches.get(int(pid))
                if p is None:
                    continue
                mode, payload = p
                if mode == "replace":
                    width[j] = len(payload[0])
                else:
                    mask, aids, _ = payload
                    dead = int(mask[: width[j]].sum()) if mask is not None else 0
                    width[j] = max(width[j], width[j] - dead + len(aids))
        return min(cap, max(8, _round_up(int(width.max(initial=1)), 8)))

    def _host_tensors(self, vecs, ids, lens, patch_info, cent_rows, pad: int):
        """The staged batch as host tensors in the wire dtypes: overlay
        patches applied, slabs cast to the storage dtype (int8: residual
        codes with per-slab scales from the real rows) and zero-padded to
        ``d_pad``.  Pinned on a CUDA device."""
        if patch_info is not None:
            vecs, ids, lens = _apply_patches(vecs, ids, lens, patch_info[0], patch_info[1],
                                             pad, self.dim)
        pin = self.device.type == "cuda"
        U, d = len(vecs), self.dim
        sd = self.policy.storage_dtype
        out_v = torch.empty((U, pad, self.d_pad), dtype=sd, pin_memory=pin)
        if self.d_pad > d:
            out_v[..., d:].zero_()
        scales = cents = None
        if self.policy.quantized:
            scales = torch.empty((U,), dtype=torch.float32, pin_memory=pin)
            cents = torch.zeros((U, self.d_pad), dtype=torch.float32, pin_memory=pin)
            cents[:, :d].copy_(torch.from_numpy(np.ascontiguousarray(cent_rows, np.float32)))
            codes, sc = quantize_staged(torch.from_numpy(np.ascontiguousarray(vecs)),
                                        torch.from_numpy(np.asarray(lens, np.int32)),
                                        cents[:, :d])
            out_v[..., :d].copy_(codes)
            scales.copy_(sc)
        else:
            # bf16: round half to even on the host, so the upload moves half
            # the f32 bytes.
            out_v[..., :d].copy_(torch.from_numpy(np.ascontiguousarray(vecs)))
        out_i = torch.empty((U, pad), dtype=torch.int32, pin_memory=pin)
        out_i.copy_(torch.from_numpy(_ids_i32(np.asarray(ids))))
        out_l = torch.empty((U,), dtype=torch.int32, pin_memory=pin)
        out_l.copy_(torch.from_numpy(np.asarray(lens, np.int32)))
        return _Staged(out_v, out_i, out_l, scales, cents)

    def _upload(self, host: _Staged):
        """Copy the host batch to the device.  On a CUDA device the copy runs
        on the index's copy stream from pinned buffers, and this waits for
        it to finish before returning, so the host buffers are never
        released under a copy in flight.  Returns (staged, event)."""
        if self.device.type != "cuda":
            return host, None
        with torch.cuda.stream(self._copy_stream):
            dev = _Staged(*(None if t is None else t.to(self.device, non_blocking=True)
                            for t in host))
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        event.synchronize()
        return dev, event

    def _stage_async(self, rows: np.ndarray, patch_info=None, cent_rows=None,
                     pad: Optional[int] = None):
        """Start staging the batch; returns a future of (staged device
        tensors, copy event or None).

        Pipelined: the disk -> host gather runs on the native C++ thread at
        once; a worker thread joins it, applies the overlay patches, casts
        and uploads, so the whole chain for batch i+1 overlaps batch i's
        rerank."""
        pad = pad or self.pad

        def finish(staged):
            return self._upload(self._host_tensors(*staged, patch_info, cent_rows, pad))

        flat = np.asarray(rows).reshape(-1).astype(np.int32)
        if not self._pipeline:
            done = Future()
            done.set_result(finish(self._native.gather_padded(flat, pad)))
            return done
        job = self._native.gather_padded_async(flat, pad)
        return self._executor.submit(lambda: finish(job.join()))

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               batch_size: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """(ids (Q, k) int64 [-1 = no hit], dists (Q, k) f32)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim {self.dim}")
        if queries.shape[0] == 0:
            return np.empty((0, k), np.int64), np.empty((0, k), np.float32)
        # All batches of one search see one (base files, overlay) pair.
        with self._gate.read():
            return self._search_gated(queries, k, nprobe, batch_size)

    def _rerank(self, qb: torch.Tensor, cent_d: torch.Tensor, inv: np.ndarray, staged: _Staged,
                k: int, max_dup: int):
        """Slab rerank of the staged batch (the kernel on a CUDA device),
        masking, and the dedup top-k: (ids (Q, k) int32, dists (Q, k))."""
        Q, nprobe = inv.shape
        pad = staged.vecs.shape[1]
        inv_d = torch.from_numpy(inv).to(self.device)
        inv_l = inv_d.long()
        qr = torch.zeros((Q, self.d_pad), dtype=torch.float32, device=self.device)
        qr[:, : self.dim] = qb
        if self.policy.storage == "bfloat16":
            qr = qr.to(torch.bfloat16).to(torch.float32)
        if self.policy.quantized:
            cq = (qr[:, None, :] - staged.cents[inv_l]).contiguous()
            dist = padded_rerank_distances(qr, inv_d, staged.vecs, self.metric,
                                           scales=staged.scales[inv_l].contiguous(),
                                           centered_queries=cq)
        else:
            dist = padded_rerank_distances(qr, inv_d, staged.vecs, self.metric)
        ar = torch.arange(pad, device=self.device)
        invalid = (ar >= staged.lens[inv_l][..., None]) | ~torch.isfinite(cent_d)[..., None]
        ids = staged.ids[inv_l].masked_fill_(invalid, -1)
        dist.masked_fill_(invalid, float("inf"))
        vals, out = smallest_k_unique(dist.reshape(Q, nprobe * pad), ids.reshape(Q, nprobe * pad),
                                      k, max_dup=max_dup)
        return torch.where(torch.isfinite(vals), out, torch.full_like(out, -1)), vals

    def _search_gated(self, queries, k: int, nprobe: Optional[int],
                      batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._overlay is not None:
            self._refresh_overlay()
        # One routing view for all batches of this search.
        snap = self._routing_snapshot()
        nprobe = max(1, min(int(nprobe or self.config.search.nprobe or k), snap.num_clusters))
        out_i, out_d = [], []
        staged_bytes = 0
        compute = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

        def finish(qb, cent_d, inv, job):
            staged, event = job.result()
            if event is not None:
                compute.wait_event(event)
                for t in staged:
                    if t is not None:
                        t.record_stream(compute)
            qi, qd = self._rerank(qb, cent_d, inv, staged, int(k), snap.max_dup)
            out_i.append(qi)
            out_d.append(qd)

        # Software pipeline: batch i+1 stages while batch i reranks.  Only a
        # batch's UNIQUE probed slabs are staged; ``inv`` maps each probe to
        # its staged row.
        pending = None
        batches = 0
        for s in range(0, queries.shape[0], batch_size):
            qb = torch.from_numpy(queries[s : s + batch_size]).to(self.device)
            cent_d, rows = self._centroid_topk(qb, snap.centroids, snap.cent_valid, nprobe,
                                               self.metric)
            rows_np = rows.cpu().numpy()
            Q = rows_np.shape[0]
            uniq, inv = np.unique(rows_np.reshape(-1), return_inverse=True)
            patch_info = None
            stage_rows = uniq
            if self._overlay is not None:
                # Route rows -> base CSR rows (-1 = overlay-only posting:
                # gather row 0, the patch replaces the slab whole).
                uniq_pids = snap.route_pids[uniq]
                base = snap.row_base[uniq]
                stage_rows = np.where(base >= 0, base, 0)
                patches = self._overlay.stage_patches(uniq_pids.tolist())
                patch_info = (uniq_pids, patches) if patches else None
            cent_rows = self._cent_rows_host(uniq, snap) if self.policy.quantized else None
            pad = self._batch_pad(stage_rows, patch_info, snap.pad)
            job = self._stage_async(stage_rows, patch_info, cent_rows, pad=pad)
            staged_bytes += len(uniq) * pad * self.d_pad * self.policy.storage_dtype.itemsize
            batches += 1
            if pending is not None:
                finish(*pending)
            pending = (qb, cent_d, inv.reshape(Q, nprobe).astype(np.int32), job)
        if pending is not None:
            finish(*pending)
        self.last_staged_bytes = staged_bytes
        self.last_batches = batches
        metrics.inc(f"search.engine.lazy.{self.device.type}")
        return (torch.cat(out_i).cpu().numpy().astype(np.int64),
                torch.cat(out_d).cpu().numpy())

    # -- lifecycle ---------------------------------------------------------

    def reload_base(self):
        """Re-open the packed base files after an overlay ``compact()``
        swapped them: fresh mmaps, a fresh native reader, rebuilt row maps.
        Quiesces in-flight searches first.  ``LazySpFreshIndex.compact``
        holds ``self._gate.write()`` across its storage compact and this
        reload and calls ``_reload_base_locked`` directly."""
        with self._gate.write():
            self._reload_base_locked()

    def _reload_base_locked(self):
        path = os.path.join(self._directory, PACKED_FILE)
        if self._native is not None:
            self._native.close()
        self._native = native.NativeCsr(path)
        self._cids, self._offsets, self._ids, _ = read_packed_postings(path, mmap=True)
        lens = np.asarray(self._offsets[1:]) - np.asarray(self._offsets[:-1])
        self._lens = lens.astype(np.int32)
        self.num_clusters = len(self._cids)
        self.pad = max(self.pad, max(8, _round_up(int(lens.max(initial=1)), 8)))
        self.max_dup = max(self.max_dup, _max_multiplicity(np.asarray(self._ids)))
        self._base_pos = {int(c): i for i, c in enumerate(self._cids)}
        self._route_pids = np.asarray(self._cids, np.int64)
        self._row_base = np.arange(self.num_clusters, dtype=np.int64)
        # The slot state maps to the OLD base rows: force a full rebuild of
        # the routing tier, not an incremental update.
        self._cent_host = None
        self._overlay_gen = None
        if self._overlay is not None:
            self._refresh_overlay()

    def close(self):
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        if self._native is not None:
            self._native.close()
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
