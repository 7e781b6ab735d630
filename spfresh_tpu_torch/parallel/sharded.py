"""Multi-device SPANN search (counterpart of ``spfresh_tpu/parallel/sharded.py``).

One process drives a list of devices, one shard of the index on each entry;
an entry may name a device that an earlier entry named, so several shards
can share one card.  Posting lists are dealt to the shards size-balanced,
and each shard holds a slab view (``index.spann.PaddedView``) on its
device.  A search runs each query batch in two passes over the shards:

1. stage 1 (``centroid_topk``) on every shard, over its local top
   ``local_np`` lists;
2. on the first device: the global nearest-centroid distance (the pruning
   threshold) and, in ``global`` mode, the global nprobe-th smallest
   centroid distance;
3. on every shard: its probes past that distance masked, the slab rerank
   and masking of ``index.spann._probe_candidates`` (the rerank kernel on
   a CUDA device; the probe axis in chunks past ``PROBE_CHUNK_BYTES``),
   and its distinct local top-k;
4. on the first device: the shards' top-k side by side and a dedup top-k
   across them, since a point's replicas may live on several shards.

The JAX package runs one program under ``shard_map`` and meets the shards
in ``all_gather`` and ``pmin``; here each of those is a copy of a small
tensor to the first device and a reduction there.  Each shard's torch ops
follow its tensors' device, and each kernel wrapper launches on the device
of its tensors; nothing inside a batch waits on the host: the results come
to the host once per search.

Not ported: the CSR ``ShardedView`` and its XLA engine (the slab view is
the single engine, as on one device), the fallback from a failed kernel
compile, and the batch guard for the TPU's scalar memory.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device, resolve_entry
from spfresh_tpu_torch.index.spann import (
    _UPDATE_ROWS,
    PaddedView,
    SpannIndex,
    _ids_i32,
    _max_multiplicity,
    _pack_slabs,
    _probe_candidates,
    _prune_threshold,
    _round_up,
)
from spfresh_tpu_torch.ops.topk import centroid_topk, smallest_k, smallest_k_unique
from spfresh_tpu_torch.utils import metrics


def default_devices() -> List[torch.device]:
    """Every visible CUDA device, in order (the counterpart of
    ``default_mesh``).  Raises where there is no card, as
    ``resolve_device`` does: nothing falls back to the CPU."""
    resolve_device(DEFAULT_DEVICE)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class ShardedPaddedView:
    """One slab view per shard, each on its shard's device, all of one
    shape (Cs, pad, d_pad).  Updated in place like the single-device view:
    ``cluster_rows`` maps cid -> (shard, row), ``free_rows`` holds each
    shard's unassigned rows and ``snapshot`` each posting's ids at the last
    refresh (the append path's test).  The shards' own ``cluster_rows``,
    ``free_rows`` and ``snapshot`` stay empty; their ``max_dup`` follows
    this view's.  Row ``scratch_row`` of every shard is never assigned (the
    JAX package's write sink for batch-padding dummies), so free rows run
    out at the same mutation in both packages."""

    shards: List[PaddedView]
    pad: int
    d_pad: int
    max_dup: int = 8
    scratch_row: int = 0
    cluster_rows: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    free_rows: List[List[int]] = dataclasses.field(default_factory=list)
    snapshot: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def nbytes(self) -> int:
        """Device bytes of every shard's tensors."""
        return sum(t.nbytes for v in self.shards for t in (
            v.centroids, v.cent_valid, v.lens, v.ids2d, v.vectors3d, v.scales))

    def set_max_dup(self, m: int) -> None:
        self.max_dup = m
        for v in self.shards:
            v.max_dup = m


class ShardedSpannIndex:
    """Data-sharded SPANN search over a list of devices: local scan and
    rerank per shard, top-k merge on the first device."""

    def __init__(self, index: SpannIndex, devices: Optional[Sequence] = None):
        """``devices``: one entry per shard (default ``default_devices()``;
        the CPU tests pass ``["cpu"] * 8``)."""
        self.index = index
        self.metric = index.metric
        devs = default_devices() if devices is None else [resolve_entry(d) for d in devices]
        if not devs:
            raise ValueError("no devices")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"shards must be all on CUDA or all on the CPU, got {devs}")
        self.devices = devs
        self.num_shards = len(devs)
        self._padded: Optional[ShardedPaddedView] = None
        self._padded_gen = -1  # index._gen the view holds
        # Refreshes write the view in place, so a search holds this while it
        # refreshes and reads the view.
        self._lock = threading.Lock()

    # -- sharded layout ----------------------------------------------------

    def _deal(self, postings) -> List[List[int]]:
        """Size-balanced deal: biggest posting to the currently-lightest
        shard (the first on equal loads); equal sizes keep the postings'
        dict order, as in the JAX package."""
        if not postings:
            raise ValueError("index is empty")
        cids = sorted(postings, key=lambda c: -len(postings[c][0]))
        load = [0] * self.num_shards
        per_shard: List[List[int]] = [[] for _ in range(self.num_shards)]
        for c in cids:
            s = int(np.argmin(load))
            per_shard[s].append(c)
            load[s] += len(postings[c][0])
        return per_shard

    def padded_view(self) -> ShardedPaddedView:
        with self._lock:
            return self._refresh()

    def _refresh(self) -> ShardedPaddedView:
        """The view at the index's current generation: the dirty postings
        written in place, or a full pack after a bulk load or when they do
        not fit (counted as ``view.full_repacks``)."""
        idx = self.index
        gen = idx._gen
        if self._padded is not None:
            if self._padded_gen == gen:
                return self._padded
            if idx._bulk_gen <= self._padded_gen:
                journal = list(idx._mutated_gen.items())
                dirty = {c for c, g in journal if g > self._padded_gen}
                if self._apply_padded_updates(dirty):
                    # Mutations run one at a time (SpFreshIndex holds its
                    # lock) and each marks its posting after changing it,
                    # so every mutation up to the journal's newest gen has
                    # landed; one still in flight is the next refresh's.
                    self._padded_gen = max([self._padded_gen] + [g for _, g in journal])
                    metrics.inc("view.incremental_updates")
                    return self._padded
            metrics.inc("view.full_repacks")
            self._padded = None  # free its device memory before the repack
        self._padded = self._pack()
        self._padded_gen = gen
        return self._padded

    def _pack(self) -> ShardedPaddedView:
        """Full pack, with the JAX package's formulas: Cs rows a shard
        (a quarter of the fullest shard's postings as headroom, at least
        8, plus the scratch row), pad with ``slab_growth_slots`` spare
        slots, d_pad a multiple of 128."""
        idx = self.index
        centroids = dict(idx.centroids)
        postings = {c: p for c, p in dict(idx.postings).items() if c in centroids}
        per_shard = self._deal(postings)
        d = idx.dim
        d_pad = max(128, _round_up(d, 128))
        occ = max(len(g) for g in per_shard)
        Cs = max(8, _round_up(occ + max(8, occ // 4) + 1, 8))
        max_len = max(len(p[0]) for p in postings.values())
        pad = max(16, _round_up(max(1, max_len) + idx.config.search.slab_growth_slots, 16))
        if Cs * pad >= np.iinfo(np.int32).max:
            raise ValueError("a shard's padded view exceeds int32 slot space; add shards")
        scratch = Cs - 1
        max_dup = _max_multiplicity(np.concatenate([p[0] for p in postings.values()]))
        shards = [self._pack_shard(group, postings, centroids, Cs, pad, d_pad, max_dup, dev)
                  for group, dev in zip(per_shard, self.devices)]
        return ShardedPaddedView(
            shards=shards, pad=pad, d_pad=d_pad, max_dup=max_dup,
            scratch_row=scratch,
            cluster_rows={c: (s, row) for s, g in enumerate(per_shard) for row, c in enumerate(g)},
            free_rows=[list(range(len(g), scratch)) for g in per_shard],
            snapshot={c: postings[c][0] for c in postings},
        )

    def _pack_shard(self, group, postings, centroids, Cs: int, pad: int, d_pad: int,
                    max_dup: int, dev: torch.device) -> PaddedView:
        """One shard's slab view on ``dev``: posting ``group[row]`` in slab
        row ``row``, packed by the single-device ``_pack_slabs`` (int8:
        residual codes with a scale per posting)."""
        idx = self.index
        d = idx.dim
        sd = idx.policy.storage_dtype
        n = len(group)
        lens_l = np.array([len(postings[c][0]) for c in group], np.int64)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens_l, out=offs[1:])
        P = int(offs[-1])
        lens = np.zeros(Cs, np.int32)
        lens[:n] = lens_l
        valid = np.zeros(Cs, bool)
        valid[:n] = True
        cent = np.zeros((Cs, d_pad), np.float32)
        if n:
            cent[:n, :d] = np.stack([centroids[c] for c in group])
        flat_ids = _ids_i32(np.concatenate([postings[c][0] for c in group])
                            if n else np.empty(0, np.int64))
        flat_vecs = (np.concatenate([np.asarray(postings[c][1], np.float32) for c in group])
                     if n else np.empty((0, d), np.float32))
        slots = (np.repeat(np.arange(n, dtype=np.int64), lens_l) * pad
                 + np.arange(P, dtype=np.int64) - np.repeat(offs[:n], lens_l))
        cent_dev = torch.from_numpy(cent).to(dev)
        vecs, ids2d, scales = _pack_slabs(
            lambda s, e: torch.from_numpy(flat_vecs[s:e]).to(dev), flat_ids, slots, Cs, pad,
            d, d_pad, sd, dev, cent=cent_dev[:, :d])
        return PaddedView(
            # int8 slabs route on f32 centroids, as on one device.
            centroids=cent_dev if idx.policy.quantized else cent_dev.to(sd),
            cent_valid=torch.from_numpy(valid).to(dev),
            lens=torch.from_numpy(lens).to(dev),
            ids2d=ids2d, vectors3d=vecs, scales=scales, pad=pad, d_pad=d_pad,
            max_dup=max_dup,
        )

    # -- incremental updates (written into the shards' views in place) ------

    def _apply_padded_updates(self, dirty) -> bool:
        """Land the ``dirty`` postings in the live sharded view without a
        repack, planned as on one device (``_plan_view_updates``): a
        posting that only grew writes its appended rows, anything else its
        whole slab; a new posting takes a free row on the shard with the
        most.  Returns False (the caller packs in full) when a posting
        outgrew the slab width or free rows ran out; the view is then
        unchanged."""
        view = self._padded
        idx = self.index
        if not dirty:
            return True
        if idx.dim is None or idx.dim > view.d_pad:
            return False
        free = [list(f) for f in view.free_rows]

        def take_row():
            s = int(np.argmax([len(f) for f in free]))
            return (s, free[s].pop()) if free[s] else None

        plan = idx._plan_view_updates(
            view, dirty, self._padded_gen, take_row,
            scale_ok=lambda loc, cent, vecs, n: idx._append_scale_ok(
                view.shards[loc[0]], loc[1], cent, vecs, n))
        if plan is None:
            return False
        appended = 0
        for s, v in enumerate(view.shards):
            apl = [(a[0][1],) + a[1:] for a in plan.appends if a[0][0] == s]
            appended += idx._write_appends(v, apl) if apl else 0
            items = [(loc[1], posting, cent) for _, loc, posting, cent in plan.rewrites
                     if loc[0] == s]
            for s0 in range(0, len(items), _UPDATE_ROWS):
                idx._rewrite_slabs(v, items[s0 : s0 + _UPDATE_ROWS])
        if appended:
            metrics.inc("view.append_updates")
            metrics.inc("view.vectors_appended", appended)
        if plan.rewrites:
            metrics.inc("view.rows_scattered", len(plan.rewrites))
        view.free_rows = free
        plan.commit(view, lambda loc: free[loc[0]].append(loc[1]))
        view.set_max_dup(max(view.max_dup, idx._dedup_bound()))
        return True

    # -- search ------------------------------------------------------------

    def search(
        self, queries, k: int, nprobe: Optional[int] = None,
        prune_factor: Optional[float] = None, batch_size: int = 1024,
        nprobe_mode: str = "per_shard",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched multi-device search.  Returns (ids (Q, k) int64, dists
        (Q, k) f32); id -1 marks an empty slot.

        ``nprobe_mode``:

        * ``"per_shard"`` (default): every shard probes its local top
          ``nprobe`` lists, S * nprobe lists in all: a superset of the
          single-device search (more recall per nprobe, not comparable
          across shard counts).
        * ``"global"``: the GLOBAL top ``nprobe`` lists.  Each shard's local
          top-``local_np`` centroid distances meet on the first device, the
          global nprobe-th smallest becomes the probe threshold, and every
          local probe past it is masked (ties at the threshold keep all
          tied lists).  The candidates, and the recall, are the
          single-device index's at equal nprobe.

        ``prune_factor`` prunes, as the reference does, against the GLOBAL
        nearest-centroid distance (the minimum over shards)."""
        if nprobe_mode not in ("per_shard", "global"):
            raise ValueError(f"unknown nprobe_mode {nprobe_mode!r}")
        idx = self.index
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != idx.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim {idx.dim}")
        if nprobe is None:
            nprobe = idx.config.search.nprobe or k
        if prune_factor is None:
            prune_factor = idx.config.search.prune_factor
        out_i, out_d = [], []
        with self._lock:
            view = self._refresh()
            # The local scan depth is clamped to a shard's rows: the global
            # top-nprobe holds at most nprobe lists of any one shard.  The
            # threshold depth is the requested number of lists.
            local_np = max(1, min(int(nprobe), int(view.shards[0].centroids.shape[0])))
            global_k = (max(1, min(int(nprobe), view.num_shards * local_np))
                        if nprobe_mode == "global" else 0)
            qpad = np.zeros((queries.shape[0], view.d_pad), np.float32)
            qpad[:, : idx.dim] = queries
            for s in range(0, queries.shape[0], batch_size):
                qi, qd = self._search_batch(view, qpad[s : s + batch_size], k=int(k),
                                            nprobe=local_np, global_k=global_k,
                                            prune_factor=prune_factor)
                out_i.append(qi)
                out_d.append(qd)
        metrics.inc(f"search.engine.{self.devices[0].type}")
        # One device->host copy for the whole call; ids widen to int64.
        return (torch.cat(out_i).cpu().numpy().astype(np.int64),
                torch.cat(out_d).cpu().numpy())

    def _search_batch(self, view: ShardedPaddedView, qb: np.ndarray, *, k: int, nprobe: int,
                      global_k: int, prune_factor: Optional[float]):
        """One padded query batch (Q, d_pad) through every shard and the
        merge: (ids (Q, k) int32 [-1 = no hit], dists (Q, k) f32) on the
        first device."""
        devs = self.devices
        first = devs[0]
        inf = float("inf")
        host = torch.from_numpy(qb)
        if first.type == "cuda":
            host = host.pin_memory()  # so the uploads wait on nothing
        q_on: Dict[torch.device, torch.Tensor] = {}
        for dev in devs:  # one upload per distinct device
            if dev not in q_on:
                q_on[dev] = host.to(dev, non_blocking=True)

        stage1 = [centroid_topk(q_on[dev].to(v.centroids.dtype), v.centroids, v.cent_valid,
                                nprobe, self.metric)
                  for v, dev in zip(view.shards, devs)]

        # The collectives: pmin of the nearest-centroid distance, and the
        # all_gather of the probes' centroid distances for global nprobe.
        nearest = torch.stack([cd[:, 0].to(first) for cd, _ in stage1]).amin(0)
        thr = _prune_threshold(nearest, prune_factor)
        kth = None
        if global_k:
            merged = torch.cat([cd.to(first) for cd, _ in stage1], dim=1)
            kth = smallest_k(merged, global_k)[0][:, -1]

        local = []
        for v, dev, (cent_d, rows) in zip(view.shards, devs, stage1):
            if kth is not None:
                # A masked probe is an invalid one downstream (its ids are
                # -1), as the JAX package's isfinite test has it.
                cent_d = cent_d.masked_fill(~(cent_d <= kth.to(dev)[:, None]), inf)
            d, cand_ids = _probe_candidates(
                q_on[dev], v, rows, cent_d, k=k, metric=self.metric,
                thr=None if thr is None else thr.to(dev))
            # Distinct local top-k: replicas of one point on this shard must
            # not evict a true neighbour from its k slots.
            local.append(smallest_k_unique(d, cand_ids, k, max_dup=view.max_dup))

        vals, out_ids = smallest_k_unique(
            torch.cat([ld.to(first) for ld, _ in local], dim=1),
            torch.cat([li.to(first) for _, li in local], dim=1), k, max_dup=view.max_dup)
        out_ids = torch.where(torch.isfinite(vals), out_ids, torch.full_like(out_ids, -1))
        return out_ids, vals
