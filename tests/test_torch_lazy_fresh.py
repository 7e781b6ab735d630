"""The port's LazySpFreshIndex and PackedLireStorage (SPFresh live updates
on a disk-backed packed index), on ``device="cpu"``: twins of the 30 tests
of ``tests/test_lazy_fresh.py``, then directories written by one package
opened by the other (packed base, ``overlay.wal``, after ``compact()``),
and one op sequence through both packages' ``LazySpFreshIndex`` with the
pipeline drained, leaving equal live contents.

Tolerances are the JAX tests' own: ``rtol=1e-6`` on stored vectors (the
same f32 bytes), ``rtol=1e-5`` / ``atol=1e-5`` on search distances, and
``rtol=1e-4, atol=1e-5`` on the randomized oracle's f32 distance sums.
Directory crossings compare stored bytes exactly."""

import gzip
import os
import shutil
import struct

import numpy as np
import pytest

import torch

from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.lire import LireConfig, LireStorage
from spfresh_tpu_torch.lire.lazy_fresh import LazySpFreshIndex as _LazySpFreshIndex
from spfresh_tpu_torch.lire.packed_storage import PackedLireStorage

torch.set_num_threads(2)


def LazySpFreshIndex(*args, **kw):
    """The port's LazySpFreshIndex on the CPU."""
    return _LazySpFreshIndex(*args, device="cpu", **kw)


def _build_packed(tmp_path, n=240, dim=8, seed=0, name="idx"):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 4,
                "desired_cluster_size": max(12, n // 8),
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / name),
        }
    )
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build()
    return cfg, index, data, rng


def _brute(data_ids, data_vecs, q, k):
    d = ((data_vecs - q[None, :]) ** 2).sum(axis=1)
    order = np.argsort(d, kind="stable")[:k]
    return [int(data_ids[i]) for i in order]


def _live_set(storage):
    """{vid: vec} over every live entry (replicas collapse)."""
    out = {}
    for pid in storage.posting_ids():
        ids, vecs, _ = storage.get_posting(pid)
        for vid, vec in zip(ids, vecs):
            out[int(vid)] = vec
    return out


# ---------------------------------------------------------------------------
# PackedLireStorage engine
# ---------------------------------------------------------------------------


def test_storage_open_matches_build(tmp_path):
    cfg, index, data, _ = _build_packed(tmp_path)
    st = PackedLireStorage(cfg.output_path)
    assert sorted(st.posting_ids()) == sorted(index.postings)
    for pid in index.postings:
        ids, vecs = index.postings[pid]
        sids, svecs, svers = st.get_posting(pid)
        assert np.array_equal(np.sort(sids), np.sort(ids))
        assert st.get_vector_count(pid) == len(ids)
        np.testing.assert_allclose(
            st.get_posting_centroid(pid), index.centroids[pid], rtol=1e-6
        )
        # base entry versions are globally unique
        assert len(set(svers.tolist())) == len(svers)


def test_storage_parity_with_lire_storage(tmp_path):
    """The same op sequence on both engines leaves the same live content."""
    cfg, index, data, rng = _build_packed(tmp_path, n=120)
    packed = PackedLireStorage(cfg.output_path)
    ram = LireStorage(str(tmp_path / "ram"), index.dim, auto_create_postings=False)
    for pid in sorted(index.postings):
        ids, vecs = index.postings[pid]
        ram.import_posting(pid, ids, vecs, index.centroids[pid])

    pids = sorted(index.postings)
    p0, p1 = pids[0], pids[1 % len(pids)]
    add = rng.standard_normal((5, index.dim)).astype(np.float32)
    for st in (packed, ram):
        st.store_vectors(p0, [1000, 1001, 1002], add[:3])
        st.store_vector(p1, 1003, add[3])
        st.mark_deleted(p0, 1001)
        st.mark_deleted_batch(p1, [1003, 777777])  # second id: miss, skipped
    # delete a BASE vector too
    base_vid = int(index.postings[p0][0][0])
    for st in (packed, ram):
        st.mark_deleted(p0, base_vid)

    for st in (packed, ram):
        assert sorted(st.postings_of(1000)) == [p0]
        assert st.postings_of(1001) == []
        # the tombstoned copy is gone; boundary replicas elsewhere survive
        assert p0 not in st.postings_of(base_vid)
    assert packed.postings_of(base_vid) == ram.postings_of(base_vid)
    a, b = _live_set(packed), _live_set(ram)
    assert set(a) == set(b)
    for vid in a:
        np.testing.assert_allclose(a[vid], b[vid], rtol=1e-6)
    assert packed.get_vector_count(p0) == ram.get_vector_count(p0)
    assert packed.get_vector_count(p1) == ram.get_vector_count(p1)


def test_storage_atomic_replace_and_versions(tmp_path):
    cfg, index, _, rng = _build_packed(tmp_path, n=120)
    st = PackedLireStorage(cfg.output_path)
    pid = sorted(index.postings)[0]
    ids, vecs, _ = st.get_posting(pid)
    v = st.get_posting_version(pid)
    half = len(ids) // 2
    n1, n2 = st.allocate_posting_id(), st.allocate_posting_id()
    new = [
        (n1, ids[:half], vecs[:half], vecs[:half].mean(axis=0)),
        (n2, ids[half:], vecs[half:], vecs[half:].mean(axis=0)),
    ]
    # stale version -> refused
    assert not st.atomic_replace([pid], [v + 999], new)
    assert st.has_posting(pid)
    assert st.atomic_replace([pid], [v], new)
    assert not st.has_posting(pid)
    assert st.has_posting(n1) and st.has_posting(n2)
    got = np.sort(np.concatenate([st.get_posting(n1)[0], st.get_posting(n2)[0]]))
    assert np.array_equal(got, np.sort(ids))
    # a base vid moved into an overlay posting resolves through postings_of
    homes = st.postings_of(int(ids[0]))
    assert n1 in homes and pid not in homes


def test_storage_wal_replay_reopen(tmp_path):
    cfg, index, _, rng = _build_packed(tmp_path, n=120)
    st = PackedLireStorage(cfg.output_path)
    pid = sorted(index.postings)[0]
    add = rng.standard_normal((3, index.dim)).astype(np.float32)
    st.store_vectors(pid, [2000, 2001, 2002], add)
    st.mark_deleted(pid, 2001)
    base_vid = int(index.postings[pid][0][1])
    st.mark_deleted(pid, base_vid)
    before = _live_set(st)
    count = st.get_vector_count(pid)
    st.close()

    st2 = PackedLireStorage(cfg.output_path)
    after = _live_set(st2)
    assert set(before) == set(after)
    assert st2.get_vector_count(pid) == count
    assert st2.postings_of(2001) == []
    assert st2.postings_of(base_vid) == []
    # versions keep advancing monotonically after reopen
    v = st2.store_vector(pid, 2005, add[0])
    assert v > st2.get_posting_version(pid) - 1


def test_storage_torn_transaction_discarded(tmp_path):
    """A crash mid-atomic_replace (WAL transaction without its END marker)
    must leave the old generation intact on replay."""
    cfg, index, _, _ = _build_packed(tmp_path, n=120)
    st = PackedLireStorage(cfg.output_path)
    pid = sorted(index.postings)[0]
    ids, vecs, _ = st.get_posting(pid)
    v = st.get_posting_version(pid)
    n1, n2 = st.allocate_posting_id(), st.allocate_posting_id()
    half = len(ids) // 2
    assert st.atomic_replace(
        [pid],
        [v],
        [
            (n1, ids[:half], vecs[:half], vecs[:half].mean(axis=0)),
            (n2, ids[half:], vecs[half:], vecs[half:].mean(axis=0)),
        ],
    )
    wal = os.path.join(cfg.output_path, "overlay.wal")
    record = 25 + 4 * index.dim  # <Bqqq + f32 payload
    size = os.path.getsize(wal)
    with open(wal, "r+b") as f:  # chop the TXN_END (and a bit more)
        f.truncate(size - 2 * record)
    st2 = PackedLireStorage(cfg.output_path)
    assert st2.has_posting(pid)  # the swap never happened
    assert not st2.has_posting(n1) and not st2.has_posting(n2)
    assert np.array_equal(np.sort(st2.get_posting(pid)[0]), np.sort(ids))


def test_storage_gc_shadow_roundtrip(tmp_path):
    cfg, index, _, rng = _build_packed(tmp_path, n=120)
    st = PackedLireStorage(cfg.output_path)
    pid = sorted(index.postings)[0]
    ids, _, _ = st.get_posting(pid)
    kill = [int(i) for i in ids[: max(1, len(ids) // 2)]]
    st.mark_deleted_batch(pid, kill)
    assert st.needs_garbage_collection(pid, 0.3)
    reclaimed = st.collect_garbage(pid)
    assert reclaimed == len(kill)
    live, _, vers = st.get_posting(pid)
    assert set(live.tolist()) == set(int(i) for i in ids) - set(kill)
    before = _live_set(st)
    st.close()
    st2 = PackedLireStorage(cfg.output_path)  # SHADOW replays deterministically
    assert _live_set(st2).keys() == before.keys()
    assert set(st2.get_posting(pid)[0].tolist()) == set(live.tolist())


def test_storage_compact_then_reopen(tmp_path):
    cfg, index, _, rng = _build_packed(tmp_path, n=120)
    st = PackedLireStorage(cfg.output_path)
    pids = sorted(index.postings)
    add = rng.standard_normal((4, index.dim)).astype(np.float32)
    st.store_vectors(pids[0], [3000, 3001, 3002, 3003], add)
    st.mark_deleted(pids[0], 3001)
    ids, vecs, _ = st.get_posting(pids[1])
    v = st.get_posting_version(pids[1])
    n1 = st.allocate_posting_id()
    assert st.atomic_replace([pids[1]], [v], [(n1, ids, vecs, vecs.mean(axis=0))])
    before = _live_set(st)
    cents = {p: st.get_posting_centroid(p) for p in st.posting_ids()}
    st.compact()
    assert not os.path.exists(os.path.join(cfg.output_path, "overlay.wal"))
    assert st.overlay_rows() == 0
    after = _live_set(st)
    assert before.keys() == after.keys()
    for vid in before:
        np.testing.assert_allclose(before[vid], after[vid], rtol=1e-6)
    for p, c in cents.items():
        np.testing.assert_allclose(st.get_posting_centroid(p), c, rtol=1e-6)
    # a fresh open of the compacted directory needs no WAL at all
    st3 = PackedLireStorage(cfg.output_path)
    assert _live_set(st3).keys() == before.keys()
    assert sorted(st3.posting_ids()) == sorted(st.posting_ids())


# ---------------------------------------------------------------------------
# LazySpFreshIndex end to end
# ---------------------------------------------------------------------------


def _lire_small(**kw):
    return LireConfig(max_partition_size=60, min_partition_size=2, **kw)


def test_lazy_insert_then_searchable(tmp_path):
    cfg, index, data, rng = _build_packed(tmp_path)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        v = rng.standard_normal(index.dim).astype(np.float32)
        fresh.insert(v, 9999)
        ids, dists = fresh.search(v[None, :], k=1, nprobe=fresh.num_clusters)
        assert ids[0, 0] == 9999
        assert dists[0, 0] == pytest.approx(0.0, abs=1e-5)


def test_lazy_delete_removes_from_results(tmp_path):
    cfg, index, data, _ = _build_packed(tmp_path)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        target = 7
        nall = fresh.num_clusters
        ids, _ = fresh.search(data[target][None, :], k=1, nprobe=nall)
        assert ids[0, 0] == target
        fresh.delete(target)
        ids, _ = fresh.search(data[target][None, :], k=3, nprobe=nall)
        assert target not in ids[0].tolist()


def test_lazy_full_probe_exact_after_update_mix(tmp_path):
    """The standing invariant: full-probe search == brute force over the
    live set, after inserts, deletes, and background maintenance."""
    cfg, index, data, rng = _build_packed(tmp_path, n=200)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        add = rng.standard_normal((40, index.dim)).astype(np.float32)
        fresh.insert_batch(add, np.arange(5000, 5040))
        fresh.delete_batch(list(range(0, 30)))
        fresh.flush()

        live = _live_set(fresh.storage)
        vids = np.array(sorted(live))
        vmat = np.stack([live[int(i)] for i in vids])
        queries = rng.standard_normal((8, index.dim)).astype(np.float32)
        ids, dists = fresh.search(queries, k=5, nprobe=fresh.num_clusters)
        for qi in range(len(queries)):
            expect = _brute(vids, vmat, queries[qi], 5)
            assert ids[qi].tolist() == expect


def test_lazy_split_grows_topology_and_stays_searchable(tmp_path):
    cfg, index, data, rng = _build_packed(tmp_path, n=200)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        c0 = fresh.num_clusters
        # Target one posting until it must split.
        pid = fresh.storage.posting_ids()[0]
        cent = fresh.storage.get_posting_centroid(pid)
        add = cent[None, :] + 0.01 * rng.standard_normal(
            (100, index.dim)
        ).astype(np.float32)
        fresh.insert_batch(add, np.arange(7000, 7100))
        fresh.flush()
        assert fresh.num_clusters > c0
        for p in fresh.storage.posting_ids():
            assert fresh.storage.get_vector_count(p) <= 60 * 2  # split cap zone
        # every inserted vector still findable at full probe
        ids, dists = fresh.search(add[:16], k=1, nprobe=fresh.num_clusters)
        found = set(ids[:, 0].tolist())
        assert found <= set(range(7000, 7100))
        assert np.allclose(np.asarray(dists[:, 0]), 0.0, atol=1e-5)


def test_lazy_compact_preserves_results(tmp_path):
    cfg, index, data, rng = _build_packed(tmp_path, n=200)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        add = rng.standard_normal((80, index.dim)).astype(np.float32)
        fresh.insert_batch(add, np.arange(8000, 8080))
        fresh.delete_batch(list(range(0, 20)))
        fresh.flush()
        queries = rng.standard_normal((8, index.dim)).astype(np.float32)
        before_i, before_d = fresh.search(queries, k=5, nprobe=fresh.num_clusters)
        fresh.compact()
        assert fresh.storage.overlay_rows() == 0
        after_i, after_d = fresh.search(queries, k=5, nprobe=fresh.num_clusters)
        assert np.array_equal(before_i, after_i)
        np.testing.assert_allclose(before_d, after_d, rtol=1e-5)
    # the compacted artifact reopens cold and serves the same results
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh2:
        cold_i, _ = fresh2.search(queries, k=5, nprobe=fresh2.num_clusters)
        assert np.array_equal(before_i, cold_i)


def test_lazy_reopen_after_updates(tmp_path):
    cfg, index, data, rng = _build_packed(tmp_path)
    v = rng.standard_normal(index.dim).astype(np.float32)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        fresh.insert(v, 4242)
        fresh.delete(3)
    # no compaction happened: the WAL carries the overlay across reopen
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        ids, dists = fresh.search(v[None, :], k=1, nprobe=fresh.num_clusters)
        assert ids[0, 0] == 4242
        ids, _ = fresh.search(data[3][None, :], k=3, nprobe=fresh.num_clusters)
        assert 3 not in ids[0].tolist()


def test_lazy_pad_growth_past_base_pad(tmp_path):
    """Appending far past the widest base posting must grow the staging pad
    (and stay exact) instead of truncating the slab."""
    cfg, index, data, rng = _build_packed(tmp_path, n=160)
    with LazySpFreshIndex(
        cfg.output_path,
        lire_config=LireConfig(max_partition_size=100_000, min_partition_size=2),
    ) as fresh:
        pid = fresh.storage.posting_ids()[0]
        cent = fresh.storage.get_posting_centroid(pid)
        base_pad = fresh.lazy.pad
        m = base_pad + 40
        add = cent[None, :] + 0.01 * rng.standard_normal((m, index.dim)).astype(
            np.float32
        )
        fresh.insert_batch(add, np.arange(9000, 9000 + m))
        assert fresh.storage.get_vector_count(pid) > base_pad
        ids, dists = fresh.search(add[-4:], k=1, nprobe=fresh.num_clusters)
        assert fresh.lazy.pad > base_pad
        assert np.allclose(np.asarray(dists[:, 0]), 0.0, atol=1e-5)
        assert set(ids[:, 0].tolist()) == set(range(9000 + m - 4, 9000 + m))


def test_storage_mult_hint_survives_reopen(tmp_path):
    """The search dedup bound must not UNDERCOUNT after a WAL replay: an id
    appended to several postings (reassign transients, boundary replicas)
    keeps its full multiplicity in mult_hint on reopen."""
    cfg, index, _, rng = _build_packed(tmp_path, n=120)
    st = PackedLireStorage(cfg.output_path)
    pids = sorted(index.postings)[:3]
    vec = rng.standard_normal(index.dim).astype(np.float32)
    for pid in pids:
        st.store_vector(pid, 7777, vec)
    live_mult = len(st.postings_of(7777))
    assert live_mult == 3
    assert st.mult_hint() >= live_mult
    st.close()

    st2 = PackedLireStorage(cfg.output_path)
    assert len(st2.postings_of(7777)) == live_mult
    assert st2.mult_hint() >= live_mult


def test_lazy_fresh_randomized_oracle(tmp_path):
    """Randomized interleaving of insert/delete/flush/compact/reopen against
    a host oracle of the live set.  After every phase, full-probe search must
    return the oracle's exact nearest neighbours (recall-1.0 invariant), with
    no id repeated in a row; reopen and compaction must preserve the set."""
    cfg, index, data, rng = _build_packed(tmp_path, n=200, dim=8, seed=3)
    oracle = {}  # vid -> vector
    for pid in index.postings:
        ids, vecs = index.postings[pid]
        for vid, vec in zip(ids, vecs):
            oracle[int(vid)] = np.asarray(vec, np.float32)

    def check(fresh, nq=4, k=5):
        live_ids = np.sort(np.fromiter(oracle.keys(), np.int64, len(oracle)))
        live_vecs = np.stack([oracle[int(v)] for v in live_ids])
        qs = rng.standard_normal((nq, fresh.dim)).astype(np.float32)
        ids, dists = fresh.search(qs, k=k, nprobe=fresh.num_clusters)
        ids = np.asarray(ids)
        for r in range(nq):
            row = [int(x) for x in ids[r] if int(x) >= 0]
            assert len(row) == len(set(row)), f"dup ids in row: {row}"
            assert set(row) <= set(live_ids.tolist()), "dead/unknown id returned"
            expect = _brute(live_ids, live_vecs, qs[r], min(k, len(live_ids)))
            got_d = (np.sort(((live_vecs[np.searchsorted(live_ids, row)] - qs[r]) ** 2).sum(1))
                     if row else [])
            exp_d = np.sort(((live_vecs[np.searchsorted(live_ids, expect)] - qs[r]) ** 2).sum(1))
            np.testing.assert_allclose(got_d, exp_d[: len(got_d)], rtol=1e-4, atol=1e-5)
            assert len(row) == len(expect)

    next_id = 10_000
    fresh = LazySpFreshIndex(str(cfg.output_path), config=cfg)
    try:
        for phase in range(6):
            op = phase % 3
            if op == 0:  # burst of inserts
                m = int(rng.integers(8, 40))
                vecs = rng.standard_normal((m, fresh.dim)).astype(np.float32)
                vids = list(range(next_id, next_id + m))
                next_id += m
                fresh.insert_batch(vecs, vids)
                for v, vec in zip(vids, vecs):
                    oracle[v] = vec
            elif op == 1:  # delete a random subset
                pool = list(oracle.keys())
                m = int(rng.integers(4, max(5, len(pool) // 6)))
                kill = [int(x) for x in rng.choice(pool, size=m, replace=False)]
                fresh.delete_batch(kill)
                for v in kill:
                    oracle.pop(v)
            else:  # maintenance + compaction
                fresh.flush()
                fresh.compact()
            fresh.flush()
            check(fresh)
            if phase == 3:  # crash-free reopen mid-run
                fresh.close()
                fresh = LazySpFreshIndex(str(cfg.output_path), config=cfg)
                assert set(_live_set(fresh.storage).keys()) == set(oracle.keys())
                check(fresh)
    finally:
        fresh.close()


def test_stage_patch_serves_retired_snapshot(tmp_path):
    """A search whose routing snapshot predates a split commit probes the
    RETIRED pid: stage_patch must serve its pre-retire content (those
    vectors are invisible via the successors, which aren't in that search's
    centroid matrix) — not an empty slab.  After compaction the snapshot is
    gone (no routing snapshot can predate a compaction reload)."""
    cfg, index, _, rng = _build_packed(tmp_path, n=120)
    st = PackedLireStorage(cfg.output_path)
    pid = sorted(index.postings)[0]
    ids, vecs, _ = st.get_posting(pid)
    # Mutate first so the snapshot must reflect overlay state too.
    extra = rng.standard_normal(vecs.shape[1]).astype(np.float32)
    st.store_vector(pid, 99_999, extra)
    ids2, vecs2, _ = st.get_posting(pid)
    v = st.get_posting_version(pid)
    half = len(ids2) // 2
    n1, n2 = st.allocate_posting_id(), st.allocate_posting_id()
    assert st.atomic_replace(
        [pid], [v],
        [(n1, ids2[:half], vecs2[:half], vecs2[:half].mean(axis=0)),
         (n2, ids2[half:], vecs2[half:], vecs2[half:].mean(axis=0))],
    )
    mode, (sids, svecs) = st.stage_patch(pid)
    assert mode == "replace"
    assert np.array_equal(np.sort(sids), np.sort(ids2))
    order = np.argsort(sids)
    order2 = np.argsort(ids2)
    assert np.allclose(svecs[order], vecs2[order2])
    st.compact()
    mode, (sids, _) = st.stage_patch(pid)
    assert mode == "replace" and len(sids) == 0


def test_incremental_routing_refresh_matches_rebuild(tmp_path):
    """Background splits bump the topology; the serving index must sync its
    routing tier by scattering only the changed rows — and the slot state
    must stay EQUIVALENT to a full rebuild: every live pid routed to a row
    holding its centroid, retired rows invalidated, searches exact."""
    cfg, index, data, rng = _build_packed(tmp_path, n=240)
    fresh = LazySpFreshIndex(cfg.output_path, lire_config=LireConfig())
    try:
        lazy = fresh.lazy
        st = fresh.storage
        assert lazy._cent_host is not None  # initial full rebuild happened
        cent_dev0 = lazy._centroids
        for round_ in range(3):
            # Force a split: overfill one posting.
            pid = max(st.posting_ids(), key=lambda p: st.get_posting(p)[0].size)
            ids0, vecs0, _ = st.get_posting(pid)
            v = st.get_posting_version(pid)
            half = len(ids0) // 2
            n1, n2 = st.allocate_posting_id(), st.allocate_posting_id()
            assert st.atomic_replace(
                [pid], [v],
                [(n1, ids0[:half], vecs0[:half], vecs0[:half].mean(axis=0)),
                 (n2, ids0[half:], vecs0[half:], vecs0[half:].mean(axis=0))],
            )
            q = data[:16]
            ids, dists = lazy.search(q, 5, nprobe=lazy.num_clusters)
            assert np.all(np.asarray(ids)[:, 0] == np.arange(16))
            assert np.allclose(np.asarray(dists)[:, 0], 0.0, atol=1e-4)
        # Incremental path actually ran: the device matrix object was
        # updated in place (scatter), not re-created from a host rebuild
        # with a different Cpad.
        assert lazy._centroids.shape == cent_dev0.shape
        # Slot state == storage state.
        _, pids, cents = st.centroid_matrix()
        hm = lazy._cent_host
        for p, c in zip(pids, cents):
            slot = int(np.flatnonzero(lazy._route_pids == p)[0])
            assert np.allclose(hm[slot], c)
            assert bool(lazy._cent_valid.cpu().numpy()[slot])
        live = set(int(p) for p in pids)
        for slot, sp in enumerate(lazy._route_pids):
            if int(sp) not in live:
                assert not bool(lazy._cent_valid.cpu().numpy()[slot])
        np.testing.assert_allclose(lazy._centroids.cpu().numpy(), hm, atol=0)
    finally:
        fresh.close()


def test_search_survives_split_commit_mid_search(tmp_path):
    """End-to-end version of the retired-snapshot guarantee: a split that
    commits BETWEEN a search's routing refresh and its slab staging (the
    background-pipeline interleaving) must not lose the split posting's
    vectors from that search's results."""
    cfg, index, data, rng = _build_packed(tmp_path, n=240)
    fresh = LazySpFreshIndex(cfg.output_path, lire_config=LireConfig())
    try:
        lazy, st = fresh.lazy, fresh.storage
        orig = st.stage_patches
        fired = {"done": False}

        def racy_stage_patches(pids):
            if not fired["done"]:
                fired["done"] = True
                # Commit a split of the largest probed posting NOW — after
                # the routing refresh, before staging (the background
                # pipeline's interleaving).
                victims = [p for p in pids if st.has_posting(p)]
                if victims:
                    pid = max(victims, key=lambda p: st.get_posting(p)[0].size)
                    ids0, vecs0, _ = st.get_posting(pid)
                    if len(ids0) >= 2:
                        v = st.get_posting_version(pid)
                        h = len(ids0) // 2
                        n1, n2 = (st.allocate_posting_id(),
                                  st.allocate_posting_id())
                        assert st.atomic_replace(
                            [pid], [v],
                            [(n1, ids0[:h], vecs0[:h], vecs0[:h].mean(axis=0)),
                             (n2, ids0[h:], vecs0[h:], vecs0[h:].mean(axis=0))],
                        )
            return orig(pids)

        st.stage_patches = racy_stage_patches
        q = data[:32]
        ids, dists = lazy.search(q, 1, nprobe=lazy.num_clusters)
        assert fired["done"]
        # Full probe + self queries: every query must find itself exactly.
        assert np.all(np.asarray(ids)[:, 0] == np.arange(32))
        assert np.allclose(np.asarray(dists)[:, 0], 0.0, atol=1e-4)
    finally:
        fresh.close()


def test_search_snapshot_survives_concurrent_routing_rebuild(tmp_path, monkeypatch):
    """A search must hold ONE routing-tier snapshot across all its batches.

    A concurrent search's overlay refresh can REBUILD the routing tier with
    a smaller padded centroid matrix (mass merges shrink Cpad).  Before the
    _RouteSnap fix, every batch re-read self._route_pids AFTER its centroid
    scan — rows computed against the old (larger) matrix then indexed the
    new (shorter) table: IndexError at best, wrong slab-to-centroid pairing
    at worst.  This drives that interleaving deterministically by committing
    the merges + refresh between a batch's centroid scan and its route-row
    lookup (exactly where another searcher thread could land them)."""
    import spfresh_tpu_torch.index.lazy as lazy_mod

    # Shrink the rebuild bucket (256 -> 32) so the Cpad shrink is reachable
    # with a test-sized topology; every other _round_up call keeps its m.
    real_ru = lazy_mod._round_up
    monkeypatch.setattr(
        lazy_mod, "_round_up", lambda x, m: real_ru(x, 32 if m == 256 else m)
    )

    cfg, index, data, rng = _build_packed(tmp_path, n=240)
    st = PackedLireStorage(cfg.output_path, auto_create_postings=False)
    lazy = lazy_mod.LazySpannIndex(cfg.output_path, overlay=st, device="cpu")
    try:
        def split_once():
            pid = max(st.posting_ids(), key=lambda p: st.get_posting(p)[0].size)
            ids0, vecs0, _ = st.get_posting(pid)
            assert len(ids0) >= 2
            v = st.get_posting_version(pid)
            h = len(ids0) // 2
            n1, n2 = st.allocate_posting_id(), st.allocate_posting_id()
            assert st.atomic_replace(
                [pid], [v],
                [(n1, ids0[:h], vecs0[:h], vecs0[:h].mean(axis=0)),
                 (n2, ids0[h:], vecs0[h:], vecs0[h:].mean(axis=0))],
            )

        def merge_once():
            p1, p2 = sorted(
                st.posting_ids(), key=lambda p: st.get_posting(p)[0].size
            )[:2]
            i1, v1, _ = st.get_posting(p1)
            i2, v2, _ = st.get_posting(p2)
            mids = np.concatenate([i1, i2])
            mvecs = np.concatenate([v1, v2])
            n = st.allocate_posting_id()
            assert st.atomic_replace(
                [p1, p2],
                [st.get_posting_version(p1), st.get_posting_version(p2)],
                [(n, mids, mvecs, mvecs.mean(axis=0))],
            )

        # Grow past one 32-slot bucket, then sync: Cpad lands at 64.
        while len(st.posting_ids()) < 36:
            split_once()
        lazy.search(data[:1], 1, nprobe=4)
        assert len(lazy._route_pids) == 64
        c_before = lazy.num_clusters  # 36 live pids in rows 0..35

        fired = {"done": False}
        real_topk = type(lazy)._centroid_topk

        def topk_then_rebuild(qb, cents, valid, nprobe, metric):
            out = real_topk(qb, cents, valid, nprobe, metric)
            if not fired["done"]:
                fired["done"] = True
                # The concurrent searcher's interleaving: merges land and
                # ITS refresh rebuilds the tier (28 live -> Cpad 32 < 64)
                # after OUR centroid scan, before OUR route-row lookup.
                while len(st.posting_ids()) > 28:
                    merge_once()
                lazy._refresh_overlay()
                assert len(lazy._route_pids) == 32  # rebuild shrank the tier
            return out

        lazy._centroid_topk = topk_then_rebuild
        q = data[:16]
        ids, dists = lazy.search(q, 3, nprobe=c_before)  # full probe
        assert fired["done"]
        # The in-flight search used its own snapshot: rows 32..35 resolved
        # against the OLD 64-slot table, retired pids served their
        # pre-retire snapshots — self-queries stay exact.
        assert np.all(np.asarray(ids)[:, 0] == np.arange(16))
        assert np.allclose(np.asarray(dists)[:, 0], 0.0, atol=1e-4)
        # A FRESH search takes a new snapshot over the rebuilt tier.
        lazy._centroid_topk = real_topk
        ids2, dists2 = lazy.search(q, 3, nprobe=lazy.num_clusters)
        assert np.all(np.asarray(ids2)[:, 0] == np.arange(16))
        assert np.allclose(np.asarray(dists2)[:, 0], 0.0, atol=1e-4)
    finally:
        lazy.close()
        st.close()


def test_move_vectors_pinned_semantics(tmp_path):
    """storage.move_vectors moves ONLY entries still live at their planned
    version: a concurrent delete (tombstoned entry) or insert (newer entry)
    makes the move skip that vector — never clobber, never resurrect."""
    cfg, index, _, rng = _build_packed(tmp_path, n=60)
    st = PackedLireStorage(cfg.output_path)
    pids = st.posting_ids()
    src, dst = pids[0], pids[1]
    ids, vecs, vers = st.get_posting(src)
    v0, v1, v2 = int(ids[0]), int(ids[1]), int(ids[2])
    ev0, ev1, ev2 = int(vers[0]), int(vers[1]), int(vers[2])
    # v0: delete after planning; v1: newer copy appended after planning.
    st.mark_deleted(src, v0)
    st.store_vector(src, v1, vecs[1] + 1.0)
    moved, _ = st.move_vectors(src, dst, [v0, v1, v2], [ev0, ev1, ev2])
    # v0 must NOT resurrect; v1's planned (old) entry is still live ->
    # moves, and the NEWER copy stays at src; v2 moves plainly.
    assert moved == [v1, v2]
    assert dst in st.postings_of(v1) and dst in st.postings_of(v2)
    assert dst not in st.postings_of(v0)
    src_ids, src_vecs, _ = st.get_posting(src)
    assert v0 not in src_ids
    assert (src_ids == v1).sum() == 1  # the newer foreground copy survived
    np.testing.assert_allclose(
        src_vecs[src_ids == v1][0], vecs[1] + 1.0, rtol=1e-6
    )
    # Reopen: the WAL replays the move exactly.
    st.close()
    st2 = PackedLireStorage(cfg.output_path)
    assert dst in st2.postings_of(v2) and v0 not in st2.get_posting(src)[0]
    st2.close()


def test_move_vectors_duplicate_entry_is_noop(tmp_path):
    """A duplicate (vid, entry_version) pair in one move_vectors call must be
    a no-op on its second occurrence : the old code re-appended to
    dst in RAM, then raised tombstoning the already-tombstoned src entry —
    before the WAL write, so RAM and a reopen-replay diverged."""
    cfg, index, _, rng = _build_packed(tmp_path, n=60)
    st = PackedLireStorage(cfg.output_path)
    pids = st.posting_ids()
    src, dst = pids[0], pids[1]
    ids, _, vers = st.get_posting(src)
    v0, v1 = int(ids[0]), int(ids[1])
    ev0, ev1 = int(vers[0]), int(vers[1])
    moved, versions = st.move_vectors(
        src, dst, [v0, v0, v1, v0], [ev0, ev0, ev1, ev0]
    )
    assert moved == [v0, v1]
    assert len(versions) == 2
    assert (st.get_posting(dst)[0] == v0).sum() == 1  # appended ONCE
    assert v0 not in st.get_posting(src)[0]
    # RAM state == WAL replay state on every touched posting.
    snap = {p: sorted(map(int, st.get_posting(p)[0])) for p in st.posting_ids()}
    st.close()
    st2 = PackedLireStorage(cfg.output_path)
    snap2 = {p: sorted(map(int, st2.get_posting(p)[0])) for p in st2.posting_ids()}
    assert snap == snap2
    st2.close()


def test_compact_gate_quiesces_inflight_search(tmp_path):
    """compact() must be atomic w.r.t. concurrent searches : the
    (storage.compact, reload_base) pair runs under the lazy index's write
    gate, so an in-flight search blocks it and later searches see only the
    post-swap state — never old base slabs with an emptied overlay."""
    import threading
    import time as _time

    cfg, index, data, rng = _build_packed(tmp_path)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        # Mutate so compact has something to fold: delete a vector.
        victim = 3
        fresh.delete(victim)
        fresh.flush()
        entered, release = threading.Event(), threading.Event()

        def reader():
            with fresh.lazy._gate.read():  # a search mid-batch holds this
                entered.set()
                release.wait(timeout=30)

        t = threading.Thread(target=reader)
        t.start()
        assert entered.wait(10)
        done = threading.Event()
        ct = threading.Thread(target=lambda: (fresh.compact(), done.set()))
        ct.start()
        _time.sleep(0.4)
        assert not done.is_set()  # compact waits for the in-flight reader
        release.set()
        t.join()
        ct.join(30)
        assert done.is_set()
        # Post-compact: overlay folded, deleted id gone, search consistent.
        q = data[victim][None, :]
        ids, _ = fresh.search(q, k=4, nprobe=fresh.num_clusters)
        assert victim not in ids[0]
        q2 = data[5][None, :]
        ids2, d2 = fresh.search(q2, k=1, nprobe=fresh.num_clusters)
        assert ids2[0, 0] == 5 and d2[0, 0] == pytest.approx(0.0, abs=1e-5)


def test_concurrent_search_during_compact_never_resurrects(tmp_path):
    """Stress the compact window: searches hammer from a thread while the
    main thread compacts; a deleted vector must never reappear (it would if
    pre-compact slabs were served with the post-compact empty overlay)."""
    import threading

    cfg, index, data, rng = _build_packed(tmp_path)
    with LazySpFreshIndex(cfg.output_path, lire_config=_lire_small()) as fresh:
        victim = 11
        fresh.delete(victim)
        fresh.flush()
        q = data[victim][None, :]
        stop = threading.Event()
        bad = []

        def hammer():
            while not stop.is_set():
                ids, _ = fresh.search(q, k=8, nprobe=fresh.num_clusters)
                if victim in ids[0]:
                    bad.append(ids[0].copy())
                    return

        t = threading.Thread(target=hammer)
        t.start()
        try:
            for _ in range(3):
                fresh.compact()
        finally:
            stop.set()
            t.join(30)
        assert not bad, f"deleted id resurrected during compact: {bad}"


def test_wal_write_failure_poisons_storage(tmp_path):
    """Disk-full / IO-error on a WAL append: the batch already applied to
    the RAM overlay cannot be made durable, so the storage must go
    READ-ONLY (every later mutation refuses BEFORE touching RAM) and a
    reopen must serve exactly the durable prefix."""
    from spfresh_tpu_torch.lire import LireStorageError

    cfg, index, _, rng = _build_packed(tmp_path, n=60)
    st = PackedLireStorage(cfg.output_path)
    pids = st.posting_ids()
    pid = pids[0]
    v = rng.standard_normal(st.dim).astype(np.float32)
    st.store_vector(pid, 900, v)  # durable (WAL healthy)
    # Simulate the WAL device failing mid-run.
    st._wal_path = str(tmp_path / "no_such_dir" / "overlay.wal")
    with pytest.raises(LireStorageError, match="read-only"):
        st.store_vector(pid, 901, v + 1.0)
    # Poisoned: later mutations refuse BEFORE mutating RAM.
    live_before = sorted(map(int, st.get_posting(pid)[0]))
    with pytest.raises(LireStorageError, match="read-only"):
        st.mark_deleted(pid, 900)
    with pytest.raises(LireStorageError, match="read-only"):
        st.compact()  # must NOT bake the diverged RAM into a new base
    assert sorted(map(int, st.get_posting(pid)[0])) == live_before  # reads OK
    assert 900 in live_before
    # Reopen: durable prefix only — 900 replayed, 901 never logged.
    st2 = PackedLireStorage(cfg.output_path)
    ids2 = sorted(map(int, st2.get_posting(pid)[0]))
    assert 900 in ids2 and 901 not in ids2
    st2.close()


def test_stale_wal_after_lost_unlink_is_not_replayed(tmp_path):
    """Power-loss window: compaction swap durable but the WAL unlink lost
    (journal still present).  Recovery must DELETE the stale WAL instead of
    replaying pre-compact records onto the post-compact base."""
    import shutil

    cfg, index, _, rng = _build_packed(tmp_path, n=60)
    st = PackedLireStorage(cfg.output_path)
    pid = st.posting_ids()[0]
    v = rng.standard_normal(st.dim).astype(np.float32)
    st.store_vector(pid, 900, v)
    st.flush()
    wal = str(tmp_path / "stale.wal")
    shutil.copy(st._wal_path, wal)  # the pre-compact WAL
    st.compact()
    post = {p: sorted(map(int, st.get_posting(p)[0])) for p in st.posting_ids()}
    st.close()
    # Simulate: data renames + journal durable, WAL unlink lost.
    shutil.copy(wal, os.path.join(cfg.output_path, "overlay.wal"))
    with open(os.path.join(cfg.output_path, "compact.journal"), "w") as f:
        f.write('{"swap": true}')
    st2 = PackedLireStorage(cfg.output_path)
    got = {p: sorted(map(int, st2.get_posting(p)[0])) for p in st2.posting_ids()}
    assert got == post  # no double-applied mutations
    assert not os.path.exists(os.path.join(cfg.output_path, "overlay.wal"))
    # 900 is in the post-compact BASE exactly once.
    assert sum(row.count(900) for row in got.values()) == 1
    st2.close()


def test_legacy_manifest_compact_does_not_stamp_low_max_dup(tmp_path):
    """A legacy manifest has no save-time max_dup.  compact() must NOT
    stamp max(1, overlay hint) — the base's replica multiplicity is unknown
    there, and a too-low bound breaks the one-id-per-result-row invariant.
    The key stays absent and the next lazy open falls back to the scan."""
    import json

    from spfresh_tpu_torch.index import LazySpannIndex

    cfg, index, data, rng = _build_packed(tmp_path)
    man_path = os.path.join(cfg.output_path, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    true_dup = man.pop("max_dup")  # simulate a legacy save
    with open(man_path, "w") as f:
        json.dump(man, f)
    assert true_dup >= 1
    st = PackedLireStorage(cfg.output_path)
    v = rng.standard_normal(st.dim).astype(np.float32)
    st.store_vector(st.posting_ids()[0], 7777, v)  # any update
    st.compact()
    st.close()
    with open(man_path) as f:
        man2 = json.load(f)
    assert "max_dup" not in man2  # no fabricated (possibly too-low) bound
    lazy = LazySpannIndex(cfg.output_path, device="cpu")
    assert lazy.max_dup >= true_dup  # scan fallback found the real bound
    lazy.close()


def test_move_vectors_collapses_duplicate_in_destination(tmp_path, rng):
    """Replicas of one vid moved from DIFFERENT sources into the same
    destination must collapse to one live copy (a fuzz find: two live
    copies of a vid in ONE posting stranded one of them past a single
    delete).  Pre-existing dst copies collapse too."""
    cfg, index, _, rng2 = _build_packed(tmp_path, n=60)
    st = PackedLireStorage(cfg.output_path)
    a, b, dst = st.posting_ids()[:3]
    v = rng.standard_normal(st.dim).astype(np.float32)
    ev_a = st.store_vector(a, 900, v)
    ev_b = st.store_vector(b, 900, v)  # legitimate cross-posting replica
    # Move both copies into dst in one call: only ONE may land.
    ids_a, _, vers_a = st.get_posting(a)
    ids_b, _, vers_b = st.get_posting(b)
    eva = int(vers_a[ids_a == 900][0])
    evb = int(vers_b[ids_b == 900][0])
    m1, _ = st.move_vectors(a, dst, [900], [eva])
    m2, _ = st.move_vectors(b, dst, [900], [evb])
    assert m1 == [900] and m2 == [900]
    assert (st.get_posting(dst)[0] == 900).sum() == 1
    assert 900 not in st.get_posting(a)[0]
    assert 900 not in st.get_posting(b)[0]
    assert st.postings_of(900) == [dst]
    # Reopen: the WAL replays the collapsed form identically.
    st.close()
    st2 = PackedLireStorage(cfg.output_path)
    assert (st2.get_posting(dst)[0] == 900).sum() == 1
    assert st2.postings_of(900) == [dst]
    st2.close()


def test_move_vectors_collapse_ram_tier(tmp_path, rng):

    st = LireStorage(str(tmp_path / "ram"), 4)
    v = rng.standard_normal(4).astype(np.float32)
    for pid in (0, 1, 2):
        st.store_vector(pid, pid + 50, rng.standard_normal(4).astype(np.float32))
    st.store_vector(0, 900, v)
    st.store_vector(1, 900, v)
    for src in (0, 1):
        ids, _, vers = st.get_posting(src)
        ev = int(np.asarray(vers)[np.asarray(ids) == 900][0])
        st.move_vectors(src, 2, [900], [ev])
    ids2, _, _ = st.get_posting(2)
    assert (np.asarray(ids2) == 900).sum() == 1
    assert sorted(st.postings_of(900)) == [2]


def test_lazy_delete_batch_zero_hit_round_not_terminal(tmp_path, monkeypatch):
    """A round whose every tombstone loses a race to a concurrent move must
    NOT end the batch: the next round's fresh resolve still sees the live
    copy.  (The old ``not hit_any`` break returned 0 with the vector fully
    live — the RAM tier had the same bug, caught by the threaded stress
    grind.)  Simulated by making the FIRST mark_deleted_batch call report
    zero hits."""
    cfg, index, data, rng = _build_packed(tmp_path)
    fresh = LazySpFreshIndex(cfg.output_path, lire_config=LireConfig(min_partition_size=2))
    try:
        v = np.full(data.shape[1], 3.25, np.float32)
        fresh.insert(v, 5555)
        real = fresh.storage.mark_deleted_batch
        calls = {"n": 0}

        def flaky(pid, vids):
            calls["n"] += 1
            if calls["n"] == 1:
                return [], []  # lost the race: nothing tombstoned this round
            return real(pid, vids)

        monkeypatch.setattr(fresh.storage, "mark_deleted_batch", flaky)
        assert fresh.delete_batch([5555]) == 1
        assert calls["n"] >= 2
        assert fresh.storage.postings_of(5555) == []
    finally:
        fresh.close()


# ---------------------------------------------------------------------------
# Directories crossing between the packages
# ---------------------------------------------------------------------------


def _jax():
    from spfresh_tpu import lire as jl

    return jl


def _write_ops(st, rng):
    """One op sequence through either package's PackedLireStorage: single,
    batched and multi-posting appends, base and overlay tombstones, a
    pinned move, a split commit (a WAL transaction), a GC shadow and a
    centroid move.  Leaves the WAL unfolded."""
    pids = sorted(st.posting_ids())
    dim = st.dim
    p0, p1, p2, p3 = pids[:4]
    st.store_vector(p0, 5000, rng.standard_normal(dim).astype(np.float32))
    st.store_vectors(p1, [5001, 5002, 5003], rng.standard_normal((3, dim)).astype(np.float32))
    st.store_vectors_multi([p2, p3, p3], [5004, 5005, 5006],
                           rng.standard_normal((3, dim)).astype(np.float32))
    st.mark_deleted(p1, 5002)
    ids0, _, vers0 = st.get_posting(p0)
    st.mark_deleted(p0, int(ids0[0]))
    st.mark_deleted_batch(p2, [int(i) for i in st.get_posting(p2)[0][:2]] + [987654])
    ids3, _, vers3 = st.get_posting(p3)
    st.move_vectors(p3, p0, [int(ids3[0]), int(ids3[1])], [int(vers3[0]), int(vers3[1])])
    victim = max(st.posting_ids(), key=lambda p: st.get_posting(p)[0].size)
    ids_v, vecs_v, _ = st.get_posting(victim)
    h = len(ids_v) // 2
    n1, n2 = st.allocate_posting_id(), st.allocate_posting_id()
    assert st.atomic_replace(
        [victim], [st.get_posting_version(victim)],
        [(n1, ids_v[:h], vecs_v[:h], vecs_v[:h].mean(axis=0)),
         (n2, ids_v[h:], vecs_v[h:], vecs_v[h:].mean(axis=0))])
    st.mark_deleted_batch(p1, [int(i) for i in st.get_posting(p1)[0][:4]])
    st.collect_garbage(p1)
    st.update_posting_centroid(p2, np.full(dim, 0.25, np.float32))
    st.store_vector(n1, 5007, rng.standard_normal(dim).astype(np.float32))
    st.flush()


def _store_state(st, meta=True):
    """Everything a packed store answers: per posting its entries
    (tombstoned ones included) with versions, live ids, count and
    centroid bytes, the reverse index of a few ids, and the bounds a lazy
    search reads.  ``meta`` adds the version counters."""
    out = {"pids": sorted(st.posting_ids()), "overlay_rows": st.overlay_rows(),
           "max_live": st.max_live_len(), "mult": st.mult_hint()}
    for pid in out["pids"]:
        ids, vecs, vers = st.get_posting(pid, include_deleted=True)
        live, _, _ = st.get_posting(pid)
        out[pid] = (sorted(zip(ids.tolist(), vers.tolist())), sorted(live.tolist()),
                    st.get_vector_count(pid), st.get_posting_centroid(pid).tobytes(),
                    dict(zip(vers.tolist(), (v.tobytes() for v in vecs))))
        if meta:
            out[pid] += (st.get_posting_version(pid),)
    out["postings_of"] = {v: st.postings_of(v) for v in (0, 5, 17, 5000, 5002, 5005, 5007)}
    if meta:
        out["version"] = st.current_version()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packed_store_with_wal_reopens_in_either_package(tmp_path, writer):
    """A packed base plus an unfolded overlay.wal written by either package
    replays to the same state in both."""
    cfg, index, _, _ = _build_packed(tmp_path, n=200)
    mod = _jax() if writer == "jax" else None
    cls = mod.PackedLireStorage if mod else PackedLireStorage
    st = cls(cfg.output_path)
    _write_ops(st, np.random.default_rng(3))
    want = _store_state(st)
    st.close()
    assert os.path.exists(os.path.join(cfg.output_path, "overlay.wal"))
    states = []
    for reader in (_jax().PackedLireStorage, PackedLireStorage):
        copy = tmp_path / f"copy_{reader.__module__.split('.')[0]}"
        shutil.copytree(cfg.output_path, copy)
        got = reader(str(copy))
        states.append(_store_state(got))
        got.close()
    assert states[0] == states[1]
    # A replay bounds each id's multiplicity by all its base rows, dead ones
    # too: an upper bound, so it may exceed the writer's running hint.
    assert states[1].pop("mult") >= want.pop("mult")
    assert states[1] == want


def test_both_packages_write_identical_wal(tmp_path):
    """The same ops on copies of one directory leave byte-identical WALs."""
    cfg, index, _, _ = _build_packed(tmp_path, n=200)
    dirs = {}
    for name, cls in (("jax", _jax().PackedLireStorage), ("port", PackedLireStorage)):
        dirs[name] = tmp_path / name
        shutil.copytree(cfg.output_path, dirs[name])
        st = cls(str(dirs[name]))
        _write_ops(st, np.random.default_rng(4))
        st.close()
    wal = [(dirs[n] / "overlay.wal").read_bytes() for n in ("jax", "port")]
    assert wal[0] == wal[1] and len(wal[0]) > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compacted_store_reopens_in_either_package(tmp_path, writer):
    """compact() by either package: the folded base opens in both with the
    same live state, and both packages' compactions of the same ops write
    the same packed file, manifest and centroids."""
    cfg, index, _, _ = _build_packed(tmp_path, n=200)
    outs = {}
    for name, cls in (("jax", _jax().PackedLireStorage), ("port", PackedLireStorage)):
        d = tmp_path / f"w_{name}"
        shutil.copytree(cfg.output_path, d)
        st = cls(str(d))
        _write_ops(st, np.random.default_rng(5))
        before = _store_state(st, meta=False)
        st.compact()
        assert not os.path.exists(d / "overlay.wal")
        outs[name] = (d, before, _store_state(st, meta=False))
        st.close()
    for f in ("postings.csr", "manifest.json"):
        assert (outs["jax"][0] / f).read_bytes() == (outs["port"][0] / f).read_bytes(), f
    with gzip.open(outs["jax"][0] / "centroids.npy.gz") as a, \
            gzip.open(outs["port"][0] / "centroids.npy.gz") as b:
        assert a.read() == b.read()
    d, before, after = outs[writer]
    live = {p: before[p][1] for p in before["pids"]}
    assert {p: after[p][1] for p in after["pids"]} == live
    # The running multiplicity hint is not stored: after a compaction the
    # bound lives in the manifest's max_dup (compared above), and a fresh
    # open starts its hint again.
    after.pop("mult")
    for reader in (_jax().PackedLireStorage, PackedLireStorage):
        copy = tmp_path / f"r_{reader.__module__.split('.')[0]}"
        shutil.copytree(d, copy)
        got = reader(str(copy))
        state = _store_state(got, meta=False)
        state.pop("mult")
        assert state == after, reader.__module__
        got.close()


def _drained_ops(fresh, data, rng):
    """Inserts (a hot spot that must split), deletes, single ops, each step
    drained so the background pipeline runs in one order."""
    dim = data.shape[1]
    pid = sorted(fresh.storage.posting_ids())[0]
    cent = fresh.storage.get_posting_centroid(pid)
    hot = (cent[None, :] + 0.01 * rng.standard_normal((90, dim))).astype(np.float32)
    fresh.insert_batch(hot, np.arange(7000, 7090))
    fresh.flush()
    fresh.insert_batch(rng.standard_normal((30, dim)).astype(np.float32), np.arange(8000, 8030))
    fresh.flush()
    fresh.delete_batch(list(range(0, 25)) + list(range(7000, 7010)))
    fresh.flush()
    fresh.insert(rng.standard_normal(dim).astype(np.float32), 9000)
    fresh.delete(8001)
    fresh.flush()


def test_lazy_fresh_same_ops_leave_equal_live_contents(tmp_path):
    """One op sequence through both packages' LazySpFreshIndex, pipeline
    drained after each step: equal live contents, equal topology, and the
    same full-probe search results, before and after compact()."""
    cfg, index, data, _ = _build_packed(tmp_path, n=240)
    q = np.random.default_rng(12).standard_normal((12, data.shape[1])).astype(np.float32)
    jd, td = tmp_path / "j", tmp_path / "t"
    shutil.copytree(cfg.output_path, jd)
    shutil.copytree(cfg.output_path, td)
    from spfresh_tpu.lire.lazy_fresh import LazySpFreshIndex as JLazyFresh

    lc = dict(max_partition_size=60, min_partition_size=2)
    with JLazyFresh(str(jd), lire_config=_jax().LireConfig(**lc)) as jf, \
            LazySpFreshIndex(str(td), lire_config=LireConfig(**lc)) as tf:
        _drained_ops(jf, data, np.random.default_rng(13))
        _drained_ops(tf, data, np.random.default_rng(13))
        assert tf.num_clusters > index.num_clusters  # the hot spot split
        a, b = _live_set(jf.storage), _live_set(tf.storage)
        assert a.keys() == b.keys()
        for vid in a:
            np.testing.assert_array_equal(a[vid], b[vid])
        assert sorted(jf.storage.posting_ids()) == sorted(tf.storage.posting_ids())
        for compacted in (False, True):
            ji, jdist = jf.search(q, k=5, nprobe=jf.num_clusters)
            ti, tdist = tf.search(q, k=5, nprobe=tf.num_clusters)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(tdist, jdist, rtol=1e-5)
            if not compacted:
                jf.compact()
                tf.compact()
