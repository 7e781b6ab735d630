"""SpFreshIndex on the port: the same insert/delete sequence on both
packages gives the same postings and search ids, and the JAX package's
end-to-end SpFresh cases (tests/test_spfresh.py) hold for the port."""

import numpy as np
import pytest
import torch

from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.lire import LireConfig as JLireConfig
from spfresh_tpu.lire import SpFreshIndex as JFresh
from spfresh_tpu_torch.index import Config, SpannIndexBuilder, brute_force_search
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex

torch.set_num_threads(2)


def build_fresh(tmp_path, n=120, dim=4, seed=0, **lire_kw):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 3,
                "desired_cluster_size": max(10, n // 6),
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "idx"),
        }
    )
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=False)
    fresh = SpFreshIndex(
        index,
        str(tmp_path / "lire"),
        LireConfig(max_partition_size=2 * max(10, n // 6), min_partition_size=2, **lire_kw),
    )
    return fresh, data, rng


def test_insert_then_searchable(tmp_path):
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        v = rng.standard_normal(4).astype(np.float32)
        fresh.insert(v, 9999)
        ids, dists = fresh.search(v[None, :], k=1)
        assert ids[0, 0] == 9999
        assert dists[0, 0] == pytest.approx(0.0, abs=1e-5)


def test_delete_removes_from_results(tmp_path):
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        target = 7
        nall = fresh.index.num_clusters
        ids, _ = fresh.search(data[target][None, :], k=1, nprobe=nall)
        assert ids[0, 0] == target
        fresh.delete(target)
        ids, _ = fresh.search(data[target][None, :], k=3, nprobe=nall)
        assert target not in ids[0]
        with pytest.raises(KeyError):
            fresh.delete(target)  # double delete


def test_insert_batch_and_recall(tmp_path):
    fresh, data, rng = build_fresh(tmp_path, n=200)
    with fresh:
        new_vecs = rng.standard_normal((50, 4)).astype(np.float32)
        new_ids = np.arange(1000, 1050)
        fresh.insert_batch(new_vecs, new_ids)
        fresh.flush()
        all_data = np.concatenate([data, new_vecs])
        all_ids = np.concatenate([np.arange(200), new_ids])
        queries = rng.standard_normal((10, 4)).astype(np.float32)
        got, _ = fresh.search(queries, k=5, nprobe=fresh.index.num_clusters)
        _, gt_rows = brute_force_search(all_data, queries, k=5, device="cpu")
        gt_ids = all_ids[gt_rows]
        recall = np.mean([len(set(got[q]) & set(gt_ids[q])) / 5 for q in range(10)])
        assert recall == 1.0, f"full-probe recall {recall} after live inserts"


def test_split_triggers_and_preserves_vectors(tmp_path):
    fresh, data, rng = build_fresh(tmp_path, n=60)
    fresh.lire_config.max_partition_size = 25
    fresh.protocol.config.max_partition_size = 25
    with fresh:
        before = fresh.index.num_clusters
        # Hammer one region so one posting crosses the threshold.
        base = rng.standard_normal(4).astype(np.float32)
        for i in range(40):
            fresh.insert(base + 0.01 * rng.standard_normal(4).astype(np.float32), 5000 + i)
        fresh.flush()
        assert fresh.index.num_clusters > before  # split happened
        # Every inserted vector is still reachable at full probe.
        got, _ = fresh.search(base[None, :], k=40, nprobe=fresh.index.num_clusters)
        inserted = set(range(5000, 5040))
        assert len(inserted & set(got[0].tolist())) == 40


def test_merge_triggers_on_drain(tmp_path):
    fresh, data, rng = build_fresh(tmp_path, n=120)
    fresh.protocol.config.min_partition_size = 5
    with fresh:
        # Delete most points of one posting to force a merge.
        pid = sorted(fresh.index.postings)[0]
        victim_ids = fresh.index.postings[pid][0].tolist()
        clusters_before = fresh.index.num_clusters
        for vid in victim_ids[: len(victim_ids) - 2]:
            try:
                fresh.delete(int(vid))
            except KeyError:
                pass
        fresh.flush()
        # The undersized posting merged away (or was retired into a new one).
        assert fresh.index.num_clusters <= clusters_before
        # Consistency: mirror matches storage.
        for cid in fresh.index.postings:
            ids_idx = set(fresh.index.postings[cid][0].tolist())
            ids_sto = set(fresh.storage.get_posting(cid)[0].tolist())
            assert ids_idx == ids_sto


def test_storage_reopen_preserves_updates(tmp_path):
    fresh, data, rng = build_fresh(tmp_path)
    v = rng.standard_normal(4).astype(np.float32)
    with fresh:
        fresh.insert(v, 31337)
        fresh.delete(3)
    # Reopen storage on the same path: updates survive.
    cfg = fresh.index.config
    from spfresh_tpu_torch.index import SpannIndex
    from spfresh_tpu_torch.lire import LireStorage

    storage2 = LireStorage(str(tmp_path / "lire"), 4)
    found = False
    all_live = set()
    for pid in storage2.posting_ids():
        ids, _, _ = storage2.get_posting(pid)
        all_live |= set(ids.tolist())
    assert 31337 in all_live
    assert 3 not in all_live


def test_repair_clears_flags(tmp_path):
    from spfresh_tpu_torch.lire import Split
    from spfresh_tpu_torch.lire.pipeline import PartitionStatus

    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        # Force a GENUINE failure: a 1-vector posting cannot split.  (A
        # nonexistent posting is a STALE op now — skipped, not failed.)
        fresh.storage.import_posting(
            99999, np.array([424242]), data[:1], data[0]
        )
        fresh.pipeline.submit_task(Split(99999))
        fresh.pipeline.drain()
        assert fresh.pipeline.get_partition_status(99999) == PartitionStatus.NEEDS_MAINTENANCE
        inspected = fresh.repair()
        fresh.flush()
        assert inspected >= 1
        assert fresh.pipeline.get_partition_status(99999) == PartitionStatus.READY


def test_typed_lire_errors(tmp_path):
    from spfresh_tpu_torch.lire import (
        LireOperationError,
        Merge,
        MergeError,
        Split,
        SplitError,
    )
    from spfresh_tpu_torch.lire.operations import LireContext
    from spfresh_tpu_torch.lire import LireStorage

    storage = LireStorage(str(tmp_path / "l"), 2)
    ctx = LireContext(storage=storage, alloc_posting_id=lambda: 1)
    with pytest.raises(SplitError):
        Split(0).validate(ctx)
    with pytest.raises(MergeError):
        Merge(0, 0).validate(ctx)
    assert issubclass(SplitError, LireOperationError)


def test_flush_self_heals_flagged_partitions(tmp_path):
    from spfresh_tpu_torch.lire import Split
    from spfresh_tpu_torch.lire.pipeline import PartitionStatus

    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        fresh.storage.import_posting(
            99999, np.array([424242]), data[:1], data[0]
        )
        fresh.pipeline.submit_task(Split(99999))  # 1-vector: genuine failure
        # flush alone (no manual repair call) must clear the transient flag.
        fresh.flush()
        assert (
            fresh.pipeline.get_partition_status(99999) == PartitionStatus.READY
        )


def test_spfresh_randomized_oracle(tmp_path):
    """Randomized interleaving of insert/delete/flush against a host oracle
    of the live set (in-RAM mirror twin of the lazy-path fuzz test): after
    every phase full-probe search must return the oracle's exact nearest
    neighbours with no duplicate and no dead ids."""
    fresh, data, rng = build_fresh(tmp_path, n=200, dim=8, seed=5)
    oracle = {int(i): data[i] for i in range(len(data))}

    def _brute(live_ids, live_vecs, q, k):
        d = ((live_vecs - q[None, :]) ** 2).sum(axis=1)
        return np.sort(d, kind="stable")[:k]

    def check(nq=4, k=5):
        live_ids = np.sort(np.fromiter(oracle.keys(), np.int64, len(oracle)))
        live_vecs = np.stack([oracle[int(v)] for v in live_ids])
        qs = rng.standard_normal((nq, 8)).astype(np.float32)
        ids, dists = fresh.search(qs, k=k, nprobe=fresh.index.num_clusters)
        ids = np.asarray(ids)
        for r in range(nq):
            row = [int(x) for x in ids[r] if int(x) >= 0]
            assert len(row) == len(set(row)), f"dup ids in row: {row}"
            assert set(row) <= set(live_ids.tolist()), "dead/unknown id returned"
            got_d = np.sort(
                ((live_vecs[np.searchsorted(live_ids, row)] - qs[r]) ** 2).sum(1)
            )
            exp_d = _brute(live_ids, live_vecs, qs[r], min(k, len(live_ids)))
            np.testing.assert_allclose(got_d, exp_d[: len(got_d)], rtol=1e-4, atol=1e-5)
            assert len(row) == min(k, len(live_ids))

    next_id = 10_000
    with fresh:
        for phase in range(6):
            op = phase % 3
            if op == 0:
                m = int(rng.integers(8, 40))
                vecs = rng.standard_normal((m, 8)).astype(np.float32)
                vids = list(range(next_id, next_id + m))
                next_id += m
                fresh.insert_batch(vecs, vids)
                for v, vec in zip(vids, vecs):
                    oracle[v] = vec
            elif op == 1:
                pool = list(oracle.keys())
                m = int(rng.integers(4, max(5, len(pool) // 6)))
                kill = [int(x) for x in rng.choice(pool, size=m, replace=False)]
                fresh.delete_batch(kill)
                for v in kill:
                    oracle.pop(v)
            else:
                fresh.flush()
            fresh.flush()
            check()


def test_reopen_allocator_clears_storage_pids(tmp_path):
    """Background splits mint posting ids past the saved index's
    next_cluster_id; reopening on the same storage must advance the
    allocator past every pid storage knows — a colliding allocation lets
    atomic_replace silently overwrite a live posting (data loss)."""
    fresh, data, rng = build_fresh(tmp_path, n=160)
    # Force splits: hot-spot inserts into one posting.
    cent = fresh.storage.get_posting_centroid(fresh.storage.posting_ids()[0])
    hot = cent[None, :] + 0.01 * rng.standard_normal((120, data.shape[1])).astype(
        np.float32
    )
    fresh.insert_batch(hot, np.arange(50_000, 50_120))
    fresh.flush()
    max_pid = max(fresh.storage.posting_ids())
    assert max_pid >= fresh.index._next_cluster_id - 1
    # Save the ORIGINAL (pre-split) index to disk, as a crash would leave it.
    fresh.close()

    cfg = Config.from_dict(
        {
            "clustering_params": {
                "initial_k": 3,
                "desired_cluster_size": 26,
                "rng_seed": 42,
            },
            "output_path": str(tmp_path / "idx2"),
        }
    )
    stale = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=False)
    assert stale._next_cluster_id <= max_pid  # the stale manifest's view
    reopened = SpFreshIndex(
        stale, str(tmp_path / "lire"),
        LireConfig(max_partition_size=52, min_partition_size=2),
        start_pipeline=False,
    )
    try:
        assert reopened.index._next_cluster_id > max_pid
        assert reopened._alloc_posting_id() not in set(
            reopened.storage.posting_ids()
        )
    finally:
        reopened.close()


def test_delete_batch_retired_fallback_updates_mirror(tmp_path):
    """A posting retired between delete_batch's map snapshot and its storage
    call: the fallback must tombstone the vector in its successor AND purge
    it from the search mirror — it previously stayed searchable forever."""
    fresh, data, rng = build_fresh(tmp_path, n=160)
    try:
        st = fresh.storage
        victim_pid = max(st.posting_ids(), key=lambda p: st.get_posting(p)[0].size)
        vids0, vecs0, _ = st.get_posting(victim_pid)
        target = int(vids0[0])
        orig = st.mark_deleted_batch
        fired = {}

        def racy(pid, vids):
            if pid == victim_pid and not fired:
                fired["x"] = True
                v = st.get_posting_version(victim_pid)
                h = len(vids0) // 2
                n1, n2 = fresh._alloc_posting_id(), fresh._alloc_posting_id()
                assert st.atomic_replace(
                    [victim_pid], [v],
                    [(n1, vids0[:h], vecs0[:h], vecs0[:h].mean(axis=0)),
                     (n2, vids0[h:], vecs0[h:], vecs0[h:].mean(axis=0))],
                )
                # Mirror the successors like the background pipeline would.
                fresh._on_posting_created(n1, vecs0[:h].mean(axis=0))
                fresh._on_posting_created(n2, vecs0[h:].mean(axis=0))
                fresh._on_posting_retired(victim_pid)
            return orig(pid, vids)

        st.mark_deleted_batch = racy
        n_del = fresh.delete_batch([target])
        assert fired and n_del == 1
        # The tombstone must be mirror-visible: a full-probe search for the
        # deleted vector's own coordinates must NOT return its id.
        qv = data[target] if target < len(data) else vecs0[0]
        ids, _ = fresh.search(qv[None, :], 5,
                              nprobe=fresh.index.num_clusters)
        assert target not in set(np.asarray(ids)[0].tolist())
    finally:
        fresh.close()


def test_insert_batch_reroute_fallback_visible_in_search(tmp_path):
    """A routing destination retired between insert_batch's centroid scan
    and its storage append: the per-vector re-route fallback must leave the
    vectors SEARCHABLE (mirror synced where the re-routes landed, not where
    the stale routing pointed)."""
    from spfresh_tpu_torch.lire.storage import LireStorageError

    fresh, data, rng = build_fresh(tmp_path, n=160)
    try:
        st = fresh.storage
        orig = st.store_vectors_multi
        fired = {}

        def racy(nearest, vids, vecs):
            if not fired:
                fired["x"] = True
                # Retire the most common destination (split it), mirroring
                # like the background pipeline would.
                pid = int(np.bincount(nearest).argmax())
                ids0, vecs0, _ = st.get_posting(pid)
                v = st.get_posting_version(pid)
                h = max(1, len(ids0) // 2)
                n1, n2 = fresh._alloc_posting_id(), fresh._alloc_posting_id()
                assert st.atomic_replace(
                    [pid], [v],
                    [(n1, ids0[:h], vecs0[:h], vecs0[:h].mean(axis=0)),
                     (n2, ids0[h:], vecs0[h:], vecs0[h:].mean(axis=0))],
                )
                fresh._on_posting_created(n1, vecs0[:h].mean(axis=0))
                fresh._on_posting_created(n2, vecs0[h:].mean(axis=0))
                fresh._on_posting_retired(pid)
            return orig(nearest, vids, vecs)

        st.store_vectors_multi = racy
        add = data[:24] + 0.001
        fresh.insert_batch(add, np.arange(90_000, 90_024))
        assert fired
        ids, dists = fresh.search(add, 1, nprobe=fresh.index.num_clusters)
        got = set(np.asarray(ids)[:, 0].tolist())
        assert got == set(range(90_000, 90_024)), got
        assert np.allclose(np.asarray(dists)[:, 0], 0.0, atol=1e-5)
    finally:
        fresh.close()


def test_insert_map_entry_survives_concurrent_mirror_sync(tmp_path):
    """A background op's ``_sync_mirror`` can mirror a fresh insert BEFORE
    insert()'s own mirror block runs (the sync reads storage, where the
    append landed first).  insert() must still record the id->posting map
    entry — pre-fix it skipped ``_map_add`` whenever the mirror already held
    the vid, and an immediate delete() raised KeyError for a live vector
    (caught by the threaded stress suite)."""
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        real_insert = fresh.protocol.insert

        def insert_then_background_sync(vector, vector_id, posting_id=None):
            res = real_insert(vector, vector_id, posting_id)
            # Emulate a Reassign/_on_posting_created sync landing between
            # the storage append and insert()'s mirror block.
            fresh._sync_mirror(list(res.partitions_affected))
            return res

        fresh.protocol.insert = insert_then_background_sync
        v = rng.standard_normal(4).astype(np.float32)
        fresh.insert(v, 7777)
        fresh.protocol.insert = real_insert
        assert 7777 in fresh._id_map and fresh._id_map[7777]
        fresh.delete(7777)  # pre-fix: KeyError('vector 7777 not found')
        assert fresh.storage.postings_of(7777) == []


def test_delete_falls_back_to_storage_reverse_index(tmp_path):
    """Even with a lagging (empty) map entry, delete() must resolve live
    copies through the storage reverse index — the same truth the lazy tier
    and delete_batch consult."""
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        v = rng.standard_normal(4).astype(np.float32)
        fresh.insert(v, 8888)
        with fresh._lock:
            fresh._id_map.pop(8888, None)  # simulate the lag window
        versions = fresh.delete(8888)
        assert versions and fresh.storage.postings_of(8888) == []


def test_delete_sweeps_stale_mirror_copy_after_lagging_move(tmp_path):
    """A background Reassign moves a copy OUT of a posting; before its
    ``_after_op`` mirror sync lands, delete() resolves the stale map entry,
    loses that round's tombstone (LireStorageError path), and succeeds via
    the storage reverse index.  The pre-move MIRROR copy must not keep
    serving after delete() returns — the threaded stress loop caught
    exactly this state: storage=[] map={src} mirror=[src] with searches
    still returning the vid."""
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        v = rng.standard_normal(4).astype(np.float32)
        fresh.insert(v, 7777)
        src = sorted(fresh._id_map[7777])[0]
        dst = next(p for p in fresh.storage.posting_ids() if p != src)
        ids, _, vers = fresh.storage.get_posting(src)
        ev = int(vers[list(ids).index(7777)])
        # Storage-level move WITHOUT the op callbacks = the lag window.
        moved, _ = fresh.storage.move_vectors(src, dst, [7777], [ev])
        assert list(moved) == [7777]
        fresh.delete(7777)
        assert fresh.storage.postings_of(7777) == []
        assert not fresh._id_map.get(7777)
        ids2, _ = fresh.search(
            v[None, :], k=1, nprobe=fresh.index.num_clusters
        )
        assert int(ids2[0, 0]) != 7777, "deleted vid still serving from mirror"


def test_delete_batch_sweeps_stale_mirror_copy_after_lagging_move(tmp_path):
    """delete_batch form of the stale-mirror sweep: the round-0 stale map
    pid's batch tombstone hits nothing (``continue``), so without the sweep
    the pre-move mirror copy keeps serving after the batch returns."""
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        v = rng.standard_normal(4).astype(np.float32)
        fresh.insert(v, 6666)
        src = sorted(fresh._id_map[6666])[0]
        dst = next(p for p in fresh.storage.posting_ids() if p != src)
        ids, _, vers = fresh.storage.get_posting(src)
        ev = int(vers[list(ids).index(6666)])
        moved, _ = fresh.storage.move_vectors(src, dst, [6666], [ev])
        assert list(moved) == [6666]
        assert fresh.delete_batch([6666]) == 1
        assert fresh.storage.postings_of(6666) == []
        assert not fresh._id_map.get(6666)
        ids2, _ = fresh.search(
            v[None, :], k=1, nprobe=fresh.index.num_clusters
        )
        assert int(ids2[0, 0]) != 6666, "deleted vid still serving from mirror"


# ---------------------------------------------------------------------------
# Both packages, one update sequence
# ---------------------------------------------------------------------------


def _pair_fresh(tmp_path, n=400, dim=8, seed=11):
    """A JAX build, the port's copy of it (from_jax_state), and an
    SpFreshIndex over each with its own store.  max_partition_size sits
    just above the largest posting, so only the hot spot below splits."""
    from spfresh_tpu.index import Config as JConfig

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    raw = {"clustering_params": {"initial_k": 3, "desired_cluster_size": 40, "rng_seed": 42},
           "output_path": str(tmp_path / "idx")}
    jidx = JBuilder(JConfig.from_dict(raw)).with_data(data).build(save=False)
    port = from_jax_state(jidx.postings, jidx.centroids, jidx.dim, jidx.config.to_dict(),
                          device="cpu")
    biggest = max(len(p[0]) for p in jidx.postings.values())
    kw = dict(max_partition_size=biggest + 30, min_partition_size=3)
    jf = JFresh(jidx, str(tmp_path / "jlire"), JLireConfig(**kw))
    tf = SpFreshIndex(port, str(tmp_path / "tlire"), LireConfig(**kw))
    return jf, tf, data, rng


def _assert_same(jf, tf, queries):
    assert sorted(tf.index.postings) == sorted(jf.index.postings)
    for pid in jf.index.postings:
        np.testing.assert_array_equal(np.sort(tf.index.postings[pid][0]),
                                      np.sort(jf.index.postings[pid][0]))
        np.testing.assert_array_equal(tf.index.centroids[pid], jf.index.centroids[pid])
    assert tf.index._next_cluster_id == jf.index._next_cluster_id
    nprobe = jf.index.num_clusters
    want, _ = jf.search(queries, 10, nprobe=nprobe, engine="pallas")
    got, _ = tf.search(queries, 10, nprobe=nprobe)
    np.testing.assert_array_equal(got, want)
    for nprobe in (2, 4):
        want, _ = jf.search(queries, 10, nprobe=nprobe, engine="pallas")
        got, _ = tf.search(queries, 10, nprobe=nprobe)
        np.testing.assert_array_equal(got, want)


def test_update_sequence_equals_jax(tmp_path):
    """Inserts, a hot spot that splits one posting (then a reassign), random
    deletes and deletes that merge one posting away, with flush() after each
    batch so the background order is fixed: both packages end with the same
    postings, centroids and search ids."""
    jf, tf, data, rng = _pair_fresh(tmp_path)
    queries = data[::25] + 0.05
    try:
        def both(fn):
            for f in (jf, tf):
                fn(f)
                f.flush()
            _assert_same(jf, tf, queries)

        spread = rng.standard_normal((40, data.shape[1])).astype(np.float32)
        both(lambda f: f.insert_batch(spread, np.arange(1000, 1040)))

        hot_pid = sorted(jf.index.postings)[0]
        room = jf.lire_config.max_partition_size - len(jf.index.postings[hot_pid][0])
        hot = (jf.index.centroids[hot_pid]
               + 0.01 * rng.standard_normal((room + 10, data.shape[1]))).astype(np.float32)
        clusters = jf.index.num_clusters
        both(lambda f: f.insert_batch(hot, np.arange(2000, 2000 + len(hot))))
        assert jf.index.num_clusters > clusters  # the hot posting split
        assert hot_pid not in tf.index.postings

        kill = [int(x) for x in rng.choice(len(data), size=30, replace=False)]
        both(lambda f: f.delete_batch(kill))

        victim = sorted(jf.index.postings)[1]
        doomed = [int(i) for i in jf.index.postings[victim][0][:-2]]
        clusters = jf.index.num_clusters
        both(lambda f: f.delete_batch(doomed))
        assert victim not in tf.index.postings  # merged away
        assert tf.index.num_clusters < clusters
        dead = set(kill) | set(doomed)
        ids, _ = tf.search(queries, 10, nprobe=tf.index.num_clusters)
        assert not dead & set(ids.ravel().tolist())
    finally:
        jf.close()
        tf.close()


def test_routes_on_the_index_device(tmp_path):
    jf, tf, data, rng = _pair_fresh(tmp_path)
    try:
        v = rng.standard_normal((16, data.shape[1])).astype(np.float32)
        jn, jd = jf._nearest_postings(v)
        tn, td = tf._nearest_postings(v)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)  # expansion form, f32
        assert tf._centroid_cache[2].device == tf.index.device
        assert tf.protocol.device == tf.index.device
    finally:
        jf.close()
        tf.close()


def test_eval_helpers_equal_jax(tmp_path):
    """eval.make_groundtruth, evaluate and nprobe_sweep give the JAX
    package's ground truth and recalls on the same index."""
    from spfresh_tpu import eval as jev
    from spfresh_tpu_torch import eval as tev

    jf, tf, data, rng = _pair_fresh(tmp_path)
    try:
        queries = data[::20] + 0.05
        gt = tev.make_groundtruth(data, queries, 10, device="cpu")
        np.testing.assert_array_equal(gt, jev.make_groundtruth(data, queries, 10))
        got = tev.nprobe_sweep(tf.index, queries, gt, nprobes=(1, 2, 4, 1_000_000))
        want = jev.nprobe_sweep(jf.index, queries, gt, nprobes=(1, 2, 4, 1_000_000))
        assert [(r.recall, r.nprobe, r.k) for r in got] == [(r.recall, r.nprobe, r.k)
                                                           for r in want]
        assert len(got) == 3 and all(r.qps > 0 for r in got)
        one = tev.evaluate(tf.index, queries, gt, k=5, nprobe=tf.index.num_clusters)
        assert one.recall == 1.0 and one.k == 5
    finally:
        jf.close()
        tf.close()
