"""The disk tier's search: ``spfresh_tpu_torch.index.LazySpannIndex`` and the
JAX package's ``LazySpannIndex`` on one saved packed directory.

Both packages open the same files (written by either), search the same
numpy queries and must return the same ids; distances agree to
``rtol=1e-5`` (the same f32 terms summed in another order; for int8 the
kernel's ``s * code - (q - c)`` against the JAX ``(s * code + c) - q``).
Cases: f32, bf16 and int8 storage; Euclidean, Manhattan and Chebyshev;
stage 1 dense, windowed (past a monkeypatched ``LARGE_C_THRESHOLD``, so the
window scan's plain version runs) and chunked; prefetch 0 and 2; with and
without a live-update overlay; full probe with exact recall 1.0.  Also the
twins of the JAX lazy checks in ``tests/test_index.py``,
``tests/test_outofcore.py`` and ``tests/test_int8_storage.py``."""

import shutil

import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import LazySpannIndex as JLazy
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.lire import PackedLireStorage as JPacked
from spfresh_tpu_torch.eval import recall_at_k
from spfresh_tpu_torch.index import (
    Config,
    LazySpannIndex,
    SpannIndexBuilder,
    brute_force_search,
)
from spfresh_tpu_torch.lire import LireConfig, PackedLireStorage
from spfresh_tpu_torch.ops import centroid_scan, topk
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

RTOL = 1e-5
METRICS = ("Euclidean", "Manhattan", "Chebyshev")
STORAGES = ("float32", "bfloat16", "int8")


def _raw(out, storage="float32", metric="Euclidean", cap=40, **extra):
    return {
        "clustering_params": {"distance_metric": metric, "initial_k": 4,
                              "desired_cluster_size": cap, "rng_seed": 42},
        "output_path": str(out),
        "storage_dtype": storage,
        **extra,
    }


def _data(seed=0, n=600, d=12, nq=40):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _port_dir(tmp_path, storage="float32", metric="Euclidean", seed=0, n=600, d=12, cap=40):
    data, q = _data(seed, n, d)
    cfg = Config.from_dict(_raw(tmp_path / f"port_{storage}_{metric}", storage, metric, cap))
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=True)
    return cfg.output_path, index, data, q


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL)


def _no_dups(ids):
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage", STORAGES)
def test_lazy_ids_equal_jax(tmp_path, storage, metric, prefetch):
    """A port-written packed index opened by both packages' lazy index."""
    d, index, data, q = _port_dir(tmp_path, storage, metric)
    with LazySpannIndex(d, prefetch_threads=prefetch, device="cpu") as tl, JLazy(d) as jl:
        for nprobe in (4, index.num_clusters):
            got = tl.search(q, 10, nprobe=nprobe, batch_size=16)
            _same(got, jl.search(q, 10, nprobe=nprobe, batch_size=16))
            _no_dups(got[0])
        assert tl.last_batches == 3
        assert tl.last_staged_bytes > 0


@pytest.mark.parametrize("metric", METRICS)
def test_lazy_full_probe_recall_exact(tmp_path, metric):
    d, index, data, q = _port_dir(tmp_path, "float32", metric, seed=3)
    _, gt = brute_force_search(data, q, 10, metric=metric, device="cpu")
    with LazySpannIndex(d, device="cpu") as lazy:
        ids, _ = lazy.search(q, 10, nprobe=lazy.num_clusters)
    assert recall_at_k(ids, gt, 10) == 1.0
    _no_dups(ids)


@pytest.mark.parametrize("storage,metric", [("float32", "Euclidean"), ("int8", "Euclidean"),
                                            ("bfloat16", "Manhattan")])
def test_lazy_large_c_stage1_equals_jax(tmp_path, monkeypatch, storage, metric):
    """More clusters than LARGE_C_THRESHOLD (monkeypatched down to 8):
    Euclidean takes the windowed route, whose window scan runs its plain
    version on the CPU, other metrics the chunked route; the JAX package's
    dense stage 1 is exact too, so the ids agree."""
    d, index, data, q = _port_dir(tmp_path, storage, metric, seed=1)
    assert index.num_clusters > 8
    calls = []
    plain = centroid_scan.centroid_window_scan_plain
    monkeypatch.setattr(topk, "LARGE_C_THRESHOLD", 8)
    monkeypatch.setattr(centroid_scan, "centroid_window_scan_plain",
                        lambda *a: calls.append(1) or plain(*a))
    with LazySpannIndex(d, device="cpu") as tl, JLazy(d) as jl:
        for nprobe in (3, 8):
            _same(tl.search(q, 10, nprobe=nprobe), jl.search(q, 10, nprobe=nprobe))
    assert (len(calls) > 0) == (metric == "Euclidean")


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_jax_written_index_opens_in_the_port(tmp_path, storage):
    """The reverse crossing: a JAX-built packed save searched by both."""
    data, q = _data(5)
    cfg = JConfig.from_dict(_raw(tmp_path / "jidx", storage))
    JBuilder(cfg).with_data(data).build(save=True)
    with LazySpannIndex(cfg.output_path, device="cpu") as tl, JLazy(cfg.output_path) as jl:
        for nprobe in (4, tl.num_clusters):
            _same(tl.search(q, 10, nprobe=nprobe), jl.search(q, 10, nprobe=nprobe))


def _mutate(st, rng, round_):
    """One round of overlay traffic through a PackedLireStorage of either
    package: appends, base and overlay tombstones, a split commit and a
    centroid move."""
    pids = sorted(st.posting_ids())
    dim = st.dim
    p0, p1 = pids[0], pids[1]
    add = rng.standard_normal((5, dim)).astype(np.float32)
    base = 9000 + 10 * round_
    st.store_vectors(p0, list(range(base, base + 5)), add)
    st.mark_deleted(p0, base + 1)
    ids1, _, _ = st.get_posting(p1)
    st.mark_deleted_batch(p1, [int(i) for i in ids1[:3]])
    victim = max(pids, key=lambda p: st.get_posting(p)[0].size)
    ids0, vecs0, _ = st.get_posting(victim)
    h = len(ids0) // 2
    n1, n2 = st.allocate_posting_id(), st.allocate_posting_id()
    assert st.atomic_replace(
        [victim], [st.get_posting_version(victim)],
        [(n1, ids0[:h], vecs0[:h], vecs0[:h].mean(axis=0)),
         (n2, ids0[h:], vecs0[h:], vecs0[h:].mean(axis=0))])
    p2 = sorted(st.posting_ids())[2]
    st.update_posting_centroid(p2, st.get_posting_centroid(p2) + np.float32(0.05))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("storage", STORAGES)
def test_lazy_with_overlay_equals_jax(tmp_path, storage, prefetch):
    """The same overlay traffic on each package's PackedLireStorage (each on
    its own copy of one port-written directory); each package's lazy index
    over its overlay, refreshed after each round (the first a full routing
    rebuild, later ones incremental), returns the same results."""
    d, index, data, q = _port_dir(tmp_path, storage, seed=2)
    pd, jd = tmp_path / "p", tmp_path / "j"
    shutil.copytree(d, pd)
    shutil.copytree(d, jd)
    tst, jst = PackedLireStorage(str(pd)), JPacked(str(jd))
    tl = LazySpannIndex(str(pd), overlay=tst, prefetch_threads=prefetch, device="cpu")
    jl = JLazy(str(jd), overlay=jst)
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    metrics.DEFAULT.reset()
    try:
        for round_ in range(3):
            _mutate(tst, rng_t, round_)
            _mutate(jst, rng_j, round_)
            for nprobe in (4, tl.num_clusters):
                got = tl.search(q, 10, nprobe=nprobe)
                _same(got, jl.search(q, 10, nprobe=nprobe))
                _no_dups(got[0])
        assert metrics.snapshot().get("lazy.routing_rows_written", 0) > 0  # incremental ran
    finally:
        tl.close()
        jl.close()
        tst.close()
        jst.close()


def test_lazy_overlay_full_probe_is_exact(tmp_path):
    """Full probe over base + overlay equals brute force over the live set."""
    d, index, data, q = _port_dir(tmp_path, "float32", seed=4)
    st = PackedLireStorage(d)
    rng = np.random.default_rng(9)
    for round_ in range(2):
        _mutate(st, rng, round_)
    live = {}
    for pid in st.posting_ids():
        ids, vecs, _ = st.get_posting(pid)
        for vid, vec in zip(ids, vecs):
            live[int(vid)] = vec
    vids = np.array(sorted(live))
    mat = np.stack([live[int(v)] for v in vids])
    _, gt = brute_force_search(mat, q, 10, device="cpu")
    with LazySpannIndex(d, overlay=st, device="cpu") as lazy:
        ids, _ = lazy.search(q, 10, nprobe=lazy.num_clusters)
    assert recall_at_k(ids, vids[gt], 10) == 1.0
    st.close()


def test_incremental_refresh_is_copy_on_write(tmp_path):
    """A routing snapshot taken before a refresh keeps its device matrix and
    mask: the incremental update builds new tensors, never writes in place."""
    d, index, data, q = _port_dir(tmp_path, "float32", seed=6)
    st = PackedLireStorage(d)
    lazy = LazySpannIndex(d, overlay=st, device="cpu")
    try:
        snap = lazy._routing_snapshot()
        before_c = snap.centroids.clone()
        before_v = snap.cent_valid.clone()
        _mutate(st, np.random.default_rng(1), 0)
        lazy._refresh_overlay()
        after = lazy._routing_snapshot()
        assert after.centroids.shape == snap.centroids.shape  # incremental, not a rebuild
        assert after.centroids.data_ptr() != snap.centroids.data_ptr()
        assert not torch.equal(after.centroids, snap.centroids)
        assert torch.equal(snap.centroids, before_c)
        assert torch.equal(snap.cent_valid, before_v)
        assert not torch.equal(after.cent_valid, snap.cent_valid)
    finally:
        lazy.close()
        st.close()


def test_bf16_lazy_reranks_rounded_queries(tmp_path):
    """bf16 storage: the lazy rerank sees bf16-rounded queries (the JAX lazy
    path's rule, not its padded engine's), so its full-probe distances are
    those of the rounded queries to the rounded rows."""
    d, index, data, q = _port_dir(tmp_path, "bfloat16", seed=8)
    rq = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    rd = torch.from_numpy(data).to(torch.bfloat16).double().numpy()
    with LazySpannIndex(d, device="cpu") as lazy:
        ids, dists = lazy.search(q, 5, nprobe=lazy.num_clusters)
    want = ((rd[ids] - rq[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dists, want, rtol=RTOL)
    exact = ((rd[None, :, :] - rq[:, None, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(ids, np.argsort(exact, axis=1, kind="stable")[:, :5])


def test_lazy_entry_points_default_to_cuda(tmp_path, monkeypatch):
    from spfresh_tpu_torch.lire import LazySpFreshIndex

    d, _, _, _ = _port_dir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LazySpannIndex(d)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LazySpFreshIndex(d, start_pipeline=False)


def test_lazy_rejects_per_cluster_layout(tmp_path):
    data, _ = _data()
    cfg = Config.from_dict(_raw(tmp_path / "pc"))
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=False)
    index.save(cfg.output_path, format="per_cluster")
    with pytest.raises(ValueError, match="packed"):
        LazySpannIndex(cfg.output_path, device="cpu")


# -- twins of the JAX lazy checks ------------------------------------------


def _toy_config(tmp_path, **clustering):
    return Config.from_dict({
        "clustering_params": {"distance_metric": "Euclidean", "initialization_method": "Random",
                              "initial_k": 4, "rng_seed": 42, **clustering},
        "output_path": str(tmp_path / "data"),
    })


def test_lazy_index_matches_resident(tmp_path, rng):
    """Twin of tests/test_index.py::test_lazy_index_matches_resident."""
    data = rng.standard_normal((200, 12)).astype(np.float32)
    cfg = _toy_config(tmp_path, desired_cluster_size=30, initial_k=3)
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=False)
    d = str(tmp_path / "lazy")
    index.save(d, format="packed")
    with LazySpannIndex(d, device="cpu") as lazy:
        q = rng.standard_normal((7, 12)).astype(np.float32)
        nprobe = index.num_clusters
        ids_r, d_r = index.search(q, k=5, nprobe=nprobe)
        ids_l, d_l = lazy.search(q, k=5, nprobe=nprobe)
        np.testing.assert_array_equal(ids_r, ids_l)
        np.testing.assert_allclose(d_r, d_l, rtol=RTOL)


def _oc_corpus(n=12000, d=24, n_centers=40, spread=0.5, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    data = (centers[rng.integers(0, n_centers, n)]
            + spread * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, 100)]
         + spread * rng.standard_normal((100, d))).astype(np.float32)
    return data, q


def _oc_cfg(tmp_path, **kw):
    base = {
        "clustering_params": {"distance_metric": "Euclidean", "initialization_method": "KMeans++",
                              "initial_k": 8, "desired_cluster_size": 250, "rng_seed": 42},
        "output_path": str(tmp_path / "oc_idx"),
        "build_sample_rows": 3000,
        "build_tile_rows": 2048,
    }
    base.update(kw)
    return Config.from_dict(base)


def test_save_load_and_lazy_open(tmp_path):
    """Twin of tests/test_outofcore.py::test_save_load_and_lazy_open."""
    data, q = _oc_corpus()
    cfg = _oc_cfg(tmp_path)
    idx = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=True)
    ids0, _ = idx.search(q, 10, nprobe=8)
    re = SpannIndexBuilder(cfg, device="cpu").load()
    ids1, _ = re.search(q, 10, nprobe=8)
    assert np.array_equal(ids0, ids1)
    with LazySpannIndex(cfg.output_path, cfg, device="cpu") as lazy:
        ids2, _ = lazy.search(q[:32], 10, nprobe=8)
    assert np.array_equal(ids0[:32], ids2)


def test_outofcore_artifact_takes_live_updates(tmp_path):
    """Twin of tests/test_outofcore.py::test_outofcore_artifact_takes_live_updates:
    out-of-core build -> packed save -> LazySpFreshIndex inserts, deletes and
    compaction, with the full-probe oracle at every step."""
    from spfresh_tpu_torch.lire import LazySpFreshIndex

    data, q = _oc_corpus(n=6000)
    cfg = _oc_cfg(tmp_path, build_sample_rows=2000)
    SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=True)
    fresh = LazySpFreshIndex(cfg.output_path, config=cfg, device="cpu")
    try:
        rng = np.random.default_rng(11)
        add = (data[:64] + 0.01 * rng.standard_normal((64, data.shape[1]))).astype(np.float32)
        vids = list(range(500_000, 500_064))
        fresh.insert_batch(add, vids)
        ids, dists = fresh.search(add, k=1, nprobe=fresh.num_clusters)
        assert set(np.asarray(ids)[:, 0].tolist()) == set(vids)
        fresh.delete_batch(vids[:32])
        fresh.flush()
        ids, _ = fresh.search(add[:32], k=3, nprobe=fresh.num_clusters)
        assert not (set(np.asarray(ids).ravel().tolist()) & set(vids[:32]))
        fresh.compact()
        ids, dists = fresh.search(add[32:], k=1, nprobe=fresh.num_clusters)
        assert set(np.asarray(ids)[:, 0].tolist()) == set(vids[32:])
        assert np.allclose(np.asarray(dists)[:, 0], 0.0, atol=1e-4)
    finally:
        fresh.close()


def _int8_corpus(rng, n=4000, dim=24, n_centers=30, spread=0.2):
    centers = 4.0 * rng.standard_normal((n_centers, dim)).astype(np.float32)
    data = (centers[rng.integers(0, n_centers, n)]
            + spread * rng.standard_normal((n, dim))).astype(np.float32)
    return centers, data


def _int8_cfg(tmp_path):
    return Config.from_dict({
        "clustering_params": {"initial_k": 8, "desired_cluster_size": 128, "rng_seed": 42},
        "output_path": str(tmp_path / "int8_idx"),
        "storage_dtype": "int8",
    })


def test_int8_lazy_search(tmp_path, rng):
    """Twin of tests/test_int8_storage.py::test_int8_lazy_search."""
    centers, data = _int8_corpus(rng)
    q = (centers[rng.integers(0, len(centers), 100)]
         + 0.2 * rng.standard_normal((100, data.shape[1]))).astype(np.float32)
    _, gt = brute_force_search(data, q, 10, device="cpu")
    cfg = _int8_cfg(tmp_path)
    SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=True)
    lazy = LazySpannIndex(cfg.output_path, cfg, device="cpu")
    ids, _ = lazy.search(q, 10, nprobe=8)
    rec = recall_at_k(ids, gt, 10)
    assert rec >= 0.94, f"lazy int8 recall {rec}"  # the JAX test's bound
    ids1, d1 = lazy.search(data[:8], 1, nprobe=lazy.num_clusters)
    assert np.array_equal(ids1[:, 0], np.arange(8))
    assert float(np.max(d1)) < 0.05
    with JLazy(cfg.output_path) as jl:
        _same(lazy.search(q, 10, nprobe=8), jl.search(q, 10, nprobe=8))
    lazy.close()


def test_int8_lazy_fresh_disk_updates(tmp_path, rng):
    """Twin of tests/test_int8_storage.py::test_int8_lazy_fresh_disk_updates."""
    from spfresh_tpu_torch.lire import LazySpFreshIndex

    centers, data = _int8_corpus(rng, n=1500)
    cfg = _int8_cfg(tmp_path)
    SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=True)
    lc = LireConfig(max_partition_size=400, min_partition_size=2)
    with LazySpFreshIndex(cfg.output_path, lire_config=lc, device="cpu") as fresh:
        v = (centers[1] + np.float32(0.01)).astype(np.float32)
        fresh.insert(v, 77777)
        ids, d = fresh.search(v[None, :], 1, nprobe=fresh.num_clusters)
        assert int(ids[0, 0]) == 77777
        assert float(d[0, 0]) < 0.05
        fresh.delete(77777)
        ids, _ = fresh.search(v[None, :], 5, nprobe=fresh.num_clusters)
        assert 77777 not in ids[0]
        fresh.compact()  # int8 staging survives a base swap
        ids2, _ = fresh.search(data[:4], 1, nprobe=fresh.num_clusters)
        assert np.array_equal(ids2[:, 0], np.arange(4))


def test_int8_outofcore_build_and_lazy_serve(tmp_path, rng):
    """Twin of tests/test_int8_storage.py::test_int8_outofcore_build_and_lazy_serve."""
    centers, data = _int8_corpus(rng, n=3000)
    cfg = Config.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": 128, "rng_seed": 42},
        "output_path": str(tmp_path / "oc_int8"),
        "storage_dtype": "int8",
        "build_sample_rows": 1000,
        "build_tile_rows": 512,
    })
    SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=True)
    lazy = LazySpannIndex(cfg.output_path, cfg, device="cpu")
    ids, d = lazy.search(data[:8], 1, nprobe=lazy.num_clusters)
    assert np.array_equal(ids[:, 0], np.arange(8))
    assert float(np.max(d)) < 0.05
    lazy.close()


def test_quantize_staged_equals_numpy_expressions():
    """The host int8 staging in torch is bit-equal to the JAX package's
    numpy expressions (``posting_scales_np``, ``quantize_np``), empty and
    all-zero-residual slabs included."""
    from spfresh_tpu_torch.core.dtypes import posting_scales_np, quantize_np
    from spfresh_tpu_torch.index.lazy import quantize_staged

    rng = np.random.default_rng(0)
    U, pad, d = 40, 24, 20
    vecs = (3 * rng.standard_normal((U, pad, d))).astype(np.float32)
    lens = rng.integers(0, pad + 1, U).astype(np.int32)
    lens[:2] = (0, pad)
    vecs[np.arange(pad)[None, :] >= lens[:, None]] = 0
    cents = rng.standard_normal((U, d)).astype(np.float32)
    cents[3] = vecs[3, 0]
    vecs[3, : lens[3]] = cents[3]  # a slab whose residuals are all zero
    res = vecs - cents[:, None, :]
    real = np.arange(pad)[None, :, None] < lens[:, None, None]
    sc = posting_scales_np(np.where(real, np.abs(res), 0.0).max(axis=(1, 2)))
    codes, scales = quantize_staged(torch.from_numpy(vecs), torch.from_numpy(lens),
                                    torch.from_numpy(cents))
    np.testing.assert_array_equal(scales.numpy(), sc)
    np.testing.assert_array_equal(codes.numpy(), quantize_np(res, sc[:, None, None]))


def test_lazy_batch_width_equals_jax(tmp_path):
    """Each batch stages at the width its probed postings need, not at the
    index's pad: after one posting grows far past the base pad and another
    loses most of its base rows, results equal the JAX package's (which
    stages every batch at the pad)."""
    d, index, data, q = _port_dir(tmp_path, "float32", seed=10)
    pd, jd = tmp_path / "p", tmp_path / "j"
    shutil.copytree(d, pd)
    shutil.copytree(d, jd)
    stores = (PackedLireStorage(str(pd)), JPacked(str(jd)))
    rng = np.random.default_rng(3)
    grow = (rng.standard_normal((200, index.dim)) + 3).astype(np.float32)
    for st in stores:
        pids = sorted(st.posting_ids())
        st.store_vectors(pids[0], list(range(50_000, 50_200)), grow)
        ids1, _, _ = st.get_posting(pids[1])
        st.mark_deleted_batch(pids[1], [int(i) for i in ids1[: int(0.8 * len(ids1))]])
        st.store_vector(pids[1], 60_000, grow[0] - 3)
    tl = LazySpannIndex(str(pd), overlay=stores[0], device="cpu")
    jl = JLazy(str(jd), overlay=stores[1])
    try:
        for nprobe in (2, tl.num_clusters):
            _same(tl.search(q, 10, nprobe=nprobe), jl.search(q, 10, nprobe=nprobe))
        assert tl.pad > 200
        # Batches that miss the grown posting stage narrower slabs than the pad.
        widths = []
        stage = tl._stage_async
        tl._stage_async = lambda *a, pad, **kw: widths.append(pad) or stage(*a, pad=pad, **kw)
        got = tl.search(q, 10, nprobe=2, batch_size=4)
        _same(got, jl.search(q, 10, nprobe=2, batch_size=4))
        assert len(widths) == 10 and min(widths) < tl.pad
    finally:
        tl.close()
        jl.close()
        for st in stores:
            st.close()


def test_lazy_pad_cut_equals_jax(tmp_path):
    """A ``pad=`` below the longest posting cuts postings at it in both
    packages alike."""
    d, index, data, q = _port_dir(tmp_path, "float32", seed=11)
    with LazySpannIndex(d, pad=16, device="cpu") as tl, JLazy(d, pad=16) as jl:
        assert tl.pad == 16 and int(tl._lens.max()) > 16
        for nprobe in (3, tl.num_clusters):
            _same(tl.search(q, 10, nprobe=nprobe), jl.search(q, 10, nprobe=nprobe))
