"""Multi-device serving on the CPU: the port's ``ShardedSpannIndex`` on
``["cpu"] * 8`` against the JAX package's on its 8-device CPU mesh
(tests/conftest.py), over one index built by the JAX package and carried
into the port with ``from_jax_state``.

Both packages must deal every posting to the same shard and return the
same ids, with distances within rtol 1e-5 (f32 sums in another order), for
f32 (the JAX ``xla`` engine), bf16 and int8 (its slab engine, in interpret
mode), both nprobe modes, with and without pruning, and for Manhattan and
Chebyshev.  The twins of tests/test_parallel.py hold the port to the same
contracts as the JAX package: exact full probe, no id twice in a row,
pruning and global nprobe against the single-device index, live updates
visible."""

import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.parallel import ShardedSpannIndex as JSharded
from spfresh_tpu.parallel import default_mesh
from spfresh_tpu_torch.eval import recall_at_k
from spfresh_tpu_torch.index import brute_force_search
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.parallel import ShardedSpannIndex, default_devices
from spfresh_tpu_torch.parallel import sharded as psharded
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _carry(jidx):
    return from_jax_state(jidx.postings, jidx.centroids, jidx.dim, jidx.config.to_dict(),
                          device="cpu")


def _build(tmp_path, rng, n=400, dim=8, cap=40, **raw):
    """tests/test_parallel.py's index, built by the JAX package, and the
    port's copy of it."""
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = JConfig.from_dict({
        "clustering_params": {"initial_k": 4, "desired_cluster_size": cap, "rng_seed": 42},
        "output_path": str(tmp_path / "idx"),
        **raw,
    })
    jidx = JBuilder(cfg).with_data(data).build(save=False)
    return jidx, _carry(jidx), data


def _recall(ids, gt, k):
    return np.mean([len(set(ids[q]) & set(gt[q])) / k for q in range(len(gt))])


def _assert_same_placement(port_sh, jax_sh):
    """Every posting on the same (shard, row) in both packages."""
    assert port_sh.padded_view().cluster_rows == jax_sh.padded_view().cluster_rows


# -- twins of tests/test_parallel.py ---------------------------------------


def test_sharded_search_matches_full_probe(tmp_path, rng):
    jidx, index, data = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, CPU8)
    queries = rng.standard_normal((16, 8)).astype(np.float32)
    ids_s, d_s = sharded.search(queries, k=10, nprobe=index.num_clusters)
    _, gt = brute_force_search(data, queries, k=10, device="cpu")
    assert recall_at_k(ids_s, gt, 10) == 1.0
    ids_1, d_1 = index.search(queries, k=10, nprobe=index.num_clusters)
    np.testing.assert_allclose(np.sort(d_s, axis=1), np.sort(d_1, axis=1), rtol=1e-5)
    want, _ = JSharded(jidx, default_mesh()).search(queries, k=10, nprobe=jidx.num_clusters)
    np.testing.assert_array_equal(ids_s, want)


def test_sharded_search_partial_probe_reasonable(tmp_path, rng):
    jidx, index, data = _build(tmp_path, rng, n=600, cap=30)
    sharded = ShardedSpannIndex(index, CPU8)
    queries = rng.standard_normal((8, 8)).astype(np.float32)
    ids_s, _ = sharded.search(queries, k=5, nprobe=3)
    _, gt = brute_force_search(data, queries, k=5, device="cpu")
    assert _recall(ids_s, gt, 5) >= 0.7
    want, _ = JSharded(jidx).search(queries, k=5, nprobe=3)
    np.testing.assert_array_equal(ids_s, want)


def test_sharded_dedup_across_shards(tmp_path, rng):
    _, index, data = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, CPU8)
    ids_s, _ = sharded.search(data[:8], k=10, nprobe=index.num_clusters)
    for row in ids_s:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    # Replicas exist, so the merge had duplicates to drop.
    assert index.num_vectors > len(data)


def test_sharded_pruned_search_matches_single_device(tmp_path, rng):
    """Pruning against the GLOBAL nearest-centroid distance: the sharded
    pruned search equals the single-device one."""
    _, index, _ = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, CPU8)
    queries = rng.standard_normal((12, 8)).astype(np.float32)
    ids_s, d_s = sharded.search(queries, k=8, nprobe=index.num_clusters, prune_factor=1.2)
    ids_1, d_1 = index.search(queries, k=8, nprobe=index.num_clusters, prune_factor=1.2)
    np.testing.assert_array_equal(ids_s, ids_1)
    finite = np.isfinite(d_1)
    assert not finite.all(), "pruning left every slot filled: the check is vacuous"
    np.testing.assert_allclose(d_s[finite], d_1[finite], rtol=1e-5)


def test_spfresh_updates_visible_to_sharded_search(tmp_path, rng):
    """SpFresh live updates on the port: the sharded view refreshes by
    generation and keeps matching the single-device search."""
    from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex

    _, index, _ = _build(tmp_path, rng, n=300, cap=50)
    sharded = ShardedSpannIndex(index, CPU8)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    sharded.search(q, k=5, nprobe=index.num_clusters)  # build the view once

    with SpFreshIndex(index, str(tmp_path / "store"),
                      LireConfig(max_partition_size=80, min_partition_size=2)) as fresh:
        new_vecs = rng.standard_normal((40, 8)).astype(np.float32)
        new_ids = np.arange(10_000, 10_040)
        fresh.insert_batch(new_vecs, new_ids)
        fresh.delete_batch(np.arange(0, 10))
        fresh.flush()

        ids_s, _ = sharded.search(q, k=10, nprobe=index.num_clusters)
        ids_1, _ = index.search(q, k=10, nprobe=index.num_clusters)
        for r in range(6):
            assert set(ids_s[r].tolist()) == set(ids_1[r].tolist())
        hit, _ = sharded.search(new_vecs[:4], k=1, nprobe=index.num_clusters)
        assert set(hit[:, 0].tolist()) <= set(new_ids.tolist())
        all_ids, _ = sharded.search(q, k=10, nprobe=index.num_clusters)
        assert not (set(all_ids.ravel().tolist()) & set(range(10)))


def test_global_nprobe_matches_single_chip(tmp_path, rng):
    """nprobe_mode="global" probes the global top-nprobe lists: recall
    parity with the single-device index at the same nprobe (one row of
    slack for a centroid near-tie flipped by another summation shape),
    and exact at full probe."""
    _, index, data = _build(tmp_path, rng, n=600, cap=30)
    sharded = ShardedSpannIndex(index, CPU8)
    queries = rng.standard_normal((24, 8)).astype(np.float32)
    _, gt = brute_force_search(data, queries, k=5, device="cpu")
    for nprobe in (2, 4, 8, index.num_clusters):
        ids_1, _ = index.search(queries, k=5, nprobe=nprobe)
        ids_g, _ = sharded.search(queries, k=5, nprobe=nprobe, nprobe_mode="global")
        r1, rg = _recall(ids_1, gt, 5), _recall(ids_g, gt, 5)
        assert abs(r1 - rg) <= 1.0 / len(queries) + 1e-9, (nprobe, r1, rg)
    ids_g, _ = sharded.search(queries, k=5, nprobe=index.num_clusters, nprobe_mode="global")
    assert _recall(ids_g, gt, 5) == 1.0


def test_per_shard_nprobe_is_superset_of_global(tmp_path, rng):
    _, index, data = _build(tmp_path, rng, n=600, cap=30)
    sharded = ShardedSpannIndex(index, CPU8)
    queries = rng.standard_normal((16, 8)).astype(np.float32)
    _, gt = brute_force_search(data, queries, k=5, device="cpu")
    ids_p, _ = sharded.search(queries, k=5, nprobe=2, nprobe_mode="per_shard")
    ids_g, _ = sharded.search(queries, k=5, nprobe=2, nprobe_mode="global")
    assert _recall(ids_p, gt, 5) >= _recall(ids_g, gt, 5)


# -- cross-package parity ----------------------------------------------------


def _mixture(seed, n=1200, nq=48, d=24, centers=24):
    rng = np.random.default_rng(seed)
    c = 3.0 * rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)] + 0.5 * rng.standard_normal((m, d))).astype(
            np.float32)

    return draw(n), draw(nq)


@pytest.fixture(scope="module")
def parity_indexes(tmp_path_factory):
    """One JAX build per (storage, metric), shared by the parity cases."""
    data, queries = _mixture(3)
    built = {}
    for storage, metric in (("float32", "Euclidean"), ("bfloat16", "Euclidean"),
                            ("int8", "Euclidean"), ("float32", "Manhattan"),
                            ("float32", "Chebyshev")):
        cfg = JConfig.from_dict({
            "clustering_params": {"initial_k": 6, "desired_cluster_size": 48, "rng_seed": 7,
                                  "distance_metric": metric},
            "storage_dtype": storage,
            "output_path": str(tmp_path_factory.mktemp(f"{storage}_{metric}")),
        })
        built[storage, metric] = JBuilder(cfg).with_data(data).build(save=False)
    return queries, built


@pytest.mark.parametrize("prune", [None, 1.2])
@pytest.mark.parametrize("mode", ["per_shard", "global"])
@pytest.mark.parametrize("storage,metric", [
    ("float32", "Euclidean"), ("bfloat16", "Euclidean"), ("int8", "Euclidean"),
    ("float32", "Manhattan"), ("float32", "Chebyshev"),
])
def test_sharded_ids_equal_jax(parity_indexes, storage, metric, mode, prune):
    """The same placement, the same ids, distances within rtol 1e-5.  The
    JAX package's f32 reference is its ``xla`` engine; bf16 and int8 take
    its slab engine (the xla engine reranks bf16 with bf16-rounded queries
    and int8 in reconstructed form, the slab engine as the port does)."""
    queries, built = parity_indexes
    jidx = built[storage, metric]
    engine = "xla" if storage == "float32" else "pallas"
    jsh = JSharded(jidx, default_mesh(), engine=engine)
    psh = ShardedSpannIndex(_carry(jidx), CPU8)
    _assert_same_placement(psh, jsh)
    for nprobe in (3, jidx.num_clusters):
        want_i, want_d = jsh.search(queries, 10, nprobe=nprobe, prune_factor=prune,
                                    nprobe_mode=mode)
        got_i, got_d = psh.search(queries, 10, nprobe=nprobe, prune_factor=prune,
                                  nprobe_mode=mode)
        np.testing.assert_array_equal(got_i, want_i, err_msg=f"nprobe={nprobe}")
        fin = np.isfinite(want_d)
        np.testing.assert_array_equal(np.isfinite(got_d), fin)
        np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)


def test_sharded_deal_matches_jax_with_ties(tmp_path):
    """Postings of equal sizes keep the index's dict order in the deal, and
    equal loads go to the first shard, in both packages (4 shards)."""
    import jax

    rng = np.random.default_rng(11)
    from spfresh_tpu.index import SpannIndex as JIndex

    jidx = JIndex(JConfig.from_dict({}))
    sizes = [5, 3, 5, 5, 2, 3, 5, 1, 3, 2]
    nid = 0
    for m in sizes:
        v = rng.standard_normal((m, 8)).astype(np.float32)
        jidx.add_cluster(v, np.arange(nid, nid + m), v[0])
        nid += m
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("s",))
    jsh = JSharded(jidx, mesh, axis="s", engine="pallas")
    psh = ShardedSpannIndex(_carry(jidx), ["cpu"] * 4)
    _assert_same_placement(psh, jsh)
    jv, pv = jsh.padded_view(), psh.padded_view()
    assert pv.free_rows == jv.free_rows
    assert (pv.pad, pv.d_pad, pv.max_dup, pv.scratch_row) == (
        jv.pad, jv.d_pad, jv.max_dup, jv.scratch_row)


# -- the remaining sharded cases of the JAX suite ----------------------------


def test_sharded_bf16(tmp_path, rng):
    """Twin of tests/test_utils_misc.py::test_sharded_bf16."""
    data = rng.standard_normal((240, 8)).astype(np.float32)
    cfg = JConfig.from_dict({
        "clustering_params": {"initial_k": 3, "desired_cluster_size": 40, "rng_seed": 1},
        "output_path": str(tmp_path / "i"),
        "storage_dtype": "bfloat16",
    })
    jidx = JBuilder(cfg).with_data(data).build(save=False)
    sharded = ShardedSpannIndex(_carry(jidx), CPU8)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    ids, _ = sharded.search(q, k=5, nprobe=jidx.num_clusters)
    _, gt = brute_force_search(data, q, k=5, device="cpu")
    assert _recall(ids, gt, 5) >= 0.8  # bf16 rounding may flip near-ties
    want, _ = JSharded(jidx).search(q, k=5, nprobe=jidx.num_clusters)
    np.testing.assert_array_equal(ids, want)


def _int8_corpus(rng, n=4000, dim=24, n_centers=30, spread=0.2):
    """tests/test_int8_storage.py's corpus."""
    centers = 4.0 * rng.standard_normal((n_centers, dim)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)]
            + spread * rng.standard_normal((n, dim))).astype(np.float32)


def _int8_index(tmp_path, data):
    cfg = JConfig.from_dict({
        "clustering_params": {"initial_k": 8, "desired_cluster_size": 128, "rng_seed": 42},
        "output_path": str(tmp_path / "idx_int8"),
        "storage_dtype": "int8",
    })
    return JBuilder(cfg).with_data(data).build(save=False)


def test_int8_sharded_search(tmp_path, rng):
    """Twin of tests/test_int8_storage.py::test_int8_sharded_search: 4
    shards, global nprobe, every corpus point its own top 1."""
    import jax

    data = _int8_corpus(rng)
    q = data[:32]
    jidx = _int8_index(tmp_path, data)
    sh = ShardedSpannIndex(_carry(jidx), ["cpu"] * 4)
    ids, d = sh.search(q, 1, nprobe=8, nprobe_mode="global")
    assert np.array_equal(ids[:, 0], np.arange(32))
    assert float(np.max(d[:, 0])) < 0.05
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("s",))
    want, _ = JSharded(jidx, mesh, axis="s", engine="xla").search(q, 1, nprobe=8,
                                                                  nprobe_mode="global")
    np.testing.assert_array_equal(ids, want)


def test_int8_sharded_matches_jax_slab_engine(tmp_path, rng):
    """Twin of tests/test_int8_storage.py::test_int8_sharded_pallas_engine:
    the quantized rerank per shard against the JAX package's quantized
    slab kernel under shard_map (interpret mode)."""
    import jax

    data = _int8_corpus(rng, n=2000)
    q = data[:16]
    jidx = _int8_index(tmp_path, data)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("s",))
    ids_j, d_j = JSharded(jidx, mesh, axis="s", engine="pallas").search(
        q, 1, nprobe=8, nprobe_mode="global")
    ids_p, d_p = ShardedSpannIndex(_carry(jidx), ["cpu"] * 4).search(
        q, 1, nprobe=8, nprobe_mode="global")
    np.testing.assert_array_equal(ids_p, ids_j)
    np.testing.assert_allclose(d_p, d_j, rtol=1e-5)
    assert np.array_equal(ids_p[:, 0], np.arange(16))


# -- the port's own surface ----------------------------------------------------


def test_default_devices_need_a_card(tmp_path, rng, monkeypatch):
    """No devices given: every visible CUDA device, in order; where there
    is no card, construction raises (no CPU fallback)."""
    _, index, _ = _build(tmp_path, rng, n=100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        default_devices()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ShardedSpannIndex(index)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ShardedSpannIndex(index, ["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert default_devices() == [torch.device("cuda", i) for i in range(3)]


def test_sharded_rejects_bad_arguments(tmp_path, rng):
    _, index, _ = _build(tmp_path, rng, n=100)
    with pytest.raises(ValueError, match="no devices"):
        ShardedSpannIndex(index, [])
    sharded = ShardedSpannIndex(index, ["cpu"] * 2)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="nprobe_mode"):
        sharded.search(q, 3, nprobe_mode="all")
    with pytest.raises(ValueError, match="query dim"):
        sharded.search(q[:, :4], 3)


def test_sharded_search_counts_engine_and_batches(tmp_path, rng, monkeypatch):
    """The engine that ran is counted once a search; each batch runs stage
    1, the rerank and the local top-k once per shard (here through the
    plain rerank, counted by a wrapper), and batches do not change ids."""
    _, index, _ = _build(tmp_path, rng)
    sharded = ShardedSpannIndex(index, ["cpu"] * 3)
    q = rng.standard_normal((10, 8)).astype(np.float32)
    calls = []
    probe = psharded._probe_candidates

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return probe(*a, **kw)

    monkeypatch.setattr(psharded, "_probe_candidates", counting)
    before = metrics.snapshot().get("search.engine.cpu", 0)
    ids4, d4 = sharded.search(q, 5, nprobe=3, batch_size=4)
    assert metrics.snapshot().get("search.engine.cpu", 0) == before + 1
    assert calls == [4, 4, 4, 4, 4, 4, 2, 2, 2]  # 3 batches x 3 shards
    ids, d = sharded.search(q, 5, nprobe=3)
    np.testing.assert_array_equal(ids4, ids)
    np.testing.assert_array_equal(d4, d)


def test_sharded_large_nprobe_takes_probe_chunks(tmp_path, rng, monkeypatch):
    """Each shard's rerank goes through the single-device probe chunking:
    with the budget cut to two probes a chunk, the ids equal the unchunked
    search's, per_shard and global, with and without pruning."""
    from spfresh_tpu_torch.index import spann

    _, index, _ = _build(tmp_path, rng, n=600, cap=30)
    sharded = ShardedSpannIndex(index, ["cpu"] * 2)
    q = rng.standard_normal((12, 8)).astype(np.float32)
    C = index.num_clusters
    want = {(m, pf): sharded.search(q, 10, nprobe=C, nprobe_mode=m, prune_factor=pf)
            for m in ("per_shard", "global") for pf in (None, 1.2)}
    view = sharded.padded_view()
    blocks = []
    block = spann._probe_block

    def counting(*a, **kw):
        blocks.append(a[2].shape[1])
        return block(*a, **kw)

    monkeypatch.setattr(spann, "PROBE_CHUNK_BYTES", 2 * 12 * view.pad * spann._CAND_BYTES)
    monkeypatch.setattr(spann, "_probe_block", counting)
    for (m, pf), (wi, wd) in want.items():
        gi, gd = sharded.search(q, 10, nprobe=C, nprobe_mode=m, prune_factor=pf)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
    assert max(blocks) == 2 and len(blocks) > 8
