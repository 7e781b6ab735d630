"""The build over a list of devices: the port's ``devices=["cpu"] * 8``
paths (``parallel.cluster_step``, ``parallel.build`` and the device-list
branches of ``HierarchicalClustering`` and ``SpannIndexBuilder``) against
the JAX package's mesh build on its 8-device CPU mesh, on the same seeded
inputs.  The two packages draw initial seeds from different generators
(jax.random vs numpy Philox), so the builds inject the JAX package's
single-device seeds (its mesh build draws the same ones); the port's
sharded KMeans++ is held to the port's single-device seeding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.parallel import build as jb
from spfresh_tpu.parallel import cluster_step as jc
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.index import Config, SpannIndex, SpannIndexBuilder, brute_force_search
from spfresh_tpu_torch.index.builder import _resolve_devices
from spfresh_tpu_torch.parallel import build as tb
from spfresh_tpu_torch.parallel import cluster_step as tc
from torch_replica_ties import replica_diff_is_tie

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _mesh(n=8):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("shard",))


def _params(mod, **kw):
    kw.setdefault("metric", "Euclidean")
    kw.setdefault("initialization_method", "KMeans++")
    kw.setdefault("initial_k", 4)
    kw.setdefault("rng_seed", 42)
    kw.setdefault("desired_cluster_size", 32)
    return mod.ClusteringParams(**kw)


def _shards(a, S=8):
    """``a`` cut into S contiguous row blocks (ragged when S does not
    divide its rows)."""
    return list(torch.tensor_split(torch.from_numpy(a), S))


def _key(hc):
    return [(c.centroid_idx, c.depth, c.points.tolist()) for c in hc.clusters]


def _jax_seeds(params, X):
    hc = jh.HierarchicalClustering(params, X)
    hc._initialize_clusters(params.initial_k)
    return np.array([c.centroid_idx for c in hc.clusters], np.int64)


@pytest.fixture
def inject(monkeypatch):
    """Give the port's seeding (single-device and sharded) fixed seeds."""
    def use(seeds):
        monkeypatch.setattr(th, "_kmeanspp_init", lambda X, k, metric, rng: seeds)
        monkeypatch.setattr(th, "_random_init", lambda n, k, rng: seeds)
        monkeypatch.setattr(tb, "kmeanspp_init_sharded",
                            lambda devs, xs, k, metric, n, rng: seeds)
    monkeypatch.delenv("SPF_REPLICA_ENGINE", raising=False)
    return use


def _fit_both(inject, X, layout="sharded", mesh_ref=True, **kw):
    """(JAX mesh or single-device fit, port device-list fit) from the JAX
    package's seeds."""
    jp = _params(jh, **kw)
    inject(_jax_seeds(jp, X))
    ref = (jh.HierarchicalClustering(jp, X, mesh=_mesh(), corpus_layout=layout) if mesh_ref
           else jh.HierarchicalClustering(jp, X)).fit()
    port = th.HierarchicalClustering(_params(th, **kw), X, devices=CPU8,
                                     corpus_layout=layout).fit()
    return ref, port


def _split_inputs(rng, n, P, seg_split):
    X = rng.standard_normal((n, 16)).astype(np.float32)
    flat = rng.permutation(n)[:P].astype(np.int64)
    cluster_of = (np.arange(P) >= seg_split).astype(np.int32)
    S, M = 8, 8
    c1 = np.zeros(S, np.int64)
    c1[0], c1[1] = flat[0], flat[seg_split]
    sv = np.zeros((S, M), bool)
    sv[0, :5] = True
    sv[1, :3] = True
    return X, flat, cluster_of, c1, sv, S, M


def test_sharded_split_level_matches_single_device(rng):
    n = 512
    X, flat, cluster_of, c1, sv, S, M = _split_inputs(rng, n, n, 200)
    a1, s1, c1_, d1 = jh._split_level_multiway(
        jnp.asarray(X), jnp.asarray(flat.astype(np.int32)), jnp.asarray(cluster_of), jnp.int32(n),
        jnp.asarray(c1.astype(np.int32)), jnp.asarray(sv), "Euclidean", num_segments=S,
        m_ways=M)
    mesh = _mesh()
    a2, s2, c2, d2 = jb.sharded_split_level(
        mesh, jc.replicate(mesh, X), flat, cluster_of, np.ones(n, bool), c1, sv, "Euclidean",
        num_segments=S, m_ways=M)
    a3, s3, c3, d3 = tb.sharded_split_level(
        CPU8, [torch.from_numpy(X)] * 8, flat, cluster_of, np.ones(n, bool), c1, sv, "Euclidean",
        num_segments=S, m_ways=M)
    for want in ((a1, s1, c1_, d1), (a2, s2, c2, d2)):
        np.testing.assert_array_equal(s3.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(a3.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(c3.numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(d3.numpy(), np.asarray(want[3]), rtol=1e-6)


def test_rowsharded_split_level_matches_single_device(rng):
    n, P = 509, 400  # uneven n
    X, flat, cluster_of, c1, sv, S, M = _split_inputs(rng, n, P, 150)
    Ppad = 512
    pl = np.zeros(Ppad, np.int32)
    pl[:P] = flat
    co = np.zeros(Ppad, np.int32)
    co[:P] = cluster_of
    a1, s1, c1_, d1 = jh._split_level_multiway(
        jnp.asarray(X), jnp.asarray(pl), jnp.asarray(co), jnp.int32(P),
        jnp.asarray(c1.astype(np.int32)), jnp.asarray(sv), "Euclidean", num_segments=S,
        m_ways=M)
    mesh = _mesh()
    n_pad = -(-n // 8) * 8
    Xp = np.concatenate([X, np.repeat(X[:1], n_pad - n, axis=0)])
    a2, s2, c2, d2 = jb.sharded_split_level_rows(
        mesh, jc.shard_rows(mesh, Xp), flat, cluster_of, c1, sv, "Euclidean",
        num_segments=S, m_ways=M)
    rps = n_pad // 8
    shards = [torch.from_numpy(Xp[s * rps : (s + 1) * rps]) for s in range(8)]
    a3, s3, c3, d3 = tb.sharded_split_level_rows(
        CPU8, shards, flat, cluster_of, c1, sv, "Euclidean", num_segments=S, m_ways=M)
    for a, s, c, d in ((np.asarray(a1)[:P], s1, c1_, np.asarray(d1)[:P]), (a2, s2, c2, d2)):
        np.testing.assert_array_equal(s3, np.asarray(s))
        np.testing.assert_array_equal(a3, a)
        np.testing.assert_array_equal(c3, np.asarray(c))
        np.testing.assert_allclose(d3, d, rtol=1e-6)


def test_sharded_fit_matches_single_device(rng, inject):
    X = rng.standard_normal((400, 16)).astype(np.float32)
    ref, port = _fit_both(inject, X)
    single = th.HierarchicalClustering(_params(th), X, device="cpu").fit()
    assert _key(ref) == _key(port) == _key(single)


def test_sharded_fit_uneven_n(rng, inject):
    """n not divisible by the entry count: padding rows never join a
    cluster or win a medoid."""
    X = rng.standard_normal((403, 8)).astype(np.float32)
    ref, port = _fit_both(inject, X, initial_k=3)
    all_pts = np.concatenate([c.points for c in port.clusters])
    assert set(all_pts.tolist()) == set(range(403))  # every point placed
    assert all(0 <= c.centroid_idx < 403 for c in port.clusters)
    assert _key(ref) == _key(port)


def test_sharded_build_end_to_end_search(rng):
    """Device-list build -> index on the first entry -> full-probe search
    is exact."""
    X = rng.standard_normal((320, 24)).astype(np.float32)
    hc = th.HierarchicalClustering(_params(th, desired_cluster_size=40), X, devices=CPU8).fit()
    index = SpannIndex(Config.from_dict({}), device="cpu")
    index.create_posting_lists(hc.clusters, X)
    q = rng.standard_normal((8, 24)).astype(np.float32)
    ids, _ = index.search(q, k=10, nprobe=index.num_clusters)
    _, gt = brute_force_search(X, q, k=10, device="cpu")
    for r in range(8):
        assert set(ids[r].tolist()) == set(gt[r].tolist())


@pytest.mark.parametrize("metric,n_extra", [("Euclidean", 4), ("Manhattan", 4),
                                            ("Euclidean", 9)])
def test_sharded_replica_pass_matches_single_device(rng, metric, n_extra):
    """The per-shard replica pass returns the single-device pass's rows
    (the replica route for Euclidean up to 8 replicas, the unfused one
    otherwise)."""
    X = rng.standard_normal((64, 6)).astype(np.float32)
    C = rng.standard_normal((11, 6)).astype(np.float32)
    base = rng.integers(0, 11, 64).astype(np.int32)
    idx_s, d_s = tc.sharded_replica_pass(CPU8, _shards(X), _shards(base),
                                         torch.from_numpy(C), metric, 1.3, n_extra)
    idx_s = torch.cat(idx_s).numpy()
    d_s = torch.cat(d_s).numpy()
    route = th.replica_topk if metric == "Euclidean" and n_extra <= 8 else None
    X_t, b_t, C_t = torch.from_numpy(X), torch.from_numpy(base), torch.from_numpy(C)
    if route is None:
        idx_p, d_p = th.replica_topk_elementwise(X_t, b_t, C_t, 1.3, n_extra, metric)
    else:
        idx_p, d_p = route(X_t, b_t, C_t, float(np.float32(1.3)), n_extra)
    idx_1, d_1 = jh._final_replica_pass(jnp.asarray(X), jnp.asarray(base), jnp.asarray(C),
                                        metric, jnp.float32(1.3), n_extra)
    idx_1, d_1 = np.asarray(idx_1), np.asarray(d_1)
    finite = np.isfinite(d_1)
    for idx, d in ((idx_p.numpy(), d_p.numpy()), (idx_1, d_1)):
        assert np.array_equal(finite, np.isfinite(d))
        np.testing.assert_array_equal(idx_s[finite], idx[finite])
        # f32 sums of the expansion in another order: the CPU matmul of the
        # plain version blocks its sums by the row count, and the JAX
        # package sums in its own order.
        np.testing.assert_allclose(d_s[finite], d[finite], rtol=1e-5)


def test_fit_device_levels_match_host_levels(rng, inject, monkeypatch):
    """Every level through the device-list kernels (both layouts) gives
    the clusters of the host tail path and of the JAX package."""
    X = rng.standard_normal((600, 8)).astype(np.float32)
    jp = _params(jh)
    ref = jh.HierarchicalClustering(jp, X).fit()
    inject(_jax_seeds(jp, X))
    host = th.HierarchicalClustering(_params(th), X, device="cpu").fit()
    monkeypatch.setattr(th, "_tail_rows_for", lambda platform, d: 0)
    calls = {"rows": 0, "rep": 0}
    for name, key in (("sharded_split_level_rows", "rows"), ("sharded_split_level", "rep")):
        real = getattr(tb, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tb, name, spy)
    sh = th.HierarchicalClustering(_params(th), X, devices=CPU8).fit()
    rep = th.HierarchicalClustering(_params(th), X, devices=CPU8,
                                    corpus_layout="replicated").fit()
    assert calls["rows"] > 0 and calls["rep"] > 0
    assert _key(ref) == _key(host) == _key(sh) == _key(rep)


def test_sharded_fit_bf16_wire_matches_single_device(rng, inject):
    """The bf16 wire rounds the corpus identically on every path."""
    X = rng.standard_normal((400, 16)).astype(np.float32)
    ref, port = _fit_both(inject, X, wire_dtype="bfloat16")
    assert _key(ref) == _key(port)
    np.testing.assert_array_equal(port._host_data, ref._host_data)
    shards = torch.cat(port.shards).numpy()[:400]
    np.testing.assert_array_equal(shards, ref._host_data)


def _builder_cfg(tmp_path):
    return {"clustering_params": {"initial_k": 4, "desired_cluster_size": 40, "rng_seed": 11,
                                  "initialization_method": "KMeans++"},
            "output_path": str(tmp_path / "idx")}


@pytest.mark.parametrize("layout", ["sharded", "replicated"])
def test_builder_facade_devices_build_matches_single_device(rng, tmp_path, inject, layout):
    """SpannIndexBuilder(cfg, devices=...) builds the index of the
    single-device builder and of the JAX package's mesh builder; the
    replicated layout hands its first copy to the view pack."""
    X = rng.standard_normal((500, 24)).astype(np.float32)
    cfg = _builder_cfg(tmp_path)
    inject(_jax_seeds(JConfig.from_dict(cfg).to_clustering_params(), X))
    ref = JBuilder(JConfig.from_dict(cfg), mesh=_mesh(), corpus_layout=layout).with_data(X)
    ref = ref.build(save=False)
    one = SpannIndexBuilder(Config.from_dict(cfg), device="cpu").with_data(X).build(save=False)
    builder = SpannIndexBuilder(Config.from_dict(cfg), devices=CPU8, corpus_layout=layout)
    many = builder.with_data(X).build(save=False)
    assert many.device == torch.device("cpu")
    assert (many._corpus_cache is not None) == (layout == "replicated")
    for idx in (ref, one):
        assert sorted(idx.postings) == sorted(many.postings)
        for c in many.postings:
            np.testing.assert_array_equal(idx.postings[c][0], many.postings[c][0])
            np.testing.assert_array_equal(np.asarray(idx.postings[c][1]),
                                          np.asarray(many.postings[c][1]))
            np.testing.assert_array_equal(idx.centroids[c], many.centroids[c])
    q = rng.standard_normal((6, 24)).astype(np.float32)
    i1, d1 = one.search(q, k=5, nprobe=one.num_clusters)
    i2, d2 = many.search(q, k=5, nprobe=many.num_clusters)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_builder_devices_resolution():
    """None and 'auto' (no card here) mean one device; a list passes
    through, repeats allowed; one entry is the single-device path on it;
    more CUDA devices than exist raise."""
    assert _resolve_devices(None) is None
    assert _resolve_devices("auto") is None
    assert _resolve_devices(["cpu"] * 4) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError):
        _resolve_devices(1000)
    with pytest.raises(ValueError):
        _resolve_devices("all")
    with pytest.raises(ValueError):
        _resolve_devices([])
    one = SpannIndexBuilder(Config.from_dict({}), devices=["cpu"])
    assert one.devices is None and one.device == torch.device("cpu")
    many = SpannIndexBuilder(Config.from_dict({}), devices=["cpu"] * 2)
    assert many.devices == [torch.device("cpu")] * 2 and many.device == torch.device("cpu")
    with pytest.raises(ValueError):
        SpannIndexBuilder(Config.from_dict({}), devices=CPU8, corpus_layout="striped")


def test_rowsharded_corpus_memory_and_equality(rng, inject):
    """The default layout keeps n/S rows an entry, no full copy, and still
    builds the JAX mesh build's clusters."""
    n, d = 403, 16  # uneven n: the last shard is padded with row 0
    X = rng.standard_normal((n, d)).astype(np.float32)
    ref, port = _fit_both(inject, X, initial_k=3)
    assert port._corpus_layout == "sharded" and port.data is None
    assert [tuple(x.shape) for x in port.shards] == [(51, d)] * 8
    np.testing.assert_array_equal(port.shards[-1].numpy()[-5:], np.repeat(X[:1], 5, axis=0))
    assert _key(ref) == _key(port)


def test_replicated_corpus_layout_still_matches(rng, inject):
    X = rng.standard_normal((400, 16)).astype(np.float32)
    ref, port = _fit_both(inject, X, layout="replicated")
    assert port._corpus_layout == "replicated" and len(port.replicas) == 8
    sharded = th.HierarchicalClustering(_params(th), X, devices=CPU8).fit()
    assert _key(ref) == _key(port) == _key(sharded)


def test_kmeanspp_sharded_matches_single_device(rng):
    """The sharded KMeans++ draws the port's single-device seeds draw for
    draw (same f64 weights, same generator); padding rows are never
    drawn."""
    n, d, k = 203, 12, 7
    X = rng.standard_normal((n, d)).astype(np.float32)
    gen = lambda: np.random.Generator(np.random.Philox(key=np.uint64(99)))  # noqa: E731
    single = th._kmeanspp_init(torch.from_numpy(X), k, "Euclidean", gen())
    n_pad = -(-n // 8) * 8
    Xp = np.concatenate([X, np.repeat(X[:1], n_pad - n, axis=0)])
    shards = [torch.from_numpy(b) for b in np.split(Xp, 8)]
    sharded = tb.kmeanspp_init_sharded(CPU8, shards, k, "Euclidean", n, gen())
    np.testing.assert_array_equal(single, sharded)
    assert (sharded < n).all() and len(set(sharded.tolist())) == k


def test_sharded_layout_never_holds_full_corpus(rng, monkeypatch):
    """Through a whole sharded-layout build no tensor of the corpus's rows
    is made from a host array: only row blocks, centroid-sized and
    member-table arrays."""
    n, d = 480, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    shapes = []
    real = torch.from_numpy

    def spy(a):
        shapes.append(a.shape)
        return real(a)

    monkeypatch.setattr(torch, "from_numpy", spy)
    monkeypatch.setattr(th, "_tail_rows_for", lambda platform, d: 0)
    hc = th.HierarchicalClustering(_params(th, desired_cluster_size=30), X, devices=CPU8).fit()
    assert hc._corpus_layout == "sharded" and hc.data is None
    wide = [s for s in shapes if len(s) == 2 and s[1] == d]
    assert wide and max(s[0] for s in wide) < n, shapes
    assert sum(len(c) for c in hc.clusters) >= n


@pytest.mark.parametrize("closure", [True, False])
def test_sharded_cluster_step_matches_single_device(rng, closure):
    n, d, k = 256, 16, 8
    X = rng.standard_normal((n, d)).astype(np.float32)
    cent_idx = rng.choice(n, k, replace=False)
    mesh = _mesh()
    mask_j, cents_j = jc.sharded_cluster_step(mesh, jc.shard_rows(mesh, X),
                                              jc.replicate(mesh, X[cent_idx]), closure=closure)
    masks, cents_t, rows = tc.sharded_cluster_step(CPU8, _shards(X),
                                                   torch.from_numpy(X[cent_idx]),
                                                   closure=closure)
    mask_t = torch.cat(masks).numpy()
    np.testing.assert_array_equal(mask_t, np.asarray(mask_j))
    if closure:
        mask_1 = jh._assign_with_closure(jnp.asarray(X), jnp.asarray(X[cent_idx]), "Euclidean",
                                         jnp.float32(1.1))
        np.testing.assert_array_equal(mask_t, np.asarray(mask_1))
        np.testing.assert_array_equal(
            mask_t, th._assign_with_closure(torch.from_numpy(X), torch.from_numpy(X[cent_idx]),
                                            "Euclidean", 1.1).numpy())
    new_1 = th._medoid_update(torch.from_numpy(X), torch.from_numpy(mask_t),
                              torch.from_numpy(cent_idx), "Euclidean").numpy()
    np.testing.assert_array_equal(rows.numpy(), new_1)
    np.testing.assert_array_equal(cents_t.numpy(), X[new_1])
    np.testing.assert_allclose(cents_t.numpy(), np.asarray(cents_j), rtol=1e-6)


def test_sharded_cluster_step_rejects_ragged(rng):
    C = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    with pytest.raises(ValueError):
        tc.sharded_cluster_step(CPU8, _shards(rng.standard_normal((250, 4)).astype(np.float32)),
                                C)
    shards = [torch.zeros((32, 4))] * 7 + [torch.zeros((31, 4))]
    with pytest.raises(ValueError, match="ragged"):
        tc.sharded_cluster_step(CPU8, shards, C)


def test_manhattan_devices_build_matches_jax(rng, inject, monkeypatch):
    """A Manhattan build over the device list, every level on the sharded
    split: the L1 assign, split and replica pass give the JAX mesh
    build's clusters."""
    centers = rng.standard_normal((6, 12)).astype(np.float32)
    X = (centers[rng.integers(0, 6, 700)] + 0.4 * rng.standard_normal((700, 12)))
    X = X.astype(np.float32)
    monkeypatch.setattr(jh, "_HOST_SPLIT_MAX_P", 0)
    monkeypatch.setattr(th, "_tail_rows_for", lambda platform, d: 0)
    ref, port = _fit_both(inject, X, metric="Manhattan", desired_cluster_size=40)
    assert len(port.clusters) > 20 and sum(len(c) for c in port.clusters) > 700
    assert _key(ref) == _key(port)


def _random_corpus(rng):
    """tests/test_mesh_build_fuzz.py's generator."""
    dim = int(rng.integers(4, 24))
    n = int(rng.integers(900, 2600))
    k_true = int(rng.integers(2, 9))
    centers = 3.0 * rng.standard_normal((k_true, dim)).astype(np.float32)
    noise = float(rng.uniform(0.05, 0.8))
    data = (centers[rng.integers(0, k_true, n)] + noise * rng.standard_normal((n, dim)))
    data = data.astype(np.float32)
    dup_frac = float(rng.uniform(0.0, 0.5))
    ndup = int(n * dup_frac)
    if ndup > 8:
        n_src = int(rng.integers(1, 4))
        src = rng.standard_normal((n_src, dim)).astype(np.float32)
        data[-ndup:] = src[rng.integers(0, n_src, ndup)]
        data = data[rng.permutation(n)]
    return data


# Seeds whose replica pass sits on f32 near-ties (duplicate blocks, or two
# centroids of equal rank at the replica cut): there the replica pass may
# differ from the JAX package's, each difference witnessed in f64.
FUZZ_TIE_SEEDS = (0, 1)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_devices_build_matches_jax(monkeypatch, inject, seed):
    """Seeds of the JAX mesh fuzz's generator (duplicate blocks, every
    metric and split arity) through the port's upload path over 8 entries:
    both layouts build the port's single-device clusters; the clusters
    before the replica pass are the JAX package's, and so are the final
    ones, but for replicas at f32 near-ties on FUZZ_TIE_SEEDS, each shown
    to be a tie in f64 (ROADMAP queue 3)."""
    rng = np.random.default_rng(77_000 + seed)
    data = _random_corpus(rng)
    kw = dict(metric=str(rng.choice(["Euclidean", "Manhattan", "Chebyshev"])),
              initialization_method=str(rng.choice(["Random", "KMeans++"])),
              initial_k=int(rng.integers(2, 7)), desired_cluster_size=int(rng.integers(20, 90)),
              max_split_ways=int(rng.choice([2, 4, 8])), rng_seed=int(rng.integers(0, 1_000_000)))
    jp = jh.ClusteringParams(**kw)
    inject(_jax_seeds(jp, data))
    tail = int(rng.choice([0, 200, 800]))
    monkeypatch.setattr(th, "_tail_rows_for", lambda platform, d: tail)
    single = th.HierarchicalClustering(th.ClusteringParams(**kw), data, device="cpu").fit()
    for layout in ("sharded", "replicated"):
        port = th.HierarchicalClustering(th.ClusteringParams(**kw), data, devices=CPU8,
                                         corpus_layout=layout).fit()
        assert _key(single) == _key(port), (seed, layout, kw)
    pre = {}
    for name, mod in (("ref", jh), ("port", th)):
        finalize = mod.HierarchicalClustering._finalize_replication

        def spy(self, finalize=finalize, name=name):  # records, then runs the pass
            pre[name] = [(c.centroid_idx, c.depth, c.points.tolist()) for c in self.clusters]
            finalize(self)

        monkeypatch.setattr(mod.HierarchicalClustering, "_finalize_replication", spy)
    ref = jh.HierarchicalClustering(jp, data).fit()
    port = th.HierarchicalClustering(th.ClusteringParams(**kw), data, devices=CPU8).fit()
    assert pre["ref"] == pre["port"], (seed, kw)
    if seed not in FUZZ_TIE_SEEDS:
        assert _key(ref) == _key(port), (seed, kw)
        return
    assert kw["metric"] == "Euclidean", kw  # the witness is the expansion's
    assert [c.centroid_idx for c in ref.clusters] == [c.centroid_idx for c in port.clusters]
    replica_diff_is_tie(data, [pts for _, _, pts in pre["ref"]], ref, port,
                         float(np.float32(jp.boundary_threshold)))
