"""The binary split modes (``max_split_ways=2`` and ``replication="nested"``):
the port's ``_split_level_flat``, ``_assign_with_closure`` and whole builds
against the JAX package's on the same seeded inputs, on one device and
over a device list (``["cpu"] * 8`` against the JAX package's 8-device CPU
mesh).  The two packages draw initial seeds from different generators
(jax.random vs numpy Philox), so the builds inject the JAX package's
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.parallel import build as tb

torch.set_num_threads(2)

MODES = {"nested": {"replication": "nested"}, "binary": {"max_split_ways": 2}}


def _data(seed=0, n=1500, d=16, centers=20):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    return (c[rng.integers(0, centers, n)] + 0.6 * rng.standard_normal((n, d))).astype(np.float32)


def _key(hc):
    return [(c.centroid_idx, c.depth, c.points.tolist()) for c in hc.clusters]


@pytest.fixture
def fit_pair(monkeypatch):
    """(JAX fit, port fit) of the same params and data from the JAX
    package's initial seeds; ``mesh`` runs the JAX side on its 8-device
    CPU mesh and the port over ``["cpu"] * 8``."""
    monkeypatch.delenv("SPF_REPLICA_ENGINE", raising=False)

    def fit(data, mesh=False, **kw):
        jp = jh.ClusteringParams(**kw)
        seeder = jh.HierarchicalClustering(jp, data)
        seeder._initialize_clusters(jp.initial_k)
        seeds = np.array([c.centroid_idx for c in seeder.clusters], np.int64)
        monkeypatch.setattr(th, "_kmeanspp_init", lambda X, k, metric, rng: seeds)
        monkeypatch.setattr(th, "_random_init", lambda n, k, rng: seeds)
        monkeypatch.setattr(tb, "kmeanspp_init_sharded", lambda *a: seeds)
        if mesh:
            m = Mesh(np.array(jax.devices("cpu")[:8]), ("shard",))
            ref = jh.HierarchicalClustering(jp, data, mesh=m).fit()
            port = th.HierarchicalClustering(th.ClusteringParams(**kw), data, devices=["cpu"] * 8)
        else:
            ref = jh.HierarchicalClustering(jp, data).fit()
            port = th.HierarchicalClustering(th.ClusteringParams(**kw), data, device="cpu")
        return ref, port.fit()

    return fit


def _flat_inputs(rng, n=600, d=12, segs=(0, 170, 400, 520)):
    X = rng.standard_normal((n, d)).astype(np.float32)
    X[50:60] = X[49]  # duplicates: ties at the farthest-point search
    P = 560
    point_list = rng.permutation(n)[:P].astype(np.int64)
    cluster_of = np.searchsorted(np.asarray(segs[1:]), np.arange(P), side="right")
    c1 = point_list[np.asarray(segs)]
    valid = np.ones(P, bool)
    valid[-7:] = False  # padding entries
    return X, point_list, cluster_of.astype(np.int64), valid, c1


@pytest.mark.parametrize("metric", ["Euclidean", "Manhattan"])
@pytest.mark.parametrize("closure", [True, False])
def test_split_level_flat_matches_jax(rng, metric, closure):
    X, pl, co, valid, c1 = _flat_inputs(rng)
    want = jh._split_level_flat(jnp.asarray(X), jnp.asarray(pl.astype(np.int32)),
                                jnp.asarray(co.astype(np.int32)), jnp.asarray(valid),
                                jnp.asarray(c1.astype(np.int32)), metric, jnp.float32(1.1),
                                closure=closure, num_segments=4)
    got = th._split_level_flat(torch.from_numpy(X), torch.from_numpy(pl), torch.from_numpy(co),
                               torch.from_numpy(valid), torch.from_numpy(c1), metric, 1.1,
                               closure=closure, num_segments=4)
    for name, g, w in zip(("m1", "m2", "c2_idx", "degenerate"), got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-6)
    if closure:  # the closure adds members to a child, never drops them
        assert got[0].sum() + got[1].sum() >= valid.sum()


@pytest.mark.parametrize("metric", ["Euclidean", "Chebyshev"])
def test_assign_with_closure_matches_jax(rng, metric):
    X = rng.standard_normal((300, 10)).astype(np.float32)
    C = X[rng.choice(300, 9, replace=False)]
    want = jh._assign_with_closure(jnp.asarray(X), jnp.asarray(C), metric, jnp.float32(1.1))
    got = th._assign_with_closure(torch.from_numpy(X), torch.from_numpy(C), metric, 1.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(dim=1) >= 1).all() and got.sum() > 300  # every point in one, some in more


@pytest.mark.parametrize("mode,init,wire,metric", [
    ("nested", "KMeans++", None, "Euclidean"),
    ("nested", "Random", "bfloat16", "Euclidean"),
    ("nested", "KMeans++", None, "Manhattan"),
    ("binary", "KMeans++", "bfloat16", "Euclidean"),
    ("binary", "Random", None, "Euclidean"),
    ("binary", "KMeans++", None, "Chebyshev"),
])
def test_same_seeds_same_clusters(fit_pair, mode, init, wire, metric):
    """One device: the port's binary and nested builds equal the JAX
    package's (seeds, members, depths, labels)."""
    data = _data()
    ref, port = fit_pair(data, initialization_method=init, initial_k=6, desired_cluster_size=80,
                         rng_seed=7, wire_dtype=wire, metric=metric, **MODES[mode])
    assert len(port.clusters) > 15 and max(c.depth for c in port.clusters) >= 3
    assert _key(ref) == _key(port)
    np.testing.assert_array_equal(ref.labels(), port.labels())
    if mode == "nested":  # no final replica pass: the timer shows none
        assert not any(n.startswith("fit/replica") for n, _, _ in port._timer.totals())


@pytest.mark.parametrize("mode", ["nested", "binary"])
def test_devices_build_matches_jax_mesh(fit_pair, mode):
    """Over 8 entries (the replicated layout, forced by the binary split)
    the port builds the JAX mesh build's clusters, and the single-device
    build's."""
    data = _data(1, n=1203)
    kw = dict(initialization_method="KMeans++", initial_k=4, desired_cluster_size=70,
              rng_seed=3, **MODES[mode])
    ref, port = fit_pair(data, mesh=True, **kw)
    assert port._corpus_layout == "replicated" and len(port.replicas) == 8
    single = th.HierarchicalClustering(th.ClusteringParams(**kw), data, device="cpu").fit()
    assert _key(ref) == _key(port) == _key(single)


def test_nested_replication_reference_parity(fit_pair, rng):
    """``nested``: the reference's in-split closure; caps hold including
    replicas, every point is placed."""
    data = rng.standard_normal((200, 8)).astype(np.float32)
    ref, port = fit_pair(data, initialization_method="KMeans++", initial_k=2,
                         desired_cluster_size=25, rng_seed=42, replication="nested")
    assert all(len(c) <= 25 for c in port.clusters)
    assert set(np.concatenate([c.points for c in port.clusters]).tolist()) == set(range(200))
    assert sum(len(c) for c in port.clusters) > 200  # closure replicas
    assert _key(ref) == _key(port)


@pytest.mark.parametrize("mode", ["nested", "binary"])
def test_duplicate_points_terminate(fit_pair, mode):
    """An all-identical oversized cluster takes the balanced median split
    instead of looping forever."""
    data = np.ones((32, 4), np.float32)
    ref, port = fit_pair(data, initialization_method="KMeans++", initial_k=1,
                         desired_cluster_size=4, rng_seed=42, **MODES[mode])
    assert all(len(c) <= 4 for c in port.clusters)
    assert set(np.concatenate([c.points for c in port.clusters]).tolist()) == set(range(32))
    assert _key(ref) == _key(port)
