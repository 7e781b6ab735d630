"""The Manhattan and Chebyshev path: the port's unfused closure pass against
the JAX package's (``pairwise_distance`` blocks + ``_replica_select_from_dists``),
and a small build and search of both metrics against the JAX package's: the
port's CPU build given the JAX package's KMeans++ seeds gives the same
clusters, and an index carried over with ``from_jax_state`` returns the
same ids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.index import brute_force_search as j_brute
from spfresh_tpu.ops.distances import pairwise_distance as j_pairwise
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.eval import recall_at_k
from spfresh_tpu_torch.index import Config, SpannIndexBuilder, brute_force_search
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.ops import replica as trp

torch.set_num_threads(2)

METRICS = ("Manhattan", "Chebyshev")


def _mixture(seed, n, nq, d=24, centers=30):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)] + 0.7 * rng.standard_normal((m, d))).astype(
            np.float32)

    return draw(n), draw(nq)


def _raw(metric, storage="float32"):
    return {
        "clustering_params": {"distance_metric": metric, "initialization_method": "KMeans++",
                              "initial_k": 8, "desired_cluster_size": 64, "rng_seed": 5},
        "storage_dtype": storage,
        "search": {"query_batch_size": 64},
    }


# Manhattan: f32 sums of d terms in another order.  Euclidean: the
# expansion's error is relative to |x|^2 + |c|^2 ~ 2 d (eps * 192 ~ 2e-5 per
# rounding at d = 96), not to the distance, as in tests/test_torch_replica.py.
TOL = {"Manhattan": dict(rtol=1e-5, atol=0.0), "Euclidean": dict(rtol=1e-5, atol=5e-4)}


def _assert_same_replicas(ki, kd, wi, wd, metric):
    """Same admitted set and ids; ranks equal for Chebyshev (a maximum is
    order-free) and within ``TOL`` otherwise, where an id may differ only
    at a tie within that tolerance."""
    fin = np.isfinite(wd)
    assert np.array_equal(fin, np.isfinite(kd))
    if metric == "Chebyshev":
        np.testing.assert_array_equal(ki[fin], wi[fin])
        np.testing.assert_array_equal(kd[fin], wd[fin])
        return
    eq = ki[fin] == wi[fin]
    if not eq.all():
        assert np.allclose(kd[fin][~eq], wd[fin][~eq], **TOL[metric])
    np.testing.assert_allclose(kd[fin], wd[fin], **TOL[metric])


@pytest.mark.parametrize("metric", METRICS + ("Euclidean",))
@pytest.mark.parametrize("n,C,d,ne", [(500, 37, 19, 3), (300, 130, 64, 7), (257, 60, 96, 9)])
def test_replica_topk_elementwise_matches_jax_select(metric, n, C, d, ne, monkeypatch):
    rng = np.random.default_rng(n + C)
    X = rng.standard_normal((n, d)).astype(np.float32)
    cents = X[rng.integers(0, n, C)] + 0.1 * rng.standard_normal((C, d)).astype(np.float32)
    base = rng.integers(0, C, n).astype(np.int32)
    bt = 1.3
    D = j_pairwise(jnp.asarray(X), jnp.asarray(cents), metric)
    CC = j_pairwise(jnp.asarray(cents[base]), jnp.asarray(cents), metric)
    wi, wd = jh._replica_select_from_dists(D, CC, jnp.asarray(base), jnp.float32(bt), ne)
    # Row groups of 256 (the floor): the group walk changes nothing.
    monkeypatch.setattr(trp, "PLAIN_TILE_ELEMS", 1)
    ki, kd = trp.replica_topk_elementwise(torch.from_numpy(X), torch.from_numpy(base),
                                          torch.from_numpy(cents), bt, ne, metric)
    _assert_same_replicas(ki.numpy(), kd.numpy(), np.asarray(wi), np.asarray(wd), metric)


def _seeded_port_fit(raw, data, monkeypatch):
    params = JConfig.from_dict(raw).to_clustering_params()
    seeds_hc = jh.HierarchicalClustering(params, data)
    seeds_hc._initialize_clusters(params.initial_k)
    seeds = np.array([c.centroid_idx for c in seeds_hc.clusters], np.int64)
    ref = jh.HierarchicalClustering(params, data).fit()
    monkeypatch.setattr(th, "_kmeanspp_init", lambda X, k, metric, rng: seeds)
    port = th.HierarchicalClustering(Config.from_dict(raw).to_clustering_params(), data,
                                     device="cpu").fit()
    return ref, port


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_build_matches_jax(metric, storage, monkeypatch):
    monkeypatch.delenv("SPF_REPLICA_ENGINE", raising=False)
    data, _ = _mixture(0, 2500, 1)
    ref, port = _seeded_port_fit(_raw(metric, storage), data, monkeypatch)
    assert len(port.clusters) > 30 and sum(len(c) for c in port.clusters) > len(data)
    assert len(ref.clusters) == len(port.clusters)
    for a, b in zip(ref.clusters, port.clusters):
        assert a.centroid_idx == b.centroid_idx
        np.testing.assert_array_equal(a.points, b.points)


@pytest.fixture(scope="module")
def jax_built():
    data, queries = _mixture(1, 3000, 80)
    return data, queries, {m: JBuilder(JConfig.from_dict(_raw(m))).with_data(data).build(
        save=False) for m in METRICS}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nprobe", [4, None])
def test_search_ids_equal_jax(jax_built, metric, nprobe):
    data, queries, jidx = jax_built
    ref = jidx[metric]
    port = from_jax_state(ref.postings, ref.centroids, ref.dim, ref.config.to_dict(),
                          device="cpu")
    npb = nprobe or ref.num_clusters
    want_i, want_d = ref.search(queries, 10, nprobe=npb, engine="xla")
    got_i, got_d = port.search(queries, 10, nprobe=npb)
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)  # f32 summation order
    if nprobe is None:  # full probe: the exact ground truth
        _, gt = brute_force_search(data, queries, 10, metric=metric, device="cpu")
        _, jgt = j_brute(data, queries, 10, metric=metric)
        np.testing.assert_array_equal(gt, jgt)
        assert recall_at_k(got_i, gt, 10) == 1.0


@pytest.mark.parametrize("metric", METRICS)
def test_port_build_full_probe_recall_is_exact(metric):
    data, queries = _mixture(2, 2000, 50)
    idx = SpannIndexBuilder(Config.from_dict(_raw(metric)), device="cpu").with_data(data).build(
        save=False)
    ids, _ = idx.search(queries, 10, nprobe=idx.num_clusters)
    _, gt = brute_force_search(data, queries, 10, metric=metric, device="cpu")
    assert recall_at_k(ids, gt, 10) == 1.0
