"""Hierarchical clustering: given the JAX package's initial seeds, the
port builds the same clusters (medoid rows and member lists) and the same
labels.  The two packages draw initial seeds from different generators
(jax.random vs numpy Philox), so each test injects the reference's seeds
into the port."""

import numpy as np
import pytest
import torch

from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu.index.config import Config as JConfig
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.index.config import Config as TConfig

torch.set_num_threads(2)


def _data(seed=0, n=3000, d=32, centers=24):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    return (c[rng.integers(0, centers, n)] + 0.6 * rng.standard_normal((n, d))).astype(np.float32)


def _cfg(init, storage, soar):
    return {
        "clustering_params": {"initialization_method": init, "initial_k": 8,
                              "desired_cluster_size": 96, "rng_seed": 11, "soar_lambda": soar},
        "storage_dtype": storage,
    }


def _jax_fit(raw, data, monkeypatch):
    monkeypatch.delenv("SPF_REPLICA_ENGINE", raising=False)
    params = JConfig.from_dict(raw).to_clustering_params()
    seeds_hc = jh.HierarchicalClustering(params, data)
    seeds_hc._initialize_clusters(params.initial_k)
    seeds = np.array([c.centroid_idx for c in seeds_hc.clusters], np.int64)
    return seeds, jh.HierarchicalClustering(params, data).fit()


def _port_fit(raw, data, seeds, monkeypatch):
    monkeypatch.setattr(th, "_kmeanspp_init", lambda X, k, metric, rng: seeds)
    monkeypatch.setattr(th, "_random_init", lambda n, k, rng: seeds)
    params = TConfig.from_dict(raw).to_clustering_params()
    return th.HierarchicalClustering(params, data, device="cpu").fit()


def _assert_same_clusters(a, b):
    assert len(a.clusters) == len(b.clusters)
    for ca, cb in zip(a.clusters, b.clusters):
        assert ca.centroid_idx == cb.centroid_idx
        np.testing.assert_array_equal(ca.points, cb.points)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("init,soar", [("KMeans++", None), ("KMeans++", 0.0), ("Random", None)])
def test_same_seeds_same_clusters(storage, init, soar, monkeypatch):
    data = _data()
    raw = _cfg(init, storage, soar)
    seeds, ref = _jax_fit(raw, data, monkeypatch)
    port = _port_fit(raw, data, seeds, monkeypatch)
    assert len(port.clusters) > 30  # several subdivision levels ran
    assert sum(len(c) for c in port.clusters) > len(data)  # replicas were added
    _assert_same_clusters(ref, port)
    np.testing.assert_array_equal(ref.labels(), port.labels())


def test_device_levels_match_host_levels(monkeypatch):
    """The torch level split (what a CUDA build runs for big levels) gives
    the clusters of the numpy tail path."""
    data = _data(1)
    raw = _cfg("KMeans++", "float32", None)
    params = TConfig.from_dict(raw).to_clustering_params()
    host = th.HierarchicalClustering(params, data, device="cpu").fit()
    monkeypatch.setattr(th, "_tail_rows_for", lambda platform, d: 0)
    dev = th.HierarchicalClustering(params, data, device="cpu").fit()
    assert dev._timer.totals() and any(n == "subdiv/kernel" for n, _, _ in dev._timer.totals())
    _assert_same_clusters(host, dev)


def test_port_seeding_is_deterministic():
    data = _data(2, n=1500)
    params = TConfig.from_dict(_cfg("KMeans++", "float32", None)).to_clustering_params()
    a = th.HierarchicalClustering(params, data, device="cpu").fit()
    b = th.HierarchicalClustering(params, data, device="cpu").fit()
    _assert_same_clusters(a, b)
    labels = a.labels()
    assert labels.shape == (1500,) and labels.min() >= 0 and labels.max() < len(a.clusters)
    members = {p for c in a.clusters for p in c.points.tolist()}
    assert members == set(range(1500))  # every point sits in some cluster


def test_params_validation_matches_reference():
    for kw in ({"initial_k": 0}, {"max_replicas": 0}, {"max_split_ways": 1},
               {"max_split_ways": 129}, {"soar_lambda": -1.0},
               {"metric": "Manhattan", "soar_lambda": 0.5}, {"replication": "x"}):
        with pytest.raises(ValueError):
            jh.ClusteringParams(**kw)
        with pytest.raises(ValueError):
            th.ClusteringParams(**kw)
    assert th.canonical_init("kmeansplusplus") == jh.canonical_init("kmeansplusplus")


def test_manhattan_cpu_build_matches_reference(monkeypatch):
    """L1 builds run the plain closure pass with the L1 metric on the CPU."""
    data = _data(4, n=1200, d=16)
    raw = _cfg("KMeans++", "float32", None)
    raw["clustering_params"]["distance_metric"] = "Manhattan"
    seeds, ref = _jax_fit(raw, data, monkeypatch)
    port = _port_fit(raw, data, seeds, monkeypatch)
    _assert_same_clusters(ref, port)
