"""The out-of-core build over a list of devices: the streamed base and
replica passes deal their tiles round-robin over the entries, and the
result is the single-device out-of-core build's and the JAX package's
(its mesh build on 4 CPU devices), given the JAX package's sample-fit
seeds (the two packages draw KMeans++ seeds from different generators)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.clustering import outofcore as to
from spfresh_tpu_torch.core.dtypes import bf16_round_np
from spfresh_tpu_torch.eval import recall_at_k
from spfresh_tpu_torch.index import Config, SpannIndexBuilder, brute_force_search

torch.set_num_threads(2)

SAMPLE, TILE = 3000, 2048


def _corpus(n=9000, d=24, n_centers=40, spread=0.5, seed=7):
    """tests/test_outofcore.py's corpus."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    data = (centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal((n, d)))
    q = centers[rng.integers(0, n_centers, 100)] + spread * rng.standard_normal((100, d))
    return data.astype(np.float32), q.astype(np.float32)


def _raw(tmp_path, metric="Euclidean", storage="float32", name="oc"):
    return {
        "clustering_params": {"distance_metric": metric, "initialization_method": "KMeans++",
                              "initial_k": 8, "desired_cluster_size": 250, "rng_seed": 42},
        "output_path": str(tmp_path / name),
        "storage_dtype": storage,
        "build_sample_rows": SAMPLE,
        "build_tile_rows": TILE,
    }


@pytest.fixture
def jax_seeded(monkeypatch):
    """Run the port's sample fit from the JAX package's KMeans++ seeds: the
    same sample draw and scaled cap as ``fit_outofcore``."""
    def use(params, data):
        n = len(data)
        rng = np.random.Generator(np.random.Philox(key=np.uint64(params.rng_seed ^ 0x0C0FFEE)))
        sidx = np.sort(rng.choice(n, size=SAMPLE, replace=False))
        sp = dataclasses.replace(params, desired_cluster_size=max(
            1, int(round(params.desired_cluster_size * SAMPLE / n))))
        hc = jh.HierarchicalClustering(sp, np.ascontiguousarray(data[sidx]))
        hc._initialize_clusters(sp.initial_k)
        seeds = np.array([c.centroid_idx for c in hc.clusters], np.int64)
        monkeypatch.setattr(th, "_kmeanspp_init", lambda X, k, metric, rng: seeds)
    monkeypatch.delenv("SPF_REPLICA_ENGINE", raising=False)
    return use


def _same_index(a, b):
    assert sorted(a.postings) == sorted(b.postings)
    for c in a.postings:
        np.testing.assert_array_equal(a.postings[c][0], b.postings[c][0])
        np.testing.assert_array_equal(a.centroids[c], b.centroids[c])


@pytest.mark.parametrize("metric,storage", [("Euclidean", "float32"), ("Manhattan", "bfloat16")])
def test_devices_outofcore_build_identical(tmp_path, jax_seeded, metric, storage):
    """Tiles dealt over 4 entries: the same postings and centroids as one
    device and as the JAX package's 4-device mesh build; full-probe recall
    stays 1.0 (against the stored grid: bf16 storage rounds the vectors)."""
    data, q = _corpus()
    raw = _raw(tmp_path, metric, storage)
    jax_seeded(JConfig.from_dict(raw).to_clustering_params(), data)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("shard",))
    ref = JBuilder(JConfig.from_dict(raw), mesh=mesh).with_data(data).build(save=False)
    one = SpannIndexBuilder(Config.from_dict(raw), device="cpu").with_data(data).build(save=False)
    builder = SpannIndexBuilder(Config.from_dict(raw), devices=["cpu"] * 4)
    many = builder.with_data(data).build(save=False)
    assert builder.outofcore is not None and many.device == torch.device("cpu")
    _same_index(one, many)
    _same_index(ref, many)
    stored = bf16_round_np(data) if storage == "bfloat16" else data
    _, gt = brute_force_search(stored, q, 10, metric=metric, device="cpu")
    ids, _ = many.search(q, 10, nprobe=many.num_clusters)
    assert recall_at_k(ids, gt, 10) == 1.0


@pytest.mark.parametrize("metric,storage,entries", [("Euclidean", "bfloat16", 3),
                                                    ("Manhattan", "float32", 4)])
def test_fit_outofcore_devices_match_one_device(tmp_path, metric, storage, entries, monkeypatch):
    """``fit_outofcore(devices=...)``: the base assignment, the rebalance
    and every cluster equal the one-device fit's, with a tile count no
    entry count divides (5 tiles) and a window of max(4, 2 x entries)
    tiles in flight; each streamed pass reads every tile back once, in
    order."""
    data, _ = _corpus()
    params = Config.from_dict(_raw(tmp_path, metric, storage)).to_clustering_params()
    one = to.fit_outofcore(params, data, SAMPLE, tile_rows=TILE, device="cpu")
    staged = []
    real = to._stage_tile
    monkeypatch.setattr(to, "_stage_tile", lambda d, s, e, *a: (staged.append(s), real(d, s, e, *a))[1])
    many = to.fit_outofcore(params, data, SAMPLE, tile_rows=TILE, devices=["cpu"] * entries)
    starts = list(range(0, len(data), TILE))
    assert staged == starts + starts  # base pass, then replica pass
    assert to._window([torch.device("cpu")] * entries) == max(4, 2 * entries)
    np.testing.assert_array_equal(one.base, many.base)
    np.testing.assert_array_equal(one.sample_centroid_rows, many.sample_centroid_rows)
    assert one.num_splits == many.num_splits
    assert len(one.clusters) == len(many.clusters)
    for a, b in zip(one.clusters, many.clusters):
        assert a.centroid_idx == b.centroid_idx
        np.testing.assert_array_equal(a.points, b.points)
