"""The out-of-core build: the port's nearest-centroid plain version against
the JAX package's Pallas kernel in interpret mode; ``fit_outofcore`` on the
CPU against the JAX package's, given the JAX package's sample-fit seeds
(the two draw KMeans++ seeds from different generators); a memmap corpus;
and an out-of-core index saved by the port searched by the JAX package."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu.clustering import outofcore as jo
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndex as JIndex
from spfresh_tpu.ops.pallas.replica import pallas_nearest_centroid
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.clustering import outofcore as to
from spfresh_tpu_torch.index import Config, SpannIndex, SpannIndexBuilder
from spfresh_tpu_torch.index.spann import _LazyMemberVecs
from spfresh_tpu_torch.ops import replica as trp

torch.set_num_threads(2)

N, SAMPLE, TILE, CAP = 20_000, 4_000, 4_096, 64


def _corpus(seed=0, n=N, d=16, centers=60):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)] + 0.6 * rng.standard_normal((m, d))).astype(
            np.float32)

    return draw(n), draw(50)


def _raw(metric, storage, tmp_path=None):
    raw = {
        "clustering_params": {"distance_metric": metric, "initialization_method": "KMeans++",
                              "initial_k": 8, "desired_cluster_size": CAP, "rng_seed": 42},
        "storage_dtype": storage,
        "build_sample_rows": SAMPLE,
        "build_tile_rows": TILE,
    }
    if tmp_path is not None:
        raw["output_path"] = str(tmp_path / "oc")
    return raw


def _jax_sample_seeds(params, data):
    """The JAX package's KMeans++ seeds for its sample fit: the same sample
    draw and scaled cap as ``fit_outofcore``."""
    n = len(data)
    rng = np.random.Generator(np.random.Philox(key=np.uint64((params.rng_seed ^ 0x0C0FFEE))))
    sidx = np.sort(rng.choice(n, size=SAMPLE, replace=False))
    sp = dataclasses.replace(
        params, desired_cluster_size=max(1, int(round(params.desired_cluster_size * SAMPLE / n))))
    hc = jh.HierarchicalClustering(sp, np.ascontiguousarray(data[sidx]))
    hc._initialize_clusters(sp.initial_k)
    return np.array([c.centroid_idx for c in hc.clusters], np.int64)


@pytest.fixture
def jax_seeded(monkeypatch):
    """Run the port's sample fit from the JAX package's seeds."""
    def use(params, data):
        seeds = _jax_sample_seeds(params, data)
        monkeypatch.setattr(th, "_kmeanspp_init", lambda X, k, metric, rng: seeds)
    monkeypatch.delenv("SPF_REPLICA_ENGINE", raising=False)
    return use


def _assert_same_clusters(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert ca.centroid_idx == cb.centroid_idx
        np.testing.assert_array_equal(ca.points, cb.points)


# ---------------------------------------------------------------------------
# nearest centroid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,C,d", [(300, 37, 19), (700, 600, 96), (129, 1000, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nearest_centroid_plain_matches_pallas_interpret(n, C, d, dtype):
    rng = np.random.default_rng(n + C)
    X = rng.standard_normal((n, d)).astype(np.float32)
    cents = X[rng.integers(0, n, C)] + 0.3 * rng.standard_normal((C, d)).astype(np.float32)
    cents[C // 2] = cents[C // 3]  # an exact duplicate: the lower id must win
    X[:5] = cents[C // 3]          # rows sitting on the duplicated centroid
    if dtype == "bfloat16":
        X, cents = X.astype(ml_dtypes.bfloat16), cents.astype(ml_dtypes.bfloat16)
    wb, wd = pallas_nearest_centroid(jnp.asarray(X), jnp.asarray(cents), interpret=True)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gb, gd = trp.nearest_centroid(torch.from_numpy(np.asarray(X, np.float32)).to(tdt),
                                  torch.from_numpy(np.asarray(cents, np.float32)).to(tdt))
    assert gb.dtype == torch.int32 and gd.dtype == torch.float32
    np.testing.assert_array_equal(gb.numpy()[:5], C // 3)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    # The expansion |c|^2 + |x|^2 - 2 x.c, f32 sums in another order: the
    # error is relative to |x|^2 + |c|^2 ~ 2 d, not to the distance.
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=2 * d * 2e-6)


def test_nearest_centroid_chunks_keep_the_lowest_id(monkeypatch):
    """Equal distances in different chunks go to the earlier chunk."""
    cents = torch.zeros((10, 4))
    cents[[2, 7]] = 1.0
    X = torch.ones((3, 4))
    monkeypatch.setattr(trp, "MIN_CENT_CHUNK", 1)
    for chunk in (3, 4, 10):
        monkeypatch.setattr(trp, "CENT_CHUNK", chunk)
        b, d = trp.chunked_nearest_centroid(X, cents)
        assert b.tolist() == [2, 2, 2] and d.tolist() == [0.0, 0.0, 0.0]


def test_nearest_centroid_rejects_bad_inputs():
    X = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        trp.nearest_centroid(X, X.to(torch.bfloat16))
    with pytest.raises(ValueError, match="no centroids"):
        trp.nearest_centroid(X, X[:0])
    with pytest.raises(ValueError, match="no nearest-centroid kernel for device"):
        trp.nearest_centroid(X.to("meta"), X.to("meta"))


# ---------------------------------------------------------------------------
# fit_outofcore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["Euclidean", "Manhattan"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_fit_outofcore_matches_jax(metric, storage, jax_seeded):
    data, _ = _corpus()
    jp = JConfig.from_dict(_raw(metric, storage)).to_clustering_params()
    tpp = Config.from_dict(_raw(metric, storage)).to_clustering_params()
    jax_seeded(jp, data)
    ref = jo.fit_outofcore(jp, data, SAMPLE, tile_rows=TILE)
    port = to.fit_outofcore(tpp, data, SAMPLE, tile_rows=TILE, device="cpu")
    assert port.sample_rows == ref.sample_rows == SAMPLE
    assert port.num_splits == ref.num_splits > 0  # the host rebalance split clusters
    assert len(port.clusters) > N // CAP  # the sample fit and the rebalance both split
    # The base pass's centroid set: distinct corpus rows, every cluster
    # but the rebalance's new ones (empty clusters are dropped).
    seeds = port.sample_centroid_rows
    assert len(np.unique(seeds)) == len(seeds) >= len(port.clusters) - port.num_splits
    _assert_same_clusters(ref.clusters, port.clusters)
    # Every row has one base posting, inside the budget.
    assert port.base.shape == (N,)
    limit = int(np.ceil(tpp.replica_overflow * CAP))
    for ci, c in enumerate(port.clusters):
        assert len(c) <= limit
        assert np.isin(np.flatnonzero(port.base == ci), c.points).all()
    assert sum(len(c) for c in port.clusters) > N  # replicas were added


def test_memmap_corpus_builds_the_same_clusters(tmp_path):
    data, _ = _corpus(1)
    path = tmp_path / "corpus.f32"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=data.shape)
    mm[:] = data
    mm.flush()
    params = Config.from_dict(_raw("Euclidean", "bfloat16")).to_clustering_params()
    a = to.fit_outofcore(params, data, SAMPLE, tile_rows=TILE, device="cpu")
    ro = np.memmap(path, dtype=np.float32, mode="r", shape=data.shape)
    b = to.fit_outofcore(params, ro, SAMPLE, tile_rows=3000, device="cpu")
    _assert_same_clusters(a.clusters, b.clusters)  # tile size changes nothing either


@pytest.mark.parametrize("metric", ["Euclidean", "Chebyshev"])
def test_outofcore_index_saved_by_port_loads_in_jax(tmp_path, metric):
    data, queries = _corpus(2)
    builder = SpannIndexBuilder(Config.from_dict(_raw(metric, "float32", tmp_path)),
                                device="cpu").with_data(data)
    port = builder.build(save=True)
    assert builder.outofcore.base.shape == (N,)
    assert set(port.build_profile) >= {"oc/sample_fit", "oc/assign", "oc/split", "oc/replica"}
    ids_c, vecs_c = port.postings[0]
    assert isinstance(vecs_c, _LazyMemberVecs)  # postings stay views over the host corpus
    ref = JIndex.load(str(tmp_path / "oc"))
    assert ref.num_vectors == port.num_vectors
    want, _ = ref.search(queries, 10, nprobe=6, engine="xla")
    got, _ = port.search(queries, 10, nprobe=6)
    np.testing.assert_array_equal(got, want)
    back = SpannIndex.load(str(tmp_path / "oc"), device="cpu")
    np.testing.assert_array_equal(back.search(queries, 10, nprobe=6)[0], got)
