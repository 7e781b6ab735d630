"""The slice as a whole: an index built by the JAX package, carried into
the port with ``interop.from_jax_state`` or through a saved directory,
returns the same ids from the port's search as from the reference's; the
port's own builds keep the SPANN invariants (full-probe recall exactly 1.0,
no id twice in a row); configs and saved indexes cross both ways."""

import os

import numpy as np
import pytest
import torch

from spfresh_tpu.eval import recall_at_k as j_recall
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndex as JIndex
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.index import brute_force_search as j_brute
from spfresh_tpu_torch.eval import recall_at_k
from spfresh_tpu_torch.index import Config, SpannIndex, SpannIndexBuilder, brute_force_search
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixture(seed, n, nq, d=24, centers=30):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)] + 0.7 * rng.standard_normal((m, d))).astype(
            np.float32)

    return draw(n), draw(nq)


def _raw(tmp_path, storage="float32", **search):
    return {
        "clustering_params": {"initialization_method": "KMeans++", "initial_k": 8,
                              "desired_cluster_size": 64, "rng_seed": 5},
        "storage_dtype": storage,
        "output_path": str(tmp_path / "idx"),
        "search": {"query_batch_size": 64, **search},
    }


def _no_dups(ids):
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    data, queries = _mixture(0, 2000, 100)
    jidx = {}
    for storage in ("float32", "bfloat16"):
        cfg = JConfig.from_dict(_raw(tmp_path_factory.mktemp(storage), storage))
        jidx[storage] = JBuilder(cfg).with_data(data).build(save=False)
    return data, queries, jidx


def _carry(jidx):
    return from_jax_state(jidx.postings, jidx.centroids, jidx.dim, jidx.config.to_dict(),
                          device="cpu")


@pytest.mark.parametrize("nprobe", [3, 8, None])
@pytest.mark.parametrize("prune", [None, 1.2])
def test_search_ids_equal_jax_xla_engine(jax_built, nprobe, prune):
    data, queries, jidx = jax_built
    ref = jidx["float32"]
    port = _carry(ref)
    npb = nprobe or ref.num_clusters
    want_i, want_d = ref.search(queries, 10, nprobe=npb, prune_factor=prune, engine="xla")
    got_i, got_d = port.search(queries, 10, nprobe=npb, prune_factor=prune)
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    # Exact (elementwise) rerank distances: f32 sums of d = 24 terms in
    # another order.
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)
    _no_dups(got_i)


def test_bf16_search_ids_equal_jax_padded_engine(jax_built):
    """bf16 storage: the port's pipeline is the reference's padded one (f32
    queries in the rerank), whose JAX form runs here in interpret mode."""
    data, queries, jidx = jax_built
    ref = jidx["bfloat16"]
    port = _carry(ref)
    want_i, _ = ref.search(queries[:12], 10, nprobe=4, engine="pallas")
    got_i, _ = port.search(queries[:12], 10, nprobe=4)
    np.testing.assert_array_equal(got_i, want_i)


def test_full_probe_recall_is_exact(jax_built):
    data, queries, jidx = jax_built
    port = _carry(jidx["float32"])
    _, gt = brute_force_search(data, queries, 10, device="cpu")
    _, jgt = j_brute(data, queries, 10)
    np.testing.assert_array_equal(gt, jgt)
    ids, _ = port.search(queries, 10, nprobe=port.num_clusters)
    assert recall_at_k(ids, gt, 10) == 1.0
    assert recall_at_k(ids, gt, 10) == j_recall(ids, gt, 10)
    _no_dups(ids)


def test_two_stage_brute_force_matches_jax():
    data, queries = _mixture(1, 12_000, 20, d=16)
    gd, gi = brute_force_search(data, queries, 5, device="cpu")
    wd, wi = j_brute(data, queries, 5)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5)  # exact form, f32 summation order


@pytest.mark.parametrize("layout", ["packed", "per_cluster"])
def test_jax_saved_index_loads_in_port(jax_built, tmp_path, layout):
    data, queries, jidx = jax_built
    ref = jidx["float32"]
    ref.save(str(tmp_path / "j"), format=layout)
    port = SpannIndex.load(str(tmp_path / "j"), device="cpu")
    assert port.num_clusters == ref.num_clusters and port.num_vectors == ref.num_vectors
    want, _ = ref.search(queries, 10, nprobe=6, engine="xla")
    got, _ = port.search(queries, 10, nprobe=6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["packed", "per_cluster"])
def test_port_saved_index_loads_in_jax(tmp_path, layout):
    data, queries = _mixture(2, 1500, 50)
    port = SpannIndexBuilder(Config.from_dict(_raw(tmp_path)), device="cpu").with_data(
        data).build(save=False)
    port.save(str(tmp_path / "t"), format=layout)
    ref = JIndex.load(str(tmp_path / "t"))
    assert sorted(ref.postings) == sorted(port.postings)
    for cid, (ids, vecs) in port.postings.items():
        np.testing.assert_array_equal(ref.postings[cid][0], ids)
        np.testing.assert_array_equal(np.asarray(ref.postings[cid][1]), np.asarray(vecs))
    want, _ = ref.search(queries, 10, nprobe=5, engine="xla")
    got, _ = port.search(queries, 10, nprobe=5)
    np.testing.assert_array_equal(got, want)
    back = SpannIndex.load(str(tmp_path / "t"), device="cpu")
    got2, _ = back.search(queries, 10, nprobe=5)
    np.testing.assert_array_equal(got2, got)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_port_build_invariants(tmp_path, storage):
    data, queries = _mixture(3, 2500, 60)
    metrics.DEFAULT.reset()
    idx = SpannIndexBuilder(Config.from_dict(_raw(tmp_path, storage)), device="cpu").with_data(
        data).build(save=True)
    assert os.path.exists(tmp_path / "idx" / "manifest.json")
    assert idx.num_vectors > len(data)
    assert set(idx.build_profile) >= {"fit/init", "fit/subdivide", "fit/replica_pass"}
    view = idx.padded_view()
    assert view.vectors3d.dtype == (torch.bfloat16 if storage == "bfloat16" else torch.float32)
    assert view.d_pad == 128 and view.pad % 16 == 0
    ids, d = idx.search(queries, 10, nprobe=idx.num_clusters)
    _, gt = brute_force_search(data, queries, 10, device="cpu")
    rec = recall_at_k(ids, gt, 10)
    if storage == "float32":
        assert rec == 1.0
    else:
        assert rec > 0.97  # bf16-rounded vectors vs f32 ground truth
    assert np.all(np.diff(d, axis=1)[np.isfinite(d[:, 1:])] >= 0)
    _no_dups(ids)
    snap = metrics.snapshot()
    assert snap["build.replica_engine.cpu"] == 1 and snap["search.engine.cpu"] == 1


def test_readme_toy_example(tmp_path):
    cfg = Config.from_file(os.path.join(REPO, "examples", "example_config.yaml"))
    cfg.rng_seed = 42
    cfg.output_path = str(tmp_path / "toy")
    data = np.array([[1.0, 2.0], [1.5, 2.5], [8.0, 8.0], [8.5, 8.5], [4.0, 4.0], [4.5, 4.5]],
                    dtype=np.float32)
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(dim=2)
    result = index.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)
    assert result[0].point_id == 0
    np.testing.assert_array_equal(result[0].vector, data[0])
    loaded = SpannIndexBuilder(cfg, device="cpu").load(dim=2)
    assert loaded.find_k_nearest_neighbor_spann(np.array([1.0, 2.0]), k=1)[0].point_id == 0


def test_config_round_trips_between_packages(tmp_path):
    raw = _raw(tmp_path, "bfloat16", nprobe=7, prune_factor=1.2)
    raw["clustering_params"]["soar_lambda"] = 0.25
    j, t = JConfig.from_dict(raw), Config.from_dict(raw)
    assert t.to_dict() == j.to_dict()
    assert Config.from_dict(j.to_dict()).to_dict() == j.to_dict()
    jp, tp = j.to_clustering_params(), t.to_clustering_params()
    for field in ("metric", "initialization_method", "desired_cluster_size", "initial_k",
                  "rng_seed", "replication", "max_replicas", "boundary_threshold",
                  "replica_overflow", "max_split_ways", "wire_dtype", "soar_lambda"):
        assert getattr(tp, field) == getattr(jp, field), field
    with pytest.raises(ValueError, match="unknown"):
        Config.from_dict({"clustering": {}})
    with pytest.raises(ValueError):
        Config.from_dict({"search": {"engine": "gpu"}})


def test_unported_options_raise(tmp_path):
    data, queries = _mixture(4, 300, 4)
    raw = _raw(tmp_path)
    raw["build_sample_rows"] = 100
    oc = SpannIndexBuilder(Config.from_dict(raw), device="cpu").with_data(data).build(save=False)
    assert "oc/assign" in oc.build_profile  # the out-of-core build is ported
    with pytest.raises(ValueError, match="query_wire"):
        Config.from_dict(_raw(tmp_path, query_wire="float16"))
    idx = SpannIndexBuilder(Config.from_dict(_raw(tmp_path, query_wire="bfloat16")),
                            device="cpu").with_data(data).build(save=False)
    assert idx.search(queries, 5)[0].shape == (4, 5)  # the bf16 wire is ported
    with pytest.raises(ValueError, match="query dim"):
        idx.search(queries[:, :5], 5)
