"""Twin of tests/test_outofcore_model_fuzz.py for the port's out-of-core
build (``clustering/outofcore.py`` through ``Config.build_sample_rows``)
on the CPU.

The JAX test's random corpora and configs (its ``CI_SEEDS``; exact
duplicate rows, constant rows, corpora barely larger than the fit
sample) go through the port's builder, which takes the JAX package's
sample-fit seeds (the two packages draw KMeans++ seeds from different
generators).  Oracles of the JAX test, on the port:

  build A (ndarray corpus, the first tile size):
    1. coverage: every corpus row lands in at least one posting;
    2. replica cap: no row in more than ``max_replicas`` postings, no
       posting past ceil(replica_overflow * desired_cluster_size);
    3. full-probe recall exactly 1.0 (f32 storage);
    4. partial-probe dedup: no id twice in a result row;
  build B (the same config, the corpus a read-only np.memmap, the other
  tile size; the port has one replica engine, so B runs it too):
    5. postings and centroids bit-identical to build A.

Build A's clusters also equal those of the JAX package's build A (its
replica engine as the JAX test draws it): the same base assignment and
centroids, and the same replica memberships but for those that
``replica_diff_is_tie`` proves in f64 to be ties of the f32 replica pass
(ROADMAP Queue 3)."""

import dataclasses

import numpy as np
import pytest
import torch

import spfresh_tpu.clustering.outofcore as jo
from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.eval import recall_at_k
from spfresh_tpu_torch.index import Config, SpannIndexBuilder, brute_force_search
from test_outofcore_model_fuzz import CI_SEEDS, _random_case
from test_outofcore_model_fuzz import _build as _jax_build
from torch_replica_ties import replica_diff_is_tie

torch.set_num_threads(2)


def _jax_sample_seeds(params, data, sample_rows):
    """The JAX package's initial seeds for its sample fit: the sample draw
    and scaled cap of ``fit_outofcore``, then its ``_initialize_clusters``."""
    n = len(data)
    rng = np.random.Generator(np.random.Philox(key=np.uint64(params.rng_seed ^ 0x0C0FFEE)))
    sidx = (np.arange(n) if sample_rows >= n
            else np.sort(rng.choice(n, size=sample_rows, replace=False)))
    sp = dataclasses.replace(params, desired_cluster_size=max(
        1, int(round(params.desired_cluster_size * len(sidx) / n))))
    hc = jh.HierarchicalClustering(sp, np.ascontiguousarray(data[sidx]))
    hc._initialize_clusters(sp.initial_k)
    return np.array([c.centroid_idx for c in hc.clusters], np.int64)


def _port_build(tmp_path, data, cfg, tile_rows, tag):
    raw = {**cfg, "clustering_params": dict(cfg["clustering_params"]),
           "output_path": str(tmp_path / f"oc_{tag}"), "build_tile_rows": tile_rows}
    builder = SpannIndexBuilder(Config.from_dict(raw), device="cpu").with_data(data)
    return builder.build(save=False), builder.outofcore


@pytest.mark.parametrize("seed", CI_SEEDS)
def test_outofcore_model_fuzz(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed ^ 0x0C0C)
    data, q, cfg, (tile_a, tile_b) = _random_case(rng)
    engines = ["xla", "pallas"]
    rng.shuffle(engines)
    n = len(data)
    cp = cfg["clustering_params"]

    jres = []
    fit = jo.fit_outofcore
    monkeypatch.setattr(jo, "fit_outofcore", lambda *a, **k: jres.append(fit(*a, **k)) or jres[-1])
    _jax_build(tmp_path, data, cfg, tile_a, engines[0], "jax_a")
    ref = jres[0]

    jp = JConfig.from_dict(cfg).to_clustering_params()
    seeds = _jax_sample_seeds(jp, data, cfg["build_sample_rows"])
    monkeypatch.setattr(th, "_kmeanspp_init", lambda X, k, metric, rng: seeds)
    monkeypatch.setattr(th, "_random_init", lambda n_, k, rng: seeds)
    idx, port = _port_build(tmp_path, data, cfg, tile_a, "a")

    # 1+2: coverage and the replica/overflow caps.
    cnt = np.zeros(n, np.int64)
    for _, (ids, _) in idx.postings.items():
        assert len(set(ids.tolist())) == len(ids), "dup id within a posting"
        cnt[ids] += 1
    assert cnt.min() >= 1, "row missing from every posting"
    assert cnt.max() <= cp["max_replicas"]
    limit = int(np.ceil(1.25 * cp["desired_cluster_size"]))
    assert max(len(i) for i, _ in idx.postings.values()) <= limit

    # 3: full-probe search is exactly recall 1.0 (f32 storage).
    _, gt_i = brute_force_search(data, q, 10, device="cpu")
    ids, _ = idx.search(q, 10, nprobe=idx.num_clusters)
    assert recall_at_k(ids, gt_i, 10) == 1.0

    # 4: partial-probe rows never repeat an id.
    ids_p, _ = idx.search(q, 10, nprobe=max(1, idx.num_clusters // 4))
    for row in np.asarray(ids_p):
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)

    # 5: memmap corpus, the other tile size: bit-identical.
    mm_path = str(tmp_path / "corpus.f32")
    data.tofile(mm_path)
    mm = np.memmap(mm_path, dtype=np.float32, mode="r", shape=data.shape)
    idx2, _ = _port_build(tmp_path, mm, cfg, tile_b, "b")
    assert sorted(idx.postings) == sorted(idx2.postings)
    for c in idx.postings:
        np.testing.assert_array_equal(idx.postings[c][0], idx2.postings[c][0])
        np.testing.assert_array_equal(idx.centroids[c], idx2.centroids[c])

    # The JAX package's build A: the same centroids, every row's base
    # posting among the JAX cluster's members, replicas up to ties.
    assert port.sample_rows == ref.sample_rows and port.num_splits == ref.num_splits
    assert [c.centroid_idx for c in port.clusters] == [c.centroid_idx for c in ref.clusters]
    pre = [np.flatnonzero(port.base == ci) for ci in range(len(port.clusters))]
    for ci, c in enumerate(ref.clusters):
        assert np.isin(pre[ci], c.points).all(), f"cluster {ci}: base rows differ"
    replica_diff_is_tie(data, pre, ref, port, float(np.float32(cp["boundary_threshold"])))
