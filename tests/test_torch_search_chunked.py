"""The probe axis of a search taken in chunks (``spfresh_tpu_torch/index/
spann.py::_search_padded`` past ``PROBE_CHUNK_BYTES``): with the budget
monkeypatched so that 2 or 3 probes fill a chunk, the port returns the ids
of its unchunked search, and of the JAX package on the same numpy inputs
(f32: the reference's probe-chunked XLA engine; bf16 and int8: its padded
engine, the pipeline the port follows)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.index.spann import _search_kernel_probe_chunked
from spfresh_tpu_torch.index import spann as tspann
from spfresh_tpu_torch.interop import from_jax_state

torch.set_num_threads(2)

NQ = 12


def _mixture(seed, n, nq, d=24, centers=30):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)] + 0.7 * rng.standard_normal((m, d))).astype(
            np.float32)

    return draw(n), draw(nq)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data, queries = _mixture(3, 2000, NQ)
    # Exact copies under other ids: equal distances, which the tie-stable
    # selection orders by column in both searches.
    data[1500:1800] = data[:300]
    queries[: NQ // 2] = data[: NQ // 2] + np.float32(0.01)
    out = {}
    for storage in ("float32", "bfloat16", "int8"):
        cfg = JConfig.from_dict({
            "clustering_params": {"initialization_method": "KMeans++", "initial_k": 8,
                                  "desired_cluster_size": 64, "rng_seed": 5},
            "storage_dtype": storage,
            "output_path": str(tmp_path_factory.mktemp(storage) / "idx"),
            "search": {"query_batch_size": 64},
        })
        ref = JBuilder(cfg).with_data(data).build(save=False)
        port = from_jax_state(ref.postings, ref.centroids, ref.dim, ref.config.to_dict(),
                              device="cpu")
        out[storage] = (ref, port)
    return queries, out


def _chunked(monkeypatch, port, probes_per_chunk):
    """Patch the budget so ``probes_per_chunk`` probes of one NQ-query batch
    fill a chunk; count the chunks the search takes."""
    view = port.padded_view()
    per_probe = NQ * (view.pad * tspann._CAND_BYTES
                      + (view.d_pad * 4 if view.vectors3d.dtype == torch.int8 else 0))
    monkeypatch.setattr(tspann, "PROBE_CHUNK_BYTES", probes_per_chunk * per_probe)
    calls = []
    block = tspann._probe_block

    def counting(*a, **kw):
        calls.append(a[2].shape[1])
        return block(*a, **kw)

    monkeypatch.setattr(tspann, "_probe_block", counting)
    return calls


def _nprobe(port, which):
    return port.num_clusters if which == "full" else which


@pytest.mark.parametrize("probes_per_chunk", [2, 3])
@pytest.mark.parametrize("nprobe", [5, "full"])
@pytest.mark.parametrize("prune", [None, 1.2])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [10, 200])
def test_chunked_ids_equal_unchunked(built, monkeypatch, k, storage, prune, nprobe,
                                     probes_per_chunk):
    """k 200: pruning leaves fewer than k candidates, so every candidate a
    later chunk lets through (or keeps out) shows in the result."""
    queries, idx = built
    port = idx[storage][1]
    npb = _nprobe(port, nprobe)
    want_i, want_d = port.search(queries, k, nprobe=npb, prune_factor=prune)
    if prune is not None and k > 10:
        assert (want_i == -1).any()
    calls = _chunked(monkeypatch, port, probes_per_chunk)
    got_i, got_d = port.search(queries, k, nprobe=npb, prune_factor=prune)
    assert calls == [probes_per_chunk] * (npb // probes_per_chunk) + (
        [npb % probes_per_chunk] if npb % probes_per_chunk else [])
    np.testing.assert_array_equal(got_i, want_i)
    # The same candidate distances, selected by the same tie-stable order.
    np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("probe_chunk", [2, 3])
@pytest.mark.parametrize("nprobe", [5, "full"])
@pytest.mark.parametrize("prune", [None, 1.2])
def test_f32_chunked_ids_equal_jax_probe_chunked(built, monkeypatch, prune, nprobe,
                                                 probe_chunk):
    queries, idx = built
    ref, port = idx["float32"]
    npb = _nprobe(port, nprobe)
    view = ref.device_view()
    want_i, want_d = _search_kernel_probe_chunked(
        jnp.asarray(queries), view.centroids, view.cent_valid, view.offsets, view.lens,
        view.ids, view.vectors, view.scales, jnp.float32(prune or 0.0), k=10, nprobe=npb,
        pad=view.pad, metric="Euclidean", prune=prune is not None, max_dup=view.max_dup,
        probe_chunk=probe_chunk)
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    calls = _chunked(monkeypatch, port, probe_chunk)
    got_i, got_d = port.search(queries, 10, nprobe=npb, prune_factor=prune)
    assert len(calls) > 1
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)  # f32 summation order


@pytest.mark.parametrize("nprobe", [5, "full"])
@pytest.mark.parametrize("prune", [None, 1.2])
@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_chunked_ids_equal_jax_padded_engine(built, monkeypatch, storage, prune, nprobe):
    queries, idx = built
    ref, port = idx[storage]
    npb = _nprobe(port, nprobe)
    want_i, want_d = ref.search(queries, 10, nprobe=npb, prune_factor=prune, engine="pallas")
    calls = _chunked(monkeypatch, port, 2)
    got_i, got_d = port.search(queries, 10, nprobe=npb, prune_factor=prune)
    assert len(calls) > 1
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)  # f32 summation order
