"""Euclidean search at GIST's width (d 960, zero-padded to d_pad 1,024 in
the slabs and the staged queries) on bf16 slabs, at 4,096 rows of a seeded
mixture: the distances against the benchmark's plain reference
(``annbench/reference/exact.py``), no nearer member of a probed posting
missed, full-probe recall against the exact top-k, the ids of the JAX
package's padded engine on the same build, and the search path's
``search.probe_chunks`` and ``search.stage.bytes`` counters, and the
staging's zero columns appended on the device."""

import numpy as np
import pytest
import torch

from annbench.reference.exact import exact_topk, sq_l2_f64
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu_torch.index import spann as tspann
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.ops.topk import centroid_topk
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

N, D, NQ, K, NPROBE, BATCH = 4096, 960, 48, 10, 8, 32


def _mixture(seed, n, nq, d, centers=64, spread=0.7):
    """The benchmark's corpus model: unit-normal centers, each point a
    center plus ``spread`` times unit-normal noise."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)]
                + np.float32(spread) * rng.standard_normal((m, d))).astype(np.float32)

    return draw(n), draw(nq)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data, queries = _mixture(960, N, NQ, D)
    cfg = JConfig.from_dict({
        "clustering_params": {"distance_metric": "Euclidean", "initialization_method": "KMeans++",
                              "initial_k": 8, "desired_cluster_size": 128, "rng_seed": 42},
        "storage_dtype": "bfloat16",
        "output_path": str(tmp_path_factory.mktemp("gist") / "idx"),
        "search": {"query_batch_size": BATCH},
    })
    ref = JBuilder(cfg).with_data(data).build(save=False)
    port = from_jax_state(ref.postings, ref.centroids, ref.dim, ref.config.to_dict(),
                          device="cpu")
    return data, queries, ref, port


def _stored(x):
    """Rows as the bf16 slabs hold them, back in f32."""
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)


def test_the_view_pads_960_to_1024(built):
    *_, port = built
    view = port.padded_view()
    assert port.dim == D and view.d_pad == 1024
    assert view.vectors3d.dtype == torch.bfloat16
    assert not view.vectors3d[..., D:].any()


def test_distances_are_the_references_to_the_stored_rows(built):
    data, queries, _, port = built
    ids, dists = port.search(queries, K, nprobe=NPROBE)
    assert (ids >= 0).all()
    ref = sq_l2_f64(torch.from_numpy(queries)[:, None, :], _stored(data)[torch.from_numpy(ids)])
    # f32 sums of 960 squared differences against f64: a few ulps of the total.
    np.testing.assert_allclose(dists, ref.numpy(), rtol=2e-6, atol=0)


def test_no_nearer_member_of_a_probed_posting_is_missed(built):
    data, queries, _, port = built
    ids, dists = port.search(queries, K, nprobe=NPROBE)
    view = port.padded_view()
    qpad = torch.zeros((NQ, view.d_pad))
    qpad[:, :D] = torch.from_numpy(queries)
    _, rows = centroid_topk(qpad.to(view.centroids.dtype), view.centroids, view.cent_valid,
                            NPROBE, "Euclidean")
    stored = _stored(data)
    for q in range(NQ):
        # A plain scan of the probed postings' members.
        members = torch.unique(torch.cat(
            [view.ids2d[r, : int(view.lens[r])] for r in rows[q].tolist()]).long())
        d = sq_l2_f64(torch.from_numpy(queries[q])[None, :], stored[members])
        nearer = members[d < float(dists[q, -1]) * (1 - 1e-5)]
        assert set(nearer.tolist()) <= set(ids[q].tolist()), q


def test_full_probe_recall_is_exact(built):
    data, queries, _, port = built
    ids, _ = port.search(queries, K, nprobe=port.num_clusters)
    want, _ = exact_topk(torch.from_numpy(data), torch.from_numpy(queries), K,
                         round_rows=torch.bfloat16)
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(), want.tolist()))
    assert hits == NQ * K


@pytest.mark.parametrize("nprobe", [NPROBE, "full"])
def test_ids_equal_the_jax_padded_engine(built, nprobe):
    _, queries, ref, port = built
    npb = port.num_clusters if nprobe == "full" else nprobe
    want_i, want_d = ref.search(queries, K, nprobe=npb, engine="pallas")
    got_i, got_d = port.search(queries, K, nprobe=npb)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)  # f32 summation order


def _delta(name, fn):
    before = metrics.snapshot().get(name, 0.0)
    fn()
    return metrics.snapshot().get(name, 0.0) - before


@pytest.mark.parametrize("probe_chunk", [None, 3, 5])
def test_probe_chunks_counted_a_batch(built, monkeypatch, probe_chunk):
    _, queries, _, port = built
    view = port.padded_view()
    batches = -(-NQ // BATCH)
    want = batches
    if probe_chunk is not None:
        # The budget of ``probe_chunk`` probes of a full batch, as
        # test_torch_search_chunked.py patches it; the last, shorter batch
        # fits more probes into it.
        monkeypatch.setattr(tspann, "PROBE_CHUNK_BYTES",
                            probe_chunk * BATCH * view.pad * tspann._CAND_BYTES)
        last = NQ - (batches - 1) * BATCH
        per = [probe_chunk] * (batches - 1) + [probe_chunk * BATCH // last]
        want = sum(-(-NPROBE // p) for p in per)
        assert want > batches
    assert _delta("search.probe_chunks", lambda: port.search(queries, K, nprobe=NPROBE)) == want


def test_stage_bytes_are_the_f32_queries(built):
    """The f32 wire moves the rows unpadded: the device appends the zero
    columns."""
    _, queries, _, port = built
    got = _delta("search.stage.bytes", lambda: port.search(queries, K, nprobe=NPROBE))
    assert got == NQ * D * 4


@pytest.mark.parametrize("wire,per_query", [("bfloat16", 2 * D), ("int8", D + 4)])
def test_stage_bytes_follow_the_wire(built, monkeypatch, wire, per_query):
    """bf16: two bytes a coordinate; int8: one, and each query's f32
    scale."""
    _, queries, _, port = built
    monkeypatch.setattr(port.config.search, "query_wire", wire)
    assert _delta("search.stage.bytes", lambda: port._stage_queries(queries, 1024)) == NQ * per_query


def _host_padded(queries, wire):
    """The batch as staged from a zero-padded host copy, through ``wire``."""
    a = np.zeros((queries.shape[0], 1024), np.float32)
    a[:, :D] = queries
    if wire == "bfloat16":
        return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32)
    if wire == "int8":
        s = np.maximum(np.abs(a).max(axis=1, keepdims=True) / np.float32(127.0), np.float32(1e-30))
        codes = np.clip(np.rint(a / s), -127, 127).astype(np.int8)
        return torch.from_numpy(codes).to(torch.float32) * torch.from_numpy(s.astype(np.float32))
    return torch.from_numpy(a)


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_staged_batch_equals_the_host_padded_batch(built, monkeypatch, wire, order):
    """Padding on the device after the wire gives the very batch that
    padding on the host before it gave, bit for bit, from the caller's rows
    read-only, in either memory order."""
    _, queries, _, port = built
    monkeypatch.setattr(port.config.search, "query_wire", wire)
    rows = np.array(queries, order=order)
    rows.flags.writeable = False
    got = port._stage_queries(rows, 1024)
    assert got.shape == (NQ, 1024) and got.dtype == torch.float32
    assert torch.equal(got, _host_padded(queries, wire))
    assert not got[:, D:].any()
