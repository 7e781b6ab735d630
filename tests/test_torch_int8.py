"""int8 (residual IVF-SQ8) storage and the reduced query wires: the port's
quantization helpers, slab pack, quantized rerank (the plain version a CPU
tensor runs) and search against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfresh_tpu.core import dtypes as jdt
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndex as JIndex
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.ops.pallas import rerank as jr
from spfresh_tpu_torch.core import dtypes as tdt
from spfresh_tpu_torch.index import Config, SpannIndex, SpannIndexBuilder
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.ops import rerank as tr

torch.set_num_threads(2)


def _mixture(seed, n, nq, d=24, centers=30):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)] + 0.7 * rng.standard_normal((m, d))).astype(
            np.float32)

    return draw(n), draw(nq)


def _raw(tmp_path, storage, **search):
    return {
        "clustering_params": {"initialization_method": "KMeans++", "initial_k": 8,
                              "desired_cluster_size": 64, "rng_seed": 5},
        "storage_dtype": storage,
        "output_path": str(tmp_path / "idx"),
        "search": {"query_batch_size": 64, **search},
    }


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    data, queries = _mixture(0, 2000, 100)
    out = {}
    for storage in ("float32", "int8"):
        cfg = JConfig.from_dict(_raw(tmp_path_factory.mktemp(storage), storage))
        out[storage] = JBuilder(cfg).with_data(data).build(save=False)
    return data, queries, out


def _carry(jidx, **search):
    raw = jidx.config.to_dict()
    raw["search"].update(search)
    return from_jax_state(jidx.postings, jidx.centroids, jidx.dim, raw, device="cpu")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def test_dtype_policy_int8():
    p = tdt.DtypePolicy("int8")
    assert p.storage_dtype == torch.int8 and p.quantized
    assert not tdt.DtypePolicy("bfloat16").quantized


@pytest.mark.parametrize("scale_kind", ["scalar", "per_row"])
def test_dtype_helpers_equal_jax_bitwise(scale_kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 40)) * rng.uniform(0.01, 50, (64, 1))).astype(np.float32)
    x[3] = 0.0
    x[5, :4] = [0.5, -0.5, 1.5, 2.5]  # half-way values: round half to even
    rowmax = np.abs(x).max(axis=1).astype(np.float32)
    got_s = tdt.posting_scales_np(rowmax)
    want_s = jdt.posting_scales_np(rowmax)
    np.testing.assert_array_equal(_bits(got_s), _bits(want_s))
    assert got_s[3] == 1.0  # an all-zero posting keeps a finite reciprocal
    scale = got_s[:, None] if scale_kind == "per_row" else np.float32(1.0)
    np.testing.assert_array_equal(tdt.quantize_np(x, scale), jdt.quantize_np(x, scale))
    for row in (x[0], x[3], x[5]):
        assert tdt.quant_scale_for(row) == jdt.quant_scale_for(row)


def _assert_views_equal(port_view, jview):
    np.testing.assert_array_equal(port_view.vectors3d.numpy(), np.asarray(jview.vectors3d))
    assert port_view.vectors3d.dtype == torch.int8
    np.testing.assert_array_equal(_bits(port_view.scales.numpy()), _bits(np.asarray(jview.scales)))
    np.testing.assert_array_equal(port_view.ids2d.numpy(), np.asarray(jview.ids2d))
    np.testing.assert_array_equal(port_view.lens.numpy(), np.asarray(jview.lens))
    assert port_view.centroids.dtype == torch.float32  # int8 routes on f32 centroids
    np.testing.assert_array_equal(port_view.centroids.numpy(), np.asarray(jview.centroids))
    assert (port_view.pad, port_view.d_pad) == (jview.pad, jview.d_pad)


def test_int8_view_bit_identical_from_jax_state(jax_built):
    """The JAX view of a fresh build packs on the device from its corpus;
    the port packs the same postings from host rows."""
    _, _, jidx = jax_built
    ref = jidx["int8"]
    _assert_views_equal(_carry(ref).padded_view(), ref.padded_view())


def test_int8_view_bit_identical_from_jax_saved_index(jax_built, tmp_path):
    _, _, jidx = jax_built
    jidx["int8"].save(str(tmp_path / "j"))
    port = SpannIndex.load(str(tmp_path / "j"), device="cpu")
    assert port.policy.quantized
    _assert_views_equal(port.padded_view(), JIndex.load(str(tmp_path / "j")).padded_view())


def test_port_int8_build_packs_from_corpus_as_from_host(tmp_path):
    """A fresh port build packs its view from the device corpus; the same
    index saved and loaded packs from host rows: the two are identical."""
    data, _ = _mixture(1, 1500, 4)
    built = SpannIndexBuilder(Config.from_dict(_raw(tmp_path, "int8")), device="cpu").with_data(
        data).build(save=True)
    fresh = built.padded_view()
    again = SpannIndex.load(str(tmp_path / "idx"), device="cpu").padded_view()
    for a, b in ((fresh.vectors3d, again.vectors3d), (fresh.scales, again.scales),
                 (fresh.ids2d, again.ids2d), (fresh.centroids, again.centroids)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(fresh.vectors3d.abs().max()) == 127  # each posting's abs-max maps to 127


def _qcase(seed, Q=6, nprobe=5, C=9, pad=16, d=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    v = rng.integers(-127, 128, (C, pad, d)).astype(np.int8)
    rows = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
    scales = rng.uniform(0.001, 0.05, (Q, nprobe)).astype(np.float32)
    qc = rng.standard_normal((Q, nprobe, d)).astype(np.float32)
    return q, rows, v, scales, qc


@pytest.mark.parametrize("metric", ["Euclidean", "Manhattan", "Chebyshev"])
def test_quantized_plain_matches_pallas_kernel_interpret(metric):
    q, rows, v, scales, qc = _qcase(1)
    want = np.asarray(jr.padded_rerank_distances(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(v), metric, interpret=True,
        scales=jnp.asarray(scales), centered_queries=jnp.asarray(qc)))
    before = (tr.launches, tr.quantized_launches)
    got = tr.padded_rerank_distances(torch.from_numpy(q), torch.from_numpy(rows),
                                     torch.from_numpy(v), metric, scales=torch.from_numpy(scales),
                                     centered_queries=torch.from_numpy(qc))
    assert (tr.launches, tr.quantized_launches) == before  # CPU tensors launch nothing
    assert got.shape == (6, 5, 16) and got.dtype == torch.float32
    # rtol 1e-5: f32 sums of d = 128 terms in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_quantized_chunked_plain_equals_one_shot(monkeypatch):
    q, rows, v, scales, qc = _qcase(2, Q=11)
    args = [torch.from_numpy(a) for a in (q, rows, v)]
    kw = dict(scales=torch.from_numpy(scales), centered_queries=torch.from_numpy(qc))
    one = tr.padded_rerank_distances_plain(*args, **kw)
    monkeypatch.setattr(tr, "PLAIN_CHUNK_BYTES", 1)
    torch.testing.assert_close(one, tr.padded_rerank_distances_plain(*args, **kw), rtol=0, atol=0)


def test_quantized_wrapper_rejects_bad_inputs():
    q, rows, v, scales, qc = _qcase(3)
    tq, trows, tv, ts, tqc = (torch.from_numpy(a) for a in (q, rows, v, scales, qc))
    with pytest.raises(ValueError, match="together"):
        tr.padded_rerank_distances(tq, trows, tv, scales=ts)
    with pytest.raises(TypeError, match="int8 slabs"):
        tr.padded_rerank_distances(tq, trows, tv)
    with pytest.raises(TypeError, match="int8 slabs"):
        tr.padded_rerank_distances(tq, trows, tv.float(), scales=ts, centered_queries=tqc)
    with pytest.raises(ValueError, match="scales"):
        tr.padded_rerank_distances(tq, trows, tv, scales=ts[:, :2], centered_queries=tqc)
    with pytest.raises(ValueError, match="centered_queries"):
        tr.padded_rerank_distances(tq, trows, tv, scales=ts, centered_queries=tqc[:, :, :64])
    with pytest.raises(TypeError, match="float32"):
        tr.padded_rerank_distances(tq, trows, tv, scales=ts.double(), centered_queries=tqc)
    with pytest.raises(ValueError, match="no rerank for device"):
        tr.padded_rerank_distances(*(t.to("meta") for t in (tq, trows, tv)),
                                   scales=ts.to("meta"), centered_queries=tqc.to("meta"))


@pytest.mark.parametrize("nprobe", [3, 8])
@pytest.mark.parametrize("prune", [None, 1.2])
def test_int8_search_ids_equal_jax_padded_engine(jax_built, nprobe, prune):
    _, queries, jidx = jax_built
    ref = jidx["int8"]
    port = _carry(ref)
    want_i, want_d = ref.search(queries[:12], 10, nprobe=nprobe, prune_factor=prune,
                                engine="pallas")
    got_i, got_d = port.search(queries[:12], 10, nprobe=nprobe, prune_factor=prune)
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)  # f32 summation order


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_query_wires_give_jax_ids(jax_built, wire, storage):
    """Each wire stages the queries with the JAX arithmetic; the search at
    the staged coordinates returns the reference's ids (the XLA engine for
    f32 storage, the padded engine for int8)."""
    _, queries, jidx = jax_built
    ref = jidx[storage]
    port = _carry(ref, query_wire=wire)
    old = ref.config.search.query_wire
    ref.config.search.query_wire = wire
    try:
        want_i, want_d = ref.search(queries[:12], 10, nprobe=4,
                                    engine="xla" if storage == "float32" else "pallas")
    finally:
        ref.config.search.query_wire = old
    got_i, got_d = port.search(queries[:12], 10, nprobe=4)
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)
    staged = port._stage_queries(np.ascontiguousarray(queries[:4]), port.dim).numpy()
    assert staged.dtype == np.float32 and not np.array_equal(staged, queries[:4])
