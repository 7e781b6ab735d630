"""The expansion-form IVF-SQ8 rerank ("int8-MXU"): the port's query
quantizer, plain version (what a CPU tensor runs) and transposed-code
tables against the JAX package on the same numpy inputs."""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfresh_tpu.ops.pallas import rerank as jr
from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.ops import rerank as tr

torch.set_num_threads(2)

# tests/test_pallas_rerank.py's tolerance for this scorer: the dots are
# exact, the final combine may differ by an ulp between programs.
RTOL, ATOL = 3e-7, 1e-3


def _sq8(seed, C=12, pad=32, d=128, Q=8, nprobe=8):
    """tests/test_pallas_rerank.py's fixture: random residuals quantized
    per slab, transposed codes and |r|^2 as benchmarks/rerank_bench.py
    builds them."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((C, d)).astype(np.float32)
    resid = rng.standard_normal((C, pad, d)).astype(np.float32)
    scales = (np.abs(resid).max(axis=(1, 2)) / 127.0).astype(np.float32)
    codes = np.clip(np.rint(resid / scales[:, None, None]), -127, 127).astype(np.int8)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    rows = rng.integers(0, C, size=(Q, nprobe)).astype(np.int32)
    codesT = np.ascontiguousarray(codes.transpose(0, 2, 1))
    norms2 = (codes.astype(np.int64) ** 2).sum(axis=2).astype(np.int32)
    return q, cents, rows, codes, codesT, norms2, scales


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_centered_queries_equals_jax(seed):
    q, cents, rows, *_ = _sq8(seed)
    q[0, :3] = 0.0
    jc, js, jn = (np.asarray(a) for a in jr.quantize_centered_queries(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(rows)))
    tc, ts, tn = (a.numpy() for a in tr.quantize_centered_queries(
        torch.from_numpy(q), torch.from_numpy(cents), torch.from_numpy(rows)))
    assert tc.dtype == np.int8 and ts.dtype == np.float32 and tn.dtype == np.float32
    np.testing.assert_array_equal(tc, jc)  # codes bit-equal
    np.testing.assert_array_equal(_bits(ts), _bits(js))  # scales bit-equal
    np.testing.assert_allclose(tn, jn, rtol=1e-6)  # f32 sums of d squares, another order


@pytest.mark.parametrize("native_int8", [False, True])
@pytest.mark.parametrize("shape", [dict(), dict(C=20, pad=48, d=64, Q=5, nprobe=3)])
def test_plain_matches_oracle_and_interpreted_kernel(native_int8, shape):
    q, cents, rows, _, codesT, norms2, scales = _sq8(3, **shape)
    qcodes, qscale, qnorm2 = jr.quantize_centered_queries(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(rows))
    jargs = (qcodes, qscale, qnorm2, jnp.asarray(rows), jnp.asarray(codesT),
             jnp.asarray(norms2), jnp.asarray(scales))
    kern = np.asarray(jr.padded_rerank_distances_int8mxu(*jargs, interpret=True,
                                                         native_int8=native_int8))
    oracle = np.asarray(jr.int8mxu_rerank_oracle(*jargs))
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    before = tr.int8mxu_launches
    got = tr.padded_rerank_distances_int8mxu(*targs, native_int8=native_int8).numpy()
    assert tr.int8mxu_launches == before  # CPU tensors launch nothing
    assert got.shape == (len(q), rows.shape[1], codesT.shape[2]) and got.dtype == np.float32
    for want in (oracle, kern):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(np.argsort(got, axis=-1, kind="stable"),
                                      np.argsort(want, axis=-1, kind="stable"))


def test_plain_chunked_equals_one_shot(monkeypatch):
    q, cents, rows, _, codesT, norms2, scales = _sq8(4, Q=11)
    qc, qs, qn = tr.quantize_centered_queries(*(torch.from_numpy(a) for a in (q, cents, rows)))
    args = (qc, qs, qn, torch.from_numpy(rows), torch.from_numpy(codesT),
            torch.from_numpy(norms2), torch.from_numpy(scales))
    one = tr.padded_rerank_distances_int8mxu_plain(*args)
    monkeypatch.setattr(tr, "PLAIN_CHUNK_BYTES", 1)
    torch.testing.assert_close(one, tr.padded_rerank_distances_int8mxu_plain(*args),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    q, cents, rows, _, codesT, norms2, scales = _sq8(5)
    qc, qs, qn = tr.quantize_centered_queries(*(torch.from_numpy(a) for a in (q, cents, rows)))
    args = [qc, qs, qn, torch.from_numpy(rows), torch.from_numpy(codesT),
            torch.from_numpy(norms2), torch.from_numpy(scales)]

    def call(i, t, exc, match):
        bad = list(args)
        bad[i] = t
        with pytest.raises(exc, match=match):
            tr.padded_rerank_distances_int8mxu(*bad)

    call(0, qc[:, :, :64], ValueError, "qcodes")
    call(0, qc.to(torch.int32), TypeError, "qcodes")
    call(1, qs[:, :2], ValueError, "qscale")
    call(3, args[3].long(), TypeError, "rows")
    call(5, args[5][:, :8], ValueError, "norms2")
    call(5, args[5].long(), TypeError, "norms2")
    call(6, args[6][:3], ValueError, "scales")
    with pytest.raises(TypeError, match="native_int8"):
        tr.padded_rerank_distances_int8mxu(*args, native_int8=1)
    with pytest.raises(ValueError, match="no int8mxu rerank for device"):
        tr.padded_rerank_distances_int8mxu(*(t.to("meta") for t in args))


def test_score_tracks_true_distance():
    """tests/test_pallas_rerank.py's accuracy check on the port's plain
    version: within 5% of the exact f32 distance, same top-1 per slab."""
    q, cents, rows, codes, codesT, norms2, scales = _sq8(6, pad=16, Q=6, nprobe=4)
    qc, qs, qn = tr.quantize_centered_queries(*(torch.from_numpy(a) for a in (q, cents, rows)))
    approx = tr.padded_rerank_distances_int8mxu(
        qc, qs, qn, torch.from_numpy(rows), torch.from_numpy(codesT),
        torch.from_numpy(norms2), torch.from_numpy(scales)).numpy()
    X = cents[:, None, :] + codes.astype(np.float32) * scales[:, None, None]
    for qi in range(6):
        for pi in range(4):
            exact = np.sum((X[rows[qi, pi]] - q[qi]) ** 2, axis=1)
            assert (np.abs(approx[qi, pi] - exact) / np.maximum(exact, 1e-6)).max() < 0.05
            assert int(np.argmin(approx[qi, pi])) == int(np.argmin(exact))


def test_transposed_codes_of_a_port_int8_view_equal_the_bench_tables(tmp_path):
    """The (C, d_pad, pad) codes and |r|^2 table chip_smoke.py builds from a
    port int8 view equal benchmarks/rerank_bench.py's numpy construction."""
    rng = np.random.default_rng(7)
    data = (rng.standard_normal((1500, 24)) * rng.uniform(0.5, 2, (1, 24))).astype(np.float32)
    cfg = Config.from_dict({
        "clustering_params": {"initialization_method": "KMeans++", "initial_k": 8,
                              "desired_cluster_size": 64, "rng_seed": 5},
        "storage_dtype": "int8", "output_path": str(tmp_path / "idx"),
    })
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=False)
    view = index.padded_view()
    codesT, norms2 = chip_smoke.transposed_codes(torch, view.vectors3d)
    codes = view.vectors3d.numpy()
    np.testing.assert_array_equal(codesT.numpy(), np.ascontiguousarray(codes.transpose(0, 2, 1)))
    np.testing.assert_array_equal(norms2.numpy(),
                                  (codes.astype(np.int64) ** 2).sum(axis=2).astype(np.int32))
    assert codesT.dtype == torch.int8 and norms2.dtype == torch.int32
