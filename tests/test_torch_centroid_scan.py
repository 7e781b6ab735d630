"""Stage 1 past 32,768 centroids: the port's windowed centroid scan (the
plain versions a CPU tensor runs) against the JAX package's
``windowed_centroid_topk`` with its Pallas kernel in interpret mode, the
chunked scan against the JAX one, the route ``centroid_topk`` takes, and a
whole search over the windowed route against the JAX search."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.index import SpannIndexBuilder as JBuilder
from spfresh_tpu.ops import topk as jt
from spfresh_tpu.ops.pallas import centroid_scan as jcs
from spfresh_tpu_torch.interop import from_jax_state
from spfresh_tpu_torch.ops import centroid_scan as tcs
from spfresh_tpu_torch.ops import rerank as trr
from spfresh_tpu_torch.ops import topk as tt

torch.set_num_threads(2)


def _f64_dist(q, c):
    return float(((q.astype(np.float64) - c.astype(np.float64)) ** 2).sum())


def _assert_matches(got, want, qf, cents):
    """Distances within rtol 1e-5 (exact elementwise distances on both
    sides, f32 sums in another order); ids equal, except that an id in one
    result and not the other must sit within 1e-2 * (1 + |edge|) of the
    reference's last kept distance (the near-tie rule of
    tests/test_pallas_centroid_scan.py::_check), and ids at swapped
    positions must carry distances equal within that tolerance."""
    got_d, got_i = (np.asarray(t) for t in got)
    want_d, want_i = (np.asarray(t) for t in want)
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), fin)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)
    for q in np.nonzero((got_i != want_i).any(axis=1))[0]:
        ge, gg = set(want_i[q][fin[q]].tolist()), set(got_i[q][fin[q]].tolist())
        edge = float(want_d[q][fin[q]].max())
        for i in ge ^ gg:
            assert abs(_f64_dist(qf[q], cents[i]) - edge) < 1e-2 * (1 + abs(edge)), (q, i)
        for j in np.nonzero(got_i[q] != want_i[q])[0]:
            if got_i[q, j] in ge and want_i[q, j] in gg:
                a, b = _f64_dist(qf[q], cents[got_i[q, j]]), _f64_dist(qf[q], cents[want_i[q, j]])
                assert abs(a - b) < 1e-2 * (1 + abs(edge)), (q, j)


def _port(qf, cents, valid, nprobe):
    before = tcs.launches
    out = tcs.windowed_centroid_topk(torch.from_numpy(qf), torch.from_numpy(cents),
                                     torch.from_numpy(valid), nprobe)
    assert tcs.launches == before  # CPU tensors never count a kernel launch
    return out


def _jax(qf, cents, valid, nprobe, superchunk=262144):
    return jcs.windowed_centroid_topk(jnp.asarray(qf), jnp.asarray(cents), jnp.asarray(valid),
                                      nprobe, superchunk=superchunk, interpret=True)


# The cases of tests/test_pallas_centroid_scan.py: (seed, C, Q, d, nprobe,
# every third centroid invalid).
CASES = {
    "basic": (0, 3000, 37, 48, 9, False),
    "invalid_centroids": (1, 1500, 5, 16, 8, True),
    "more_probes_than_windows": (4, 256, 3, 8, 16, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_matches_jax(case):
    seed, C, Q, d, nprobe, holes = CASES[case]
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((C, d)).astype(np.float32)
    qf = rng.standard_normal((Q, d)).astype(np.float32)
    valid = np.ones(C, bool)
    if holes:
        valid[::3] = False
    got = _port(qf, cents, valid, nprobe)
    _assert_matches(got, _jax(qf, cents, valid, nprobe), qf, cents)
    if holes:
        assert np.all(got[1].numpy() % 3 != 0)
    assert got[1].dtype == torch.int64 and got[0].shape == (Q, nprobe)


def test_multi_superchunk_merge(monkeypatch):
    rng = np.random.default_rng(2)
    cents = rng.standard_normal((4096, 8)).astype(np.float32)
    qf = rng.standard_normal((11, 8)).astype(np.float32)
    valid = np.ones(4096, bool)
    monkeypatch.setattr(tcs, "SUPERCHUNK", 1024)  # 4 rounds through the exact merge
    got = _port(qf, cents, valid, 6)
    _assert_matches(got, _jax(qf, cents, valid, 6, superchunk=1024), qf, cents)
    monkeypatch.setattr(tcs, "SUPERCHUNK", 1 << 20)
    one_round = _port(qf, cents, valid, 6)
    np.testing.assert_array_equal(got[1].numpy(), one_round[1].numpy())


def test_bf16_centroids():
    rng = np.random.default_rng(3)
    cents = rng.standard_normal((2048, 32)).astype(np.float32).astype(ml_dtypes.bfloat16)
    qf = rng.standard_normal((9, 32)).astype(np.float32)
    valid = np.ones(2048, bool)
    cf = cents.astype(np.float32)
    got = tcs.windowed_centroid_topk(torch.from_numpy(qf), torch.from_numpy(cf).to(torch.bfloat16),
                                     torch.from_numpy(valid), 4)
    _assert_matches(got, _jax(qf, cents, valid, 4), qf, cf)


def test_fewer_valid_than_nprobe():
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((300, 8)).astype(np.float32)
    qf = rng.standard_normal((2, 8)).astype(np.float32)
    valid = np.zeros(300, bool)
    valid[:5] = True
    got_d, got_i = _port(qf, cents, valid, 8)
    want_d, want_i = _jax(qf, cents, valid, 8)
    assert np.all(np.isfinite(got_d[:, :5].numpy())) and np.all(~np.isfinite(got_d[:, 5:].numpy()))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))  # 0 = in-range sentinel
    np.testing.assert_allclose(got_d[:, :5].numpy(), np.asarray(want_d)[:, :5], rtol=1e-5)


@pytest.mark.parametrize("bf16_rank", [False, True])
def test_plain_window_scan_matches_pallas_kernel(bf16_rank):
    """Pass 1 alone: the plain per-window minima against the Pallas
    kernel's on the same augmented operands (f32 sums of d = 128 products
    in another order: rtol 1e-5 on ranks of magnitude ~|c|^2)."""
    rng = np.random.default_rng(6)
    cents = rng.standard_normal((1500, 100)).astype(np.float32)
    qf = rng.standard_normal((20, 100)).astype(np.float32)
    valid = rng.random(1500) > 0.2
    caug, qaug, Cpad = tcs._augment(torch.from_numpy(qf), torch.from_numpy(cents),
                                    torch.from_numpy(valid), 128)
    jcaug, jqaugT, jCpad, _ = jcs._augment(jnp.asarray(qf), jnp.asarray(cents),
                                           jnp.asarray(valid), 128)
    assert Cpad == jCpad == 2048
    np.testing.assert_array_equal(caug.numpy(), np.asarray(jcaug))
    np.testing.assert_array_equal(qaug.numpy(), np.asarray(jqaugT).T[:20])
    got = tcs.centroid_window_scan(caug, qaug, bf16_rank)
    want = np.asarray(jcs.pallas_centroid_window_scan(jcaug, jqaugT, interpret=True,
                                                      bf16_rank=bf16_rank)).T[:20]
    assert got.shape == (20, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def test_window_scan_rejects_bad_inputs():
    caug = torch.zeros((1024, 128))
    qaug = torch.zeros((4, 128))
    with pytest.raises(ValueError, match="multiple of 1024"):
        tcs.centroid_window_scan(caug[:512], qaug, False)
    with pytest.raises(TypeError, match="float32"):
        tcs.centroid_window_scan(caug.double(), qaug, False)
    with pytest.raises(ValueError, match="qaug"):
        tcs.centroid_window_scan(caug, qaug[:, :64], False)
    with pytest.raises(ValueError, match="no centroid window scan for device"):
        tcs.centroid_window_scan(caug.to("meta"), qaug.to("meta"), False)


@pytest.mark.parametrize("metric", ["Euclidean", "Manhattan", "Chebyshev"])
def test_chunked_matches_jax(metric, monkeypatch):
    rng = np.random.default_rng(7)
    cents = rng.standard_normal((300, 16)).astype(np.float32)
    qf = rng.standard_normal((20, 16)).astype(np.float32)
    valid = rng.random(300) > 0.1
    monkeypatch.setattr(tt, "CENTROID_CHUNK", 64)
    got_d, got_i = tt.chunked_centroid_topk(torch.from_numpy(qf), torch.from_numpy(cents),
                                            torch.from_numpy(valid), 6, metric)
    want_d, want_i = jt.chunked_centroid_topk(jnp.asarray(qf), jnp.asarray(cents),
                                              jnp.asarray(valid), 6, metric, chunk=64)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # The Euclidean expansion cancels |x|^2 + |y|^2 ~ 32: atol ~ eps * 32.
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nprobe,metric,route", [
    (8, "Euclidean", "windowed"),
    (128, "Euclidean", "windowed"),
    (129, "Euclidean", "chunked"),
    (8, "Manhattan", "chunked"),
    (1025, "Euclidean", "dense"),
])
def test_centroid_topk_route(monkeypatch, nprobe, metric, route):
    """The route depends on (C, nprobe, metric) alone, on every device."""
    taken = []
    monkeypatch.setattr(tt, "LARGE_C_THRESHOLD", 100)
    monkeypatch.setattr(tcs, "windowed_centroid_topk", lambda *a: taken.append("windowed"))
    monkeypatch.setattr(tt, "chunked_centroid_topk", lambda *a: taken.append("chunked"))
    rng = np.random.default_rng(8)
    cents = torch.from_numpy(rng.standard_normal((1100, 8)).astype(np.float32))
    qf = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    out = tt.centroid_topk(qf, cents, None, nprobe, metric)
    assert taken == ([] if route == "dense" else [route])
    if route == "dense":
        assert out[1].shape == (3, nprobe)
    monkeypatch.setattr(tt, "LARGE_C_THRESHOLD", 32_768)
    tt.centroid_topk(qf, cents, None, 8, metric)
    assert len(taken) == (0 if route == "dense" else 1)  # under the threshold: dense


def _mixture(seed, n, nq, d=24, centers=30):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)

    def draw(m):
        return (c[rng.integers(0, centers, m)] + 0.7 * rng.standard_normal((m, d))).astype(
            np.float32)

    return draw(n), draw(nq)


@pytest.fixture(scope="module")
def jax_f32_index(tmp_path_factory):
    data, queries = _mixture(0, 2000, 100)
    cfg = JConfig.from_dict({
        "clustering_params": {"initialization_method": "KMeans++", "initial_k": 8,
                              "desired_cluster_size": 64, "rng_seed": 5},
        "storage_dtype": "float32",
        "output_path": str(tmp_path_factory.mktemp("f32") / "idx"),
        "search": {"query_batch_size": 64},
    })
    return data, queries, JBuilder(cfg).with_data(data).build(save=False)


@pytest.mark.parametrize("nprobe", [3, 8])
def test_search_over_windowed_route_equals_jax(jax_f32_index, monkeypatch, nprobe):
    """The port past its (patched) threshold against the JAX search on its
    own dense route: the same ids, and distances within f32 rounding."""
    data, queries, ref = jax_f32_index
    port = from_jax_state(ref.postings, ref.centroids, ref.dim, ref.config.to_dict(),
                          device="cpu")
    monkeypatch.setattr(tt, "LARGE_C_THRESHOLD", 16)
    assert port.num_clusters > 16
    calls = []
    real = tcs.windowed_centroid_topk
    monkeypatch.setattr(tcs, "windowed_centroid_topk", lambda *a: calls.append(1) or real(*a))
    rerank_before = trr.launches
    got_i, got_d = port.search(queries, 10, nprobe=nprobe)
    assert calls, "the search did not take the windowed route"
    assert trr.launches == rerank_before
    want_i, want_d = ref.search(queries, 10, nprobe=nprobe, engine="xla")
    np.testing.assert_array_equal(got_i, want_i)
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5)


# The operands of the CUDA kernel's two rank modes, on CASES' inputs as
# _augment lays them out (sentinel rows of 1e18, d padded to 128 or to
# 1,024), against the JAX package.
SCAN_RTOL = 1e-5  # chip_smoke.SCAN_RTOL: of |rank| + mean |c|^2


def _operands(case, d_pad):
    seed, C, Q, d, _, holes = CASES[case]
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((C, d)).astype(np.float32)
    qf = rng.standard_normal((Q, d)).astype(np.float32)
    valid = np.ones(C, bool)
    valid[:: 3 if holes else 7] = False  # sentinel rows in every case
    caug, qaug, _ = tcs._augment(torch.from_numpy(qf), torch.from_numpy(cents),
                                 torch.from_numpy(valid), d_pad)
    return caug, qaug, valid, qf, cents


@pytest.mark.parametrize("d_pad", [128, 1024])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_operand_rounding_matches_jax(case, d_pad):
    caug, qaug, *_ = _operands(case, d_pad)
    for x in (caug, qaug):
        want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(tcs.bf16_operand(x).numpy(), want)


@pytest.mark.parametrize("d_pad", [128, 1024])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32_split(case, d_pad):
    """hi keeps at most 10 explicit mantissa bits (the low 13 are 0) and is
    x rounded to nearest; hi + lo is within 2^-22 of |x|; lo is a TF32
    value too."""
    caug, qaug, *_ = _operands(case, d_pad)
    for x in (caug, qaug):
        hi, lo = tcs.tf32_split(x)
        for part in (hi, lo):
            assert not bool((part.view(torch.int32) & 0x1FFF).any())
        x64 = x.double()
        assert bool(((hi.double() - x64).abs() <= 2.0 ** -11 * x64.abs()).all())
        assert bool(((hi.double() + lo.double() - x64).abs() <= 2.0 ** -22 * x64.abs()).all())


@pytest.mark.parametrize("d_pad", [128, 1024])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_rank_matches_jax_kernel(case, d_pad):
    """The CUDA kernel's f32-rank arithmetic (3xTF32 from tf32_split) in
    plain PyTorch against the Pallas kernel at bf16_rank=False (HIGHEST) in
    interpret mode: the same windows finite (sentinel windows are inf from
    d_pad 384 on), the rest within SCAN_RTOL of |rank| + mean |c|^2."""
    caug, qaug, valid, qf, cents = _operands(case, d_pad)
    Q = qf.shape[0]
    jcaug, jqaugT, _, _ = jcs._augment(jnp.asarray(qf), jnp.asarray(cents), jnp.asarray(valid),
                                       d_pad)
    want = np.asarray(jcs.pallas_centroid_window_scan(jcaug, jqaugT, interpret=True,
                                                      bf16_rank=False)).T[:Q]
    got = tcs.centroid_window_scan_tf32x3(caug, qaug).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    # A window of sentinel rows only has |c|^2 ~ 1.3e38 at d_pad 128 and
    # inf from 384 on; every other window's minimum is a real rank.
    live = np.zeros(caug.shape[0], bool)
    live[: len(valid)] = valid
    dead = ~live.reshape(-1, tcs.L).any(1)
    np.testing.assert_array_equal(fin, np.broadcast_to(~dead | (d_pad < 384), fin.shape))
    cn2_mean = float((cents[valid].astype(np.float64) ** 2).sum(1).mean())
    rel = np.abs(got[fin] - want[fin]) / (np.abs(want[fin]) + cn2_mean)
    assert rel.max() <= SCAN_RTOL, rel.max()


@pytest.mark.parametrize("bad", [
    ("d_pad", 64), ("d_pad", 96), ("d_pad", 200), ("d_pad", 0),
    ("Cpad", 128), ("Cpad", 1536),
    ("dtype", torch.float64), ("dtype", torch.bfloat16), ("dtype", torch.float16),
])
def test_window_scan_refuses_what_the_kernel_does_not_take(bad):
    """d_pad must be a positive multiple of 128, Cpad of 1,024, both
    operands float32; each is refused before any device is chosen."""
    what, value = bad
    cpad, d_pad, dtype = 1024, 128, torch.float32
    if what == "d_pad":
        d_pad = value
    elif what == "Cpad":
        cpad = value
    else:
        dtype = value
    caug = torch.zeros((cpad, d_pad), dtype=dtype)
    qaug = torch.zeros((3, d_pad), dtype=dtype)
    with pytest.raises(TypeError if what == "dtype" else ValueError,
                       match="float32" if what == "dtype" else str(value)):
        tcs.centroid_window_scan(caug, qaug, True)
    if what == "dtype":  # either operand alone
        with pytest.raises(TypeError, match="float32"):
            tcs.centroid_window_scan(caug.float(), qaug, False)
