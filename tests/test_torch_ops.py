"""spfresh_tpu_torch foundations against the JAX package on the CPU:
distances, tie-stable top-k, dtype policy, timers, the kernel build
helpers, and the two process-level guarantees (the port imports no jax;
chip_smoke.py refuses to run without a GPU)."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spfresh_tpu.ops import distances as jd
from spfresh_tpu.ops import topk as jt
from spfresh_tpu_torch.core.dtypes import DtypePolicy, bf16_round_np
from spfresh_tpu_torch.ops import _build
from spfresh_tpu_torch.ops import distances as td
from spfresh_tpu_torch.ops import topk as tt
from spfresh_tpu_torch.utils import metrics
from spfresh_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("Euclidean", "Manhattan", "Chebyshev")


def _xy(seed, n=37, m=23, d=19):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("exact", [False, True])
def test_pairwise_matches_jax(metric, exact):
    x, y = _xy(1)
    got = td.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric, exact=exact)
    want = np.asarray(jd.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric, exact=exact))
    # rtol 1e-5: f32 sums in another order.  The Euclidean expansion also
    # cancels |x|^2 + |y|^2 ~ 40 down to the distance, so its absolute
    # error is ~eps * 40; atol 1e-5 * 40 covers that.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=4e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_rowwise_and_single_distance_match_jax(metric):
    x, y = _xy(2, n=50, m=50)
    got = td.rowwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric)
    want = np.asarray(jd.rowwise_distance(jnp.asarray(x), jnp.asarray(y), metric))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)  # f32 summation order
    one = td.distance(x[0], y[0], metric)
    np.testing.assert_allclose(float(one), float(jd.distance(x[0], y[0], metric)), rtol=1e-5)


def test_bf16_expansion_upcasts_before_matmul():
    """bf16 inputs must give f32 sums of exact products (the reference's
    preferred_element_type=f32), not a bf16-rounded product matrix."""
    x, y = _xy(3, d=64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    got = td.pairwise_distance(xb, yb)
    want = np.asarray(jd.pairwise_distance(jnp.asarray(x.astype(ml_dtypes.bfloat16)),
                                           jnp.asarray(y.astype(ml_dtypes.bfloat16))))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)  # expansion, |x|^2 ~ 130


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_canonical_metric():
    assert td.canonical_metric(" euclidean ") == "Euclidean"
    with pytest.raises(ValueError):
        td.canonical_metric("cosine")


def _tied(seed, shape, levels=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, shape).astype(np.float32)  # many exact ties


@pytest.mark.parametrize("k", [1, 4, 17])
def test_smallest_k_tie_order_matches_lax_top_k(k):
    d = _tied(4, (9, 40))
    d[0, :] = 2.0  # a row of all-equal values
    d[1, 5] = np.inf
    got_v, got_i = tt.smallest_k(torch.from_numpy(d), k)
    want_v, want_i = jt.smallest_k(jnp.asarray(d), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))  # ties to lower index
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    with pytest.raises(ValueError):
        tt.smallest_k(torch.from_numpy(d), 41)


def test_smallest_k_orders_negative_values():
    d = np.array([[0.5, -1.0, -3.0, 2.0, -1.0, 0.0]], np.float32)
    v, i = tt.smallest_k(torch.from_numpy(d), 6)
    np.testing.assert_array_equal(i.numpy()[0], [2, 1, 4, 5, 0, 3])
    np.testing.assert_array_equal(v.numpy()[0], np.sort(d[0]))


@pytest.mark.parametrize("max_dup", [1, 2, 8])
def test_smallest_k_unique_matches_jax(max_dup):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 12, (6, 30)).astype(np.int32)
    d = _tied(6, (6, 30), levels=8)
    # Duplicate copies of an id carry identical distances, as in an index.
    for r in range(6):
        for j in range(30):
            d[r, j] = d[r, np.argmax(ids[r] == ids[r, j])]
    d[0, :4] = np.inf
    got_v, got_i = tt.smallest_k_unique(torch.from_numpy(d), torch.from_numpy(ids), 5, max_dup)
    want_v, want_i = jt.smallest_k_unique(jnp.asarray(d), jnp.asarray(ids), 5, max_dup)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_smallest_k_unique_pads_short_rows():
    d = torch.tensor([[1.0, 0.5]])
    ids = torch.tensor([[7, 9]], dtype=torch.int32)
    v, i = tt.smallest_k_unique(d, ids, 4)
    want_v, want_i = jt.smallest_k_unique(jnp.asarray(d.numpy()), jnp.asarray(ids.numpy()), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("with_valid", [False, True])
def test_centroid_topk_matches_jax(with_valid):
    x, c = _xy(7, n=40, m=70, d=16)
    valid = np.ones(70, bool)
    if with_valid:
        valid[50:] = False
    tv = torch.from_numpy(valid) if with_valid else None
    jv = jnp.asarray(valid) if with_valid else None
    gd, gi = tt.centroid_topk(torch.from_numpy(x), torch.from_numpy(c), tv, 6, "Euclidean")
    wd, wi = jt.centroid_topk(jnp.asarray(x), jnp.asarray(c), jv, 6, "Euclidean")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=2e-4)  # expansion


def test_dtype_policy():
    assert DtypePolicy("bfloat16").storage_dtype == torch.bfloat16
    assert DtypePolicy().storage_dtype == torch.float32
    assert DtypePolicy("int8").storage_dtype == torch.int8  # residual IVF-SQ8
    with pytest.raises(ValueError):
        DtypePolicy("float16")


def test_bf16_round_matches_ml_dtypes():
    x = np.random.default_rng(8).standard_normal((64, 33)).astype(np.float32) * 1e3
    np.testing.assert_array_equal(
        bf16_round_np(x), x.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_phase_timer_and_metrics():
    t = PhaseTimer("cpu")
    with t.phase("a", block=True):
        pass
    with t.phase("a"):
        pass
    (name, total, count), = t.totals()
    assert (name, count) == ("a", 2) and total >= 0
    m = metrics.Metrics()
    m.inc("x")
    m.inc("x", 2)
    m.set_gauge("g", 5)
    assert m.snapshot() == {"x": 3.0, "g": 5}


def test_build_raises_without_nvcc(monkeypatch):
    """A missing toolkit is an error, never a silent fallback."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_cache_key_covers_sources():
    path = _build._library_path()
    assert path.parent == _build.BUILD_DIR
    assert [p.name for p in _build.sources()] == ["centroid_scan.cu", "pairwise.cu", "replica.cu",
                                                  "rerank.cu", "rerank_int8mxu.cu",
                                                  "topk_select.cu"]
    assert path.name.startswith("libspfresh_kernels_") and path.suffix == ".so"


def _imports_reference(src: str) -> bool:
    return any(pat in src for pat in ("import jax", "from jax", "import spfresh_tpu\n",
                                      "import spfresh_tpu.", "from spfresh_tpu ",
                                      "from spfresh_tpu."))


def test_port_imports_without_jax():
    """Every port module imports with jax and the JAX package blocked, and
    neither the package nor chip_smoke.py names either."""
    pkg = os.path.join(REPO, "spfresh_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert not _imports_reference(src), f
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    assert not _imports_reference(open(os.path.join(REPO, "chip_smoke.py")).read())
    code = ("import sys; sys.modules['jax'] = None; sys.modules['spfresh_tpu'] = None\n"
            + "".join(f"import {m}\n" for m in sorted(mods)) + "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("entry", ["builder", "index", "load", "brute_force", "clustering",
                                   "interop", "timer"])
def test_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """Every entry point defaults to the card: without one, constructing it
    with the default device raises instead of falling back to the CPU."""
    from spfresh_tpu_torch.clustering.hierarchical import ClusteringParams, HierarchicalClustering
    from spfresh_tpu_torch.index import Config, SpannIndex, SpannIndexBuilder, brute_force_search
    from spfresh_tpu_torch.interop import from_jax_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((8, 4), np.float32)
    build = {
        "builder": lambda: SpannIndexBuilder(Config()),
        "index": lambda: SpannIndex(Config()),
        "load": lambda: SpannIndex.load(str(tmp_path)),
        "brute_force": lambda: brute_force_search(data, data, 2),
        "clustering": lambda: HierarchicalClustering(ClusteringParams(), data),
        "interop": lambda: from_jax_state({}, {}, 4, {}),
        "timer": lambda: PhaseTimer(),
    }[entry]
    (tmp_path / "manifest.json").write_text('{"config": {}}')  # what load reads first
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build()
