"""The port's public surface against the JAX package's, on the CPU: each
package level's ``__all__``, the shared helpers on the same numpy inputs,
``PhaseTimer.report``/``reset``, ``device_trace``/``annotate``, and
``Config`` files read and written without pyyaml (held to pyyaml here,
where it is installed)."""

import dataclasses
import importlib
import json
import math
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

import spfresh_tpu
import spfresh_tpu_torch
from spfresh_tpu.clustering import compute_mean as j_compute_mean
from spfresh_tpu.core import as_f32_np as j_as_f32_np
from spfresh_tpu.index import Config as JConfig
from spfresh_tpu.ops import smallest_k_unique as j_smallest_k_unique
from spfresh_tpu.utils import PhaseTimer as JPhaseTimer
from spfresh_tpu_torch.clustering import compute_mean
from spfresh_tpu_torch.core import DEFAULT_POLICY, DtypePolicy, as_f32_np
from spfresh_tpu_torch.index import Config
from spfresh_tpu_torch.index.config import dump_yaml, load_yaml
from spfresh_tpu_torch.ops import smallest_k_unique
from spfresh_tpu_torch.utils import PhaseTimer, annotate, device_trace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_CONFIG = os.path.join(REPO, "examples", "example_config.yaml")
PORT_CONFIG = os.path.join(REPO, "spfresh_tpu_torch", "examples", "example_config.yaml")
METRICS = ("Euclidean", "Manhattan", "Chebyshev")

# The JAX package's exported names that the port does not carry over, each
# with its reason.  Every other name of every level's __all__ is exported.
NOT_CARRIED = {
    "parallel": {
        "default_mesh": "builds a jax.sharding.Mesh; a list of devices takes its place "
                        "(parallel.default_devices)",
        "replicate": "places an array on every device of a Mesh",
        "shard_rows": "places an array's rows over a Mesh's shard axis",
    },
}


def _levels():
    """Every package level of the JAX package that has an ``__all__``."""
    out = [""]
    for info in pkgutil.walk_packages(spfresh_tpu.__path__, "spfresh_tpu."):
        if info.ispkg and hasattr(importlib.import_module(info.name), "__all__"):
            out.append(info.name[len("spfresh_tpu."):])
    return sorted(out)


LEVELS = ("", "clustering", "core", "index", "io", "lire", "ops", "parallel", "utils")


def test_levels_cover_the_jax_package():
    assert _levels() == sorted(LEVELS)


@pytest.mark.parametrize("level", LEVELS)
def test_all_equals_jax_less_not_carried(level):
    jmod = importlib.import_module("spfresh_tpu" + (f".{level}" if level else ""))
    tmod = importlib.import_module("spfresh_tpu_torch" + (f".{level}" if level else ""))
    skip = NOT_CARRIED.get(level, {})
    assert set(skip) <= set(jmod.__all__)
    assert tmod.__all__ == [n for n in jmod.__all__ if n not in skip]
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


def test_parallel_keeps_default_devices():
    from spfresh_tpu_torch.parallel import default_devices
    from spfresh_tpu_torch.parallel.sharded import default_devices as d

    assert default_devices is d


def test_import_is_cheap():
    """Importing the package (and its examples) builds no kernel and
    starts no CUDA context."""
    code = ("import sys, torch\n"
            "import spfresh_tpu_torch, spfresh_tpu_torch.examples\n"
            "from spfresh_tpu_torch.ops import _build\n"
            "from spfresh_tpu_torch import native\n"
            "assert _build._lib is None and native._lib is None\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'spfresh_tpu.')) "
            "for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_version():
    assert spfresh_tpu_torch.__version__ == spfresh_tpu.__version__


# -- shared functions on the same numpy inputs


def _xy(seed, n=29, m=17, d=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
def test_distance_functions_match_jax(metric):
    x, y = _xy(0)
    got = spfresh_tpu_torch.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric)
    want = spfresh_tpu.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    got = spfresh_tpu_torch.ops.rowwise_distance(torch.from_numpy(x[:17]), torch.from_numpy(y),
                                                 metric)
    want = spfresh_tpu.ops.rowwise_distance(jnp.asarray(x[:17]), jnp.asarray(y), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got = spfresh_tpu_torch.distance(x[3], y[5], metric)
    want = spfresh_tpu.distance(x[3], y[5], metric)
    assert got.shape == () and np.asarray(want).shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_compute_mean_matches_jax(dtype):
    data = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]).astype(dtype)
    idx = np.array([0, 2])
    got = compute_mean(torch.from_numpy(data), torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), [3.0, 4.0])
    rng = np.random.default_rng(1)
    data = rng.standard_normal((50, 7)).astype(dtype)
    idx = rng.integers(0, 50, 23)
    got = compute_mean(torch.from_numpy(data), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_compute_mean(data, idx)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("x", [[1, 2, 3], np.arange(6, dtype=np.float64).reshape(2, 3),
                               np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2]])
def test_as_f32_np_matches_jax(x):
    got, want = as_f32_np(x), j_as_f32_np(x)
    assert got.dtype == want.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_default_policy():
    assert DEFAULT_POLICY == DtypePolicy() and DEFAULT_POLICY.storage == "float32"
    assert DEFAULT_POLICY.storage_dtype == torch.float32 and not DEFAULT_POLICY.quantized


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smallest_k_unique_matches_jax(seed):
    rng = np.random.default_rng(seed)
    Q, n, k = 6, 40, 5
    ids = rng.integers(0, 12, (Q, n)).astype(np.int32)
    # Copies of one id carry one distance, as replicas of one point do.
    per_id = rng.standard_normal((Q, 12)).astype(np.float32)
    dists = np.take_along_axis(per_id, ids, 1)
    dists[:, ::7] = np.inf
    gv, gi = smallest_k_unique(torch.from_numpy(dists), torch.from_numpy(ids), k)
    wv, wi = j_smallest_k_unique(jnp.asarray(dists), jnp.asarray(ids), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# -- PhaseTimer, device_trace, annotate


def _timed(timer):
    for name in ("a", "a", "b"):
        with timer.phase(name):
            pass
    timer._totals["a"], timer._totals["b"] = 0.25, 1.5  # fixed times, one format
    return timer


def test_phase_timer_report_and_reset_match_jax(caplog):
    port, ref = _timed(PhaseTimer(device="cpu")), _timed(JPhaseTimer())
    assert {n: c for n, _, c in port.totals()} == {"a": 2, "b": 1}
    with caplog.at_level("INFO"):
        text = port.report()
    assert text == ref.report()
    assert text.splitlines()[0].startswith("b ") and "(2x,   125.00 ms avg)" in text
    assert "phase timings:\n" + text in caplog.text
    port.reset()
    ref.reset()
    assert port.totals() == ref.totals() == [] and port.report() == ""


def test_device_trace_writes_a_trace_with_the_annotation(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        with annotate("spf_examples_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "spf_examples_region" for e in events)


# -- Config files without pyyaml


def _bench_config():
    """bench.py:369-385's config at its defaults."""
    return {
        "clustering_params": {"distance_metric": "Euclidean", "initialization_method": "KMeans++",
                              "initial_k": 16, "desired_cluster_size": 256, "rng_seed": 42},
        "output_path": "/tmp/spann_bench_idx",
        "storage_dtype": "bfloat16",
        "search": {"query_batch_size": 8192, "query_wire": None},
    }


@pytest.mark.parametrize("path", [EXAMPLE_CONFIG, PORT_CONFIG])
def test_from_file_equals_jax(path):
    assert Config.from_file(path).to_dict() == JConfig.from_file(path).to_dict()


def test_port_config_copy_is_byte_equal():
    with open(EXAMPLE_CONFIG, "rb") as a, open(PORT_CONFIG, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("make", [
    lambda C: C(),
    lambda C: C.from_file(EXAMPLE_CONFIG),
    lambda C: C.from_dict(_bench_config()),
    lambda C: C.from_dict({"clustering_params": {"initial_k": 7, "rng_seed": 3,
                                                 "soar_lambda": 1e-6,
                                                 "boundary_threshold": 1e16},
                           "output_path": "/tmp/x", "data_file": "null",
                           "search": {"prune_factor": 1.2, "query_wire": "int8"}}),
], ids=["default", "example", "bench", "edges"])
def test_str_equals_jax(make):
    port, ref = make(Config), make(JConfig)
    assert str(port) == str(ref)
    assert Config.from_dict(load_yaml(str(port))).to_dict() == port.to_dict()


# A realistic alphabet for paths and names: letters, digits, path
# punctuation, YAML indicators inside a name, a space.
_TEXT = st.one_of(
    st.text(alphabet="abcXYZ019/._-~ :#'\",[]{}!&*%@?|>=<\\", min_size=0, max_size=24),
    st.sampled_from(["null", "~", "yes", "No", "on", "true", "1e3", "1.0", "010", "0x1F",
                     "1_000", "1:30", "2024-01-01", "<<", "=", "-", "---", "- a", ".inf",
                     "data", "/tmp/spfresh idx", "C:\\data", ""]),
)
_FLOATS = st.one_of(st.floats(min_value=1.0, max_value=1e300),
                    st.sampled_from([1.0, 1.1, 1.25, 1e16, 1e17, 123456789.0, math.inf]))


@st.composite
def _raw_configs(draw):
    metric = draw(st.sampled_from(["Euclidean", "euclidean", "Manhattan", "Chebyshev"]))
    soar = None
    if metric.lower() == "euclidean":
        soar = draw(st.one_of(st.none(), st.floats(min_value=0.0, max_value=10.0),
                              st.sampled_from([0.0, 0.5, 1e-6, 5e-324])))
    opt_int = st.one_of(st.none(), st.integers(min_value=1, max_value=2**40))
    return {
        "clustering_params": {
            "distance_metric": metric,
            "initialization_method": draw(st.sampled_from(["Random", "KMeans++", "kmeans++"])),
            "initial_k": draw(st.integers(min_value=1, max_value=10**6)),
            "desired_cluster_size": draw(opt_int),
            "rng_seed": draw(st.one_of(st.none(), st.integers(-2**62, 2**62))),
            "replication": draw(st.sampled_from(["final", "nested"])),
            "max_replicas": draw(st.integers(min_value=1, max_value=64)),
            "boundary_threshold": draw(_FLOATS),
            "replica_overflow": draw(_FLOATS),
            "max_split_ways": draw(st.integers(min_value=2, max_value=128)),
            "soar_lambda": soar,
        },
        "output_path": draw(_TEXT),
        "data_file": draw(st.one_of(st.none(), _TEXT)),
        "storage_dtype": draw(st.sampled_from(["float32", "bfloat16", "int8"])),
        "build_sample_rows": draw(opt_int),
        "build_tile_rows": draw(opt_int),
        "search": {
            "nprobe": draw(opt_int),
            "prune_factor": draw(st.one_of(st.none(), _FLOATS)),
            "query_batch_size": draw(st.integers(min_value=1, max_value=2**20)),
            "engine": draw(st.sampled_from(["auto", "pallas", "xla"])),
            "slab_growth_slots": draw(st.integers(min_value=0, max_value=1024)),
            "query_wire": draw(st.sampled_from([None, "float32", "bfloat16", "int8"])),
        },
    }


@settings(max_examples=300, deadline=None)
@given(_raw_configs())
def test_yaml_round_trips_through_pyyaml(raw):
    cfg = Config.from_dict(raw)
    d = cfg.to_dict()
    text = str(cfg)
    assert text == yaml.safe_dump(d, sort_keys=False)
    assert yaml.safe_load(text) == d  # the port's writer, read by pyyaml
    assert load_yaml(yaml.safe_dump(d, sort_keys=False)) == d  # pyyaml's, read by the port
    assert str(JConfig.from_dict(raw)) == text


@pytest.mark.parametrize("doc", [
    "a: 1\nb:\n  c: 'x''y'\n  d: \"q\\\"x\\\\y\"\n",
    "a: ~\nb:\nc: -1.5e+3\nd: .inf\ne: -.Inf\nf: .nan\n",
    "  a: 1\n  b: 2\n",
    "a:\n    b:\n      c: 1\n    d: 2\ne: 3\n",
    "a: x # c\n# full line\n\nb: 'y' # c\nc: \"z\"#c\n",
    "a: 1.\nb: .5\nc: 0\nd: -0\ne: +7\nf: 1e-3\ng: 1e3\nh: -.5\n",
    "a: TRUE\nb: False\nc: NULL\nd: Null\n",
    "a: a,b\nb: x]\nc: a#b\nd: :a\ne: -a\nf: a:b\ng: a  b\n",
    "",
    "# only a comment\n",
], ids=range(10))
def test_reader_equals_pyyaml_on_the_subset(doc):
    got, want = load_yaml(doc), yaml.safe_load(doc)
    assert got == want or (json.dumps(got) == json.dumps(want))  # .nan != .nan


@pytest.mark.parametrize("doc,line", [
    ("a: {b: 1}\n", 1), ("a: [1, 2]\n", 1), ("a:\n  - 1\n", 2), ("- 1\n", 1),
    ("a: &x 1\n", 1), ("a: *x\n", 1), ("a: !!str 1\n", 1), ("a: |\n  x\n", 1),
    ("a: >\n  x\n", 1), ("---\na: 1\n", 1), ("a: 1\n---\nb: 2\n", 2), ("a: 1\n...\n", 2),
    ("%YAML 1.1\na: 1\n", 1), ("a:\tb\n", 1), ("\ta: 1\n", 1), ("a:\n  b: 1\n c: 2\n", 3),
    ("a: 1\n  b: 2\n", 2), ("a:\n  b: 1\n   c: 2\n", 3), ("a: 1\nb: x\n  y\n", 3),
    ("a: 010\n", 1), ("a: 0x1F\n", 1), ("a: 0b11\n", 1), ("a: 1_000\n", 1), ("a: 1:30\n", 1),
    ("a: 1_0.5\n", 1), ("a: yes\n", 1), ("a: Off\n", 1), ("a: 2024-01-01\n", 1),
    ("a: <<\n", 1), ("a: =\n", 1), ("a: 'x\n", 1), ("a: \"x\n", 1), ("a: 'x' y\n", 1),
    ("a: \"\\q\"\n", 1), ("a: b: c\n", 1), ("a: x:\n", 1), ("a: 1\na: 2\n", 2),
    ("? a\n: 1\n", 1), ("'a': 1\n", 1), ("yes: 1\n", 1), ("hello\n", 1), ("a: @x\n", 1),
    ("a: %x\n", 1), ("a: `x\n", 1), ("a: \x07\n", 1), ("a: \"\\x41\"\n", 1),
    ("a: \"\\t\"\n", 1), ("a: 1\nb: caf\u00e9\n", 2), ("# \u00e9\na: 1\n", 1),
], ids=range(49))
def test_unsupported_constructs_raise(doc, line, tmp_path):
    with pytest.raises(ValueError, match=f"line {line}:"):
        load_yaml(doc)
    p = tmp_path / "c.yaml"
    p.write_text(doc)
    with pytest.raises(ValueError, match=f"line {line}:"):
        Config.from_file(p)


def test_writer_rejects_what_a_config_cannot_hold():
    with pytest.raises(ValueError):
        dump_yaml({"a": [1, 2]})
    assert dump_yaml({"a": {}}) == yaml.safe_dump({"a": {}}, sort_keys=False)
    # What safe_dump would double-quote raises.
    for s in ("x\ny", "caf\u00e9", "a\tb", "\x07"):
        with pytest.raises(ValueError, match="outside printable ASCII"):
            dump_yaml({"a": s})


@pytest.mark.parametrize("value", ["/data/" + "x" * 90, "'" + "x" * 90, "a b" + "c" * 90,
                                   "x" * 80 + " y", "x" * 80 + "  y", "'" + "x" * 80 + " y",
                                   "x" * 100 + " ", " " + "x" * 100, "x" * 70 + " y" * 10])
@pytest.mark.parametrize("nested", [False, True])
def test_writer_long_strings_equal_safe_dump_or_raise(value, nested):
    """safe_dump folds a value at a lone space past column 80; the writer
    writes one line or raises, and never writes what safe_dump would not."""
    d = {"search": {"output_path": value}} if nested else {"output_path": value}
    want = yaml.safe_dump(d, sort_keys=False)
    try:
        got = dump_yaml(d)
    except ValueError as e:
        assert "folds" in str(e) and want.count("\n") > 1 + nested
    else:
        assert got == want and load_yaml(got) == d


def test_from_file_without_pyyaml():
    """As on a machine with no pyyaml: ``yaml`` cannot be imported."""
    code = ("import sys\n"
            "sys.modules['yaml'] = None\n"
            "import importlib, pkgutil\n"
            "import spfresh_tpu_torch, spfresh_tpu_torch.examples as ex\n"
            "for m in pkgutil.iter_modules(ex.__path__):\n"
            "    importlib.import_module('spfresh_tpu_torch.examples.' + m.name)\n"
            "from spfresh_tpu_torch.index import Config\n"
            "from spfresh_tpu_torch.examples.build_index import CONFIG\n"
            "cfg = Config.from_file(CONFIG)\n"
            "assert cfg.initial_k == 4 and cfg.search.query_batch_size == 256\n"
            "print(cfg)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert yaml.safe_load(r.stdout) == JConfig.from_file(EXAMPLE_CONFIG).to_dict()


def test_builder_takes_a_config_path(tmp_path):
    from spfresh_tpu_torch.index import SpannIndexBuilder

    b = SpannIndexBuilder(PORT_CONFIG, device="cpu")
    assert dataclasses.asdict(b.config) == dataclasses.asdict(Config.from_file(PORT_CONFIG))
