"""The port's example CLIs (``spfresh_tpu_torch/examples/``) on the CPU,
the twin of ``tests/test_examples.py``: the reference-parity slice (the 6x2
toy corpus answers query (1.0, 2.0), k=1 with point_id 0, after build and
after load, across packages both ways), and each other script run small
beside the JAX package's own script on the same seeds.

The two packages draw initial seeds from different generators (jax.random
against numpy Philox), so the port's runs take the JAX package's initial
seeds (``jax_seeds``); the deterministic numbers the scripts print then
equal the JAX script's.  ``live_updates`` and ``disk_updates`` print
posting counts after background splits and merges that differ between
runs of the JAX script itself (``live_updates`` from one run to the next,
``disk_updates`` when the host is loaded), so for those lines only their
invariants are held.  The JAX scripts run in this process, their fixed store
paths redirected into ``tmp_path``; ``sharded_search`` runs on the
``["cpu"] * 8`` list here and on the JAX package's 8-device CPU mesh of
``tests/conftest.py``.
"""

import ast
import dataclasses
import importlib
import importlib.util
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from spfresh_tpu.clustering import hierarchical as jh
from spfresh_tpu_torch.clustering import hierarchical as th
from spfresh_tpu_torch.utils import metrics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("build_index", "load_index", "live_updates", "disk_updates", "quantized_index",
         "sharded_search", "sift_eval")


@pytest.fixture
def jax_seeds(monkeypatch):
    """Every port build takes the initial seeds the JAX package draws for
    the same clustering params and (wire-rounded) corpus."""

    def init(self, k):
        ref = jh.HierarchicalClustering(jh.ClusteringParams(**dataclasses.asdict(self.params)),
                                        self._host_data)
        ref._initialize_clusters(k)
        self.clusters = [th.Cluster(int(c.centroid_idx), np.empty((0,), np.int64), 0)
                         for c in ref.clusters]

    monkeypatch.setattr(th.HierarchicalClustering, "_initialize_clusters", init)


def port(name, capsys, *argv):
    """Run ``spfresh_tpu_torch.examples.<name>`` on the CPU; its stdout
    lines after the device line."""
    capsys.readouterr()
    mod = importlib.import_module(f"spfresh_tpu_torch.examples.{name}")
    mod.main(["--device", "cpu", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu", lines
    return lines[1:]


def load_jax(name):
    """The JAX package's ``examples/<name>.py`` as a module (what a
    module-level script does runs here)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_out(capsys, run):
    capsys.readouterr()
    run()
    return capsys.readouterr().out.splitlines()


def heads(lines):
    """Each line's text before its first number or colon: the format."""
    return [re.split(r"[:\d]", line)[0] for line in lines]


def number(line, pattern):
    return float(re.search(pattern, line).group(1))


def test_build_then_load_keep_point_id(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert port("build_index", capsys) == ["[PointData(point_id=0, vector=[1.0, 2.0])]"]
    assert port("load_index", capsys) == ["Nearest neighbour: point_id: 0 and vector: [1.0, 2.0]"]
    assert (tmp_path / "data").is_dir()


def test_build_and_load_across_packages(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    # The JAX package builds, the port loads.
    out = jax_out(capsys, load_jax("build_index").main)
    assert out == ["[PointData(point_id=0, vector=[1.0, 2.0])]"]
    assert port("load_index", capsys) == ["Nearest neighbour: point_id: 0 and vector: [1.0, 2.0]"]
    # The port builds over it, the JAX package loads.
    assert port("build_index", capsys) == ["[PointData(point_id=0, vector=[1.0, 2.0])]"]
    out = jax_out(capsys, load_jax("load_index").main)
    assert out == ["Nearest neighbour: point_id: 0 and vector: [1.0, 2.0]"]


def _redirect(mod, tmp_path, **names):
    """Point the JAX script's fixed store paths into ``tmp_path``."""
    mod.shutil = types.SimpleNamespace(rmtree=lambda *a, **k: None)
    for name, make in names.items():
        setattr(mod, name, make)


def test_live_updates(tmp_path, capsys, jax_seeds):
    from spfresh_tpu.lire import SpFreshIndex as JSpFreshIndex

    ref = load_jax("live_updates")
    _redirect(ref, tmp_path, SpFreshIndex=lambda index, store, cfg: JSpFreshIndex(
        index, str(tmp_path / "jax_store"), cfg))
    want = jax_out(capsys, ref.main)
    metrics.DEFAULT.reset()
    got = port("live_updates", capsys)
    assert heads(got) == heads(want)
    assert got[0] == want[0]  # "built: N posting lists"
    built = number(got[0], r"built: (\d+)")
    after = number(got[1], r"inserts: (\d+) posting")
    assert number(got[1], r"was (\d+);") == built and after > built  # a posting split
    nearest = ast.literal_eval(got[2].split(":", 1)[1].strip())
    assert len(nearest) == 5 and all(10_000 <= i < 10_400 for i in nearest)
    assert 0 < number(got[3], r"deletes: (\d+) posting") <= after
    counters = ast.literal_eval(got[4].split(":", 1)[1].strip())
    assert counters["lire.insert"] == 400 and counters["lire.delete"] >= 400
    assert counters["lire.split.ok"] >= 1


def test_disk_updates(tmp_path, capsys, jax_seeds):
    from spfresh_tpu.index import SpannIndexBuilder as JBuilder
    from spfresh_tpu.lire import LazySpFreshIndex as JLazy

    where = str(tmp_path / "jax_idx")

    class Builder(JBuilder):
        def build(self, *a, **kw):
            index = super().build(*a, **kw)
            save = index.save
            index.save = lambda directory, format: save(where, format=format)
            return index

    ref = load_jax("disk_updates")
    _redirect(ref, tmp_path, SpannIndexBuilder=Builder,
              LazySpFreshIndex=lambda directory, **kw: JLazy(where, **kw))
    want = jax_out(capsys, ref.main)
    got = port("disk_updates", capsys)
    assert heads(got) == heads(want)
    assert got[0].split(" -> ")[0] == want[0].split(" -> ")[0]  # "built+saved: N posting lists"
    built = number(got[0], r"saved: (\d+)")
    after = number(got[1], r"inserts: (\d+) posting")
    assert number(got[1], r"was (\d+)\)") == built and after > built  # postings split
    assert number(got[1], r"overlay rows: (\d+)") >= 400
    nearest = ast.literal_eval(got[2].split(":", 1)[1].strip())
    assert len(nearest) == 5 and all(10_000 <= i < 10_400 for i in nearest)
    assert 0 < number(got[3], r"deletes: (\d+) posting") <= after
    assert got[4:] == want[4:] == ["compacted: overlay rows now 0",
                                   "self-query after compaction returns id 0"]


def test_quantized_index(capsys, jax_seeds):
    got = port("quantized_index", capsys)
    want = jax_out(capsys, lambda: load_jax("quantized_index"))
    assert heads(got) == heads(want) and len(got) == 2
    for g, w in zip(got, want):
        assert g.split()[0] == w.split()[0]
        assert number(g, r"slab HBM=\s*([\d.]+)") == number(w, r"slab HBM=\s*([\d.]+)")
    recall = r"recall@10=([\d.]+)"
    assert number(got[0], recall) == number(want[0], recall)  # float32, exactly
    assert abs(number(got[1], recall) - number(want[1], recall)) <= 0.005  # int8


def test_sharded_search(capsys, jax_seeds):
    got = port("sharded_search", capsys)
    ref = load_jax("sharded_search")  # the 8-device CPU mesh of conftest.py
    want = jax_out(capsys, ref.main)
    assert got[0] == "devices: 8 x cpu" and want[0] == "devices: 8 x cpu"
    assert got[1:] == want[1:]
    assert "self-NN exact for all 16 queries" in got[1] and "search sees id 90000" in got[2]


def test_sharded_search_takes_shards(capsys, jax_seeds):
    got = port("sharded_search", capsys, "--shards", "3")
    assert got[0] == "devices: 3 x cpu" and "search sees id 90000" in got[2]


def _sift_build(line):
    return re.sub(r"build: [\d.]+s", "build: _s", line)


def test_sift_eval_synthetic(capsys, monkeypatch, jax_seeds):
    got = port("sift_eval", capsys, "--n", "2000")
    monkeypatch.setattr(sys, "argv", ["sift_eval.py", "--n", "2000"])
    want = jax_out(capsys, load_jax("sift_eval").main)
    assert _sift_build(got[0]) == _sift_build(want[0])  # clusters, vectors, replication
    recall = r"recall@10=([\d.]+)"
    assert number(got[1], recall) == number(want[1], recall)


def test_sift_eval_from_files(tmp_path, capsys):
    """The same synthetic corpus through fvecs/ivecs files and the native
    reader: the same build and recall as the in-memory run, also per
    nprobe with ``--sweep``."""
    from spfresh_tpu_torch.eval import make_groundtruth
    from spfresh_tpu_torch.io import write_fvecs, write_ivecs

    rng = np.random.default_rng(12345)
    data = rng.standard_normal((2000, 32)).astype(np.float32)
    queries = rng.standard_normal((100, 32)).astype(np.float32)
    gt = make_groundtruth(data, queries, 10, device="cpu")
    paths = {k: str(tmp_path / f"{k}.{ext}") for k, ext in
             (("base", "fvecs"), ("query", "fvecs"), ("gt", "ivecs"))}
    write_fvecs(paths["base"], data)
    write_fvecs(paths["query"], queries)
    write_ivecs(paths["gt"], gt.astype(np.int32))
    files = ["--base", paths["base"], "--query", paths["query"], "--gt", paths["gt"]]
    mem = port("sift_eval", capsys, "--n", "2000", "--dim", "32")
    got = port("sift_eval", capsys, *files)
    assert _sift_build(got[0]) == _sift_build(mem[0])
    assert got[1].split()[0] == mem[1].split()[0]
    sweep = port("sift_eval", capsys, *files, "--sweep", "--storage-dtype", "bfloat16")
    assert [line.split()[0] for line in sweep[1:]] == [f"nprobe={p:4d}".split()[0]
                                                         for p in (1, 2, 4, 8, 16)]
    recalls = [number(line, r"recall@10=([\d.]+)") for line in sweep[1:]]
    assert recalls == sorted(recalls) and recalls[-1] >= 0.9


@pytest.mark.parametrize("name", NAMES)
def test_default_device_needs_a_card(name, monkeypatch):
    """``--device`` left at "cuda" raises without a card; nothing runs on
    the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"spfresh_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main([])
