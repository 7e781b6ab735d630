"""A configuration, a traffic mix, a cell and metrics added as files and
entries alone are found by name and run, with no edit to the harness."""

import json
import shutil

from annbench import spec
from annbench.testing import run_small

READER = '''
def read(run):
    return {expr}
'''


def test_files_alone_make_a_new_cell(tmp_path):
    home = tmp_path / "annbench"
    for sub in ("configs", "traffic", "limits", "end_to_end", "layer_metrics"):
        (home / sub).mkdir(parents=True)
    config = json.loads((spec.HOME / "configs" / "sift1m-bf16.json").read_text())
    config["corpus"]["dim"] = 32
    (home / "configs" / "tiny.json").write_text(json.dumps(config))
    (home / "traffic" / "pairs.json").write_text(json.dumps(
        {"k": 5, "nprobe": 4, "reader": {"loop": "closed", "request": {"min": 2, "max": 2}}}))
    (home / "limits" / "tiny.pairs.json").write_text(json.dumps(
        {"dist_err": 1e-4, "wrong": 0, "missed": 0.01}))
    shutil.copy(spec.HOME / "end_to_end" / "setup_s.py", home / "end_to_end" / "setup_s.py")
    (home / "end_to_end" / "requests_done.py").write_text(
        READER.format(expr="sum(r.error is None for r in run.requests)"))
    (home / "layer_metrics" / "rows_asked.py").write_text(
        READER.format(expr="sum(len(r.rows) for r in run.requests)"))
    bench = {
        "command": ["python3", "annbench/run.py"], "paths": ["annbench"], "run_seconds": 10,
        "configs": [{"name": "tiny", "source": "a test", "file": "annbench/configs/tiny.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [{"name": "tiny.pairs", "config": "tiny", "traffic": "pairs",
                       "chips": 1, "why": "a test"}],
        "end_to_end": [
            {"name": "requests_done", "unit": "requests", "better": "higher", "bound": 0.05,
             "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [{"name": "rows_asked", "unit": "queries", "better": "higher",
                       "source": "host_clock", "layer": "Test", "moves": "requests_done"}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("tiny.pairs", tmp_path / "BENCHMARK.json")
    assert cell.config["corpus"]["dim"] == 32 and cell.traffic["k"] == 5
    assert [m["name"] for m in cell.per_layer] == ["rows_asked"]
    out = run_small("tiny.pairs", benchmark=tmp_path / "BENCHMARK.json")
    assert out.correct, out.checks
    assert out.metrics["requests_done"][0] == out.attempted > 0
    traced = run_small("tiny.pairs", benchmark=tmp_path / "BENCHMARK.json", trace=True)
    assert traced.metrics["rows_asked"][0] == 2 * traced.attempted


def test_every_named_piece_has_its_file():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert (cell.home / "limits" / f"{w['name']}.json").exists()
        for kind, group in (("end_to_end", cell.end_to_end), ("per_layer", cell.per_layer)):
            for m in group:
                assert callable(spec.load_reader(cell.home, m, kind))
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
