"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

Beside ``BENCHMARK.json`` the benchmark's folder holds one file for each
piece, found by name: ``configs/<config>.json`` (the ``file`` of the
configuration's entry), ``traffic/<mix>.json``, ``limits/<cell>.json`` (the
limits of the numbers ``correct`` compares), ``end_to_end/<metric>.py`` and
``layer_metrics/<metric>.py`` (each a ``read(run)`` that returns the number,
or None where the run has nothing to read; a metric ``<quantity>.<part>``,
one quantity split by the end-to-end metric it moves, may share the
quantity's ``<quantity>.py``).  Adding a configuration, a mix,
a cell or a metric is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

HOME = Path(__file__).resolve().parent
BENCHMARK = HOME.parent / "BENCHMARK.json"
KINDS = {"end_to_end": "end_to_end", "per_layer": "layer_metrics"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    home: Path


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    names; without the key, an end-to-end metric is every cell's and a
    per-layer one is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, path: Path = BENCHMARK) -> Cell:
    path = Path(path)
    bench = load_benchmark(path)
    root = path.parent
    home = root / "annbench"
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {path}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, int(w["chips"]), w["config"], json.loads((root / conf["file"]).read_text()),
                w["traffic"], json.loads((home / "traffic" / f"{w['traffic']}.json").read_text()),
                e2e, layer, home)


def load_reader(home: Path, metric: dict, kind: str):
    """The ``read`` function of a metric's own module: ``<name>.py``, or for
    a quantity split by the end-to-end metric it moves (``<quantity>.<part>``)
    without a file of its own, the quantity's ``<quantity>.py``."""
    path = Path(home) / KINDS[kind] / f"{metric['name']}.py"
    if not path.exists() and "." in metric["name"]:
        path = path.with_name(f"{metric['name'].rsplit('.', 1)[0]}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"annbench_{KINDS[kind]}_{metric['name'].replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
