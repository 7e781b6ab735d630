"""The readers of the program's ``search.stage.bytes`` and
``search.probe_chunks`` counters (``search.stage_gb_per_s``,
``search.probe_chunks_per_batch``): their arithmetic, None where a program
lacks the counter, their declarations, and every cell's traced run at a
tiny size with a program that lacks both counters, as an older program
does: the run still gives its result, without those two metrics."""

import pytest

from annbench import spec
from annbench.runner import Run
from annbench.system import ProgramSystem
from annbench.testing import run_small

COUNTERS = ("search.stage.bytes", "search.probe_chunks")
METRICS = {"search.stage_gb_per_s": ["gist1m-bf16.batch"],
           "search.probe_chunks_per_batch": ["sift1m-bf16.batch-np32"]}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def read(name, counters):
    run = Run(None, 10.0, 0.0, 10.0, 1.0, {}, [], [], dict(counters), None, {})
    return spec.load_reader(spec.HOME, {"name": name}, "per_layer")(run)


class WithoutCounters(ProgramSystem):
    """The program with the two counters taken out of what it reports."""

    @staticmethod
    def counters() -> dict:
        return {k: v for k, v in ProgramSystem.counters().items() if k not in COUNTERS}


@pytest.mark.parametrize("name,counters,want", [
    ("search.stage_gb_per_s", {"search.stage.bytes": 4.096e9, "search.stage.s": 2.0}, 2.048),
    ("search.stage_gb_per_s", {"search.stage.bytes": 0.0, "search.stage.s": 2.0}, 0.0),
    ("search.stage_gb_per_s", {"search.stage.s": 2.0, "search.stage.n": 5.0}, None),
    ("search.stage_gb_per_s", {"search.stage.bytes": 4.096e9, "search.stage.s": 0.0}, None),
    ("search.stage_gb_per_s", {}, None),
    ("search.probe_chunks_per_batch", {"search.probe_chunks": 3.0, "search.stage.n": 2.0}, 1.5),
    ("search.probe_chunks_per_batch", {"search.stage.n": 2.0}, None),
    ("search.probe_chunks_per_batch", {"search.probe_chunks": 3.0, "search.stage.n": 0.0}, None),
    ("search.probe_chunks_per_batch", {}, None),
])
def test_reader(name, counters, want):
    assert read(name, counters) == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_declared_for_the_new_cells(name):
    """Each metric names its new cell, and only cells that report the
    metric it moves: a later cell may join the list."""
    bench = spec.load_benchmark()
    m = {m["name"]: m for m in bench["per_layer"]}[name]
    assert m["source"] == "program_counter" and m["moves"] == "search_qps"
    assert set(METRICS[name]) <= set(m["workloads"])
    moved = {e["name"]: e for e in bench["end_to_end"]}["search_qps"]
    assert set(m["workloads"]) <= set(moved["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_without_the_counters_gives_its_result(cell):
    full = run_small(cell, trace=True, seconds=1.5)
    older = run_small(cell, trace=True, seconds=1.5, system_factory=WithoutCounters)
    assert full.correct and older.correct, (full.checks, older.checks)
    assert set(older.metrics) == set(full.metrics) - set(METRICS)
    new = {m["name"] for m in spec.cell(cell).per_layer} & set(METRICS)
    assert new <= set(full.metrics)
    if "search.probe_chunks_per_batch" in new:
        # Tiny batches fit the probe-chunk budget: one chunk a batch.
        assert full.metrics["search.probe_chunks_per_batch"][0] == 1.0
