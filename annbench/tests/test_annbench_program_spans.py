"""The per-layer metrics read off the program's own span counters
(``source: program_counter``): each reader on synthetic counters and
writer steps, and each cell's traced run at a tiny size, which reads every
such metric of the cell."""

import numpy as np
import pytest

from annbench import spec
from annbench.clients import WriterStep
from annbench.runner import Run
from annbench.testing import run_small

NEW = ("search.stage_ms_per_kq", "search.host_ms", "search.d2h_ms", "view.refresh_ms_per_kop",
       "lire.lock_wait_ms", "lire.delete_storage_ms_per_kop", "lire.delete_mirror_ms_per_kop",
       "lire.insert_fallback_per_kop", "lire.bg_ms_per_kop")


def read(name, counters, steps=()):
    run = Run(None, 10.0, 0.0, 10.0, 1.0, {}, [], list(steps), dict(counters), None, {})
    return spec.load_reader(spec.HOME, {"name": name}, "per_layer")(run)


def step(ins, dels):
    return WriterStep(0.0, np.arange(ins), 0.0, 0.1, ins, np.arange(dels), 0.1, 0.2, dels)


STEPS = [step(32, 32), step(32, 30)]  # 64 inserts, 62 deletes acknowledged

SEARCH = {"search.s": 2.0, "search.n": 800.0, "search.items": 16_000.0,
          "search.stage.s": 0.4, "search.d2h.s": 0.24}
LIVE = {"view.refresh.s": 0.63, "view.refresh.n": 40.0,
        "lire.search.lock.s": 0.3, "lire.search.lock.n": 600.0,
        "lire.insert.s": 1.0, "lire.insert.n": 2.0, "lire.delete.s": 0.5, "lire.delete.n": 2.0,
        "lire.delete.storage.s": 0.124, "lire.delete.mirror.s": 0.186,
        "lire.insert.fallback.items": 16.0, "lire.op.s": 2.52}


@pytest.mark.parametrize("name,want", [
    ("search.stage_ms_per_kq", 1e3 * 0.4 / 16),
    ("search.host_ms", 1e3 * (2.0 - 0.24) / 800),
    ("search.d2h_ms", 1e3 * 0.24 / 800),
    ("view.refresh_ms_per_kop", 1e3 * 0.63 / 0.126),
    ("lire.lock_wait_ms", 1e3 * 0.3 / 600),
    ("lire.delete_storage_ms_per_kop", 1e3 * 0.124 / 0.062),
    ("lire.delete_mirror_ms_per_kop", 1e3 * 0.186 / 0.062),
    ("lire.insert_fallback_per_kop", 16 / 0.064),
    ("lire.bg_ms_per_kop", 1e3 * 2.52 / 0.126),
])
def test_reader_arithmetic(name, want):
    assert read(name, {**SEARCH, **LIVE}, STEPS) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_none_without_a_denominator_or_the_programs_spans(name):
    assert read(name, {}, STEPS) is None  # a program without these spans
    zero = {**SEARCH, **LIVE, "search.n": 0, "search.items": 0, "lire.search.lock.n": 0}
    assert read(name, zero, [step(0, 0)]) is None


@pytest.mark.parametrize("name", ["lire.insert_fallback_per_kop", "lire.bg_ms_per_kop"])
def test_a_count_of_nothing_reads_zero(name):
    live = {k: v for k, v in LIVE.items()
            if k not in ("lire.insert.fallback.items", "lire.op.s")}
    assert read(name, live, STEPS) == 0.0


def test_the_metrics_are_declared_program_counters():
    bench = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    assert set(NEW) <= set(bench)
    assert all(bench[n]["source"] == "program_counter" for n in NEW)


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_traced_run_reads_every_program_counter_metric(cell):
    out = run_small(cell, trace=True, seconds=1.5)
    assert out.correct, out.checks
    want = {m["name"] for m in spec.cell(cell).per_layer if m["name"] in NEW}
    assert want and want <= set(out.metrics)
    if "search.host_ms" in want and "online.service_ms" in out.metrics:
        inside = out.metrics["search.host_ms"][0] + out.metrics["search.d2h_ms"][0]
        assert inside <= out.metrics["online.service_ms"][0]
    if "lire.delete_storage_ms_per_kop" in want:
        parts = (out.metrics["lire.delete_storage_ms_per_kop"][0]
                 + out.metrics["lire.delete_mirror_ms_per_kop"][0])
        assert 0 < parts <= out.metrics["lire.delete_ms_per_kop"][0]
