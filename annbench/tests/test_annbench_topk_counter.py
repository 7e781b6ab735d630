"""``topk.selects_per_query``: the program's ``topk.select.rows`` counter
over ``search.items``, on synthetic counters, on a program without the
counter, and in the batch cell's traced run at a tiny size."""

import pytest

from annbench import spec
from annbench.runner import Run
from annbench.testing import run_small

NAME = "topk.selects_per_query"


def read(counters):
    run = Run(None, 10.0, 0.0, 10.0, 1.0, {}, [], [], dict(counters), None, {})
    return spec.load_reader(spec.HOME, {"name": NAME}, "per_layer")(run)


@pytest.mark.parametrize("counters,want", [
    ({"search.items": 16_000.0, "topk.select.rows": 48_000.0}, 3.0),
    ({"search.items": 200.0, "topk.select.rows": 0.0}, 0.0),
    ({"search.items": 16_000.0}, None),                         # a program without the counter
    ({"search.items": 0.0, "topk.select.rows": 30.0}, None),    # no query searched
    ({}, None),
])
def test_reader(counters, want):
    assert read(counters) == (pytest.approx(want) if want is not None else None)


def test_declared_for_the_batch_cell():
    bench = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    m = bench[NAME]
    assert m["source"] == "program_counter" and m["moves"] == "search_qps"
    assert m["layer"] == "Search pipeline"
    assert m["workloads"] == ["sift1m-bf16.batch", "bigann4m-int8.batch"]


def test_batch_cell_selects_three_rows_a_query():
    out = run_small("sift1m-bf16.batch", trace=True, seconds=1.5)
    assert out.correct, out.checks
    assert out.metrics[NAME][0] == pytest.approx(3.0)
