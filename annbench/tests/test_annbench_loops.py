"""Each cell's whole run at a tiny size on the CPU: inputs, set-up, the
cell's client loop, the comparison."""

import numpy as np
import pytest

from annbench import spec
from annbench.testing import run_small

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_small(name):
    out = run_small(name)
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted > 0
    assert {m["name"] for m in spec.cell(name).end_to_end} <= set(out.metrics)
    assert out.checks["wrong"][0] == 0


def test_traced_run_reads_per_layer_metrics():
    out = run_small("sift1m-spfresh.churn", trace=True, seconds=1.5)
    assert out.correct, out.checks
    names = set(out.metrics)
    assert {"build_s", "lire.insert_ms_per_kop", "lire.delete_ms_per_kop",
            "update_p50_ms"} <= names
    assert "search_p50_ms" not in names  # a traced run reports its per-layer metrics only
    # no device on the CPU: the device readers find nothing to read
    assert "device_idle_pct.churn" not in names


def test_open_loop_serves_every_request_due():
    out = run_small("sift1m-bf16.online", seconds=1.0)
    due = [r.due - out.run.window_start for r in out.run.requests]
    assert due == sorted(due) and max(due) < 1.0
    assert all(r.start >= r.due - 1e-3 for r in out.run.requests)


def test_writer_is_an_open_loop_on_its_schedule():
    out = run_small("sift1m-spfresh.churn", seconds=1.0)
    steps = out.run.steps
    due = np.array([st.due for st in steps]) - out.run.window_start
    w = out.run.cell.traffic["writer"]
    period = (w["insert"] + w["delete"]) / w["rate_ops_per_s"]
    # every step due in the window was made, each at or after its due time
    assert len(steps) == int(np.ceil(1.0 / period))
    np.testing.assert_allclose(due, period * np.arange(len(steps)), atol=1e-9)
    assert all(st.ins_start >= st.due for st in steps)
