"""Rates, tails and windows on synthetic timestamps; the roofline's counts."""

import math

import numpy as np
import pytest

from annbench import spec
from annbench.clients import Request, WriterStep
from annbench.roofline import HBM_BPS, PEAK_OPS, bound_s, centroid_scan_work, rerank_work
from annbench.runner import Run
from annbench.stats import closed_window, percentile, quartile_spread, rate

def read(name, run, kind="end_to_end"):
    return spec.load_reader(spec.HOME, {"name": name}, kind)(run)


def fake_run(requests=(), steps=(), start=100.0, spans=None):
    return Run(None, 10.0, start, start + 10.0, 3.0, spans or {}, list(requests), list(steps),
               {}, None, {})


def req(due, start, end, m=1, error=None):
    return Request(due, start, end, np.arange(m), error=error)


def test_percentile_and_rate():
    assert percentile(range(1, 101), 99) == pytest.approx(99.01)
    assert percentile([1.0, math.inf], 50) == math.inf
    assert rate(50, 2.0) == 25.0 and math.isnan(rate(1, 0.0))
    assert closed_window(10.0, [11.0, 12.5, 12.0]) == 2.5


def test_quartile_spread_matches_statistics_quantiles():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    # statistics.quantiles(v, n=4) -> [10.75, 12.5, 14.25]
    assert quartile_spread(v) == pytest.approx((14.25 - 10.75) / 12.5)


def test_open_loop_tail_is_timed_from_the_due_time():
    # 100 requests due every 10 ms, each served in 1 ms, except that a 50 ms
    # stall at the 50th delays it and the four behind it.
    reqs, t = [], 100.0
    for i in range(100):
        due = 100.0 + 0.01 * i
        start = max(due, t)
        end = start + (0.05 if i == 50 else 0.001)
        reqs.append(req(due, start, end))
        t = end
    lat = sorted(r.end - r.due for r in reqs)
    assert read("search_p50_ms", fake_run(reqs)) == pytest.approx(1e3 * np.percentile(lat, 50))
    assert lat[-1] == pytest.approx(0.05) and lat[-5] > 0.005  # the four behind waited
    # a stall that delays half the requests moves the median by its wait
    late = [req(r.due, r.start + 0.02, r.end + 0.02) if i % 2 else r for i, r in enumerate(reqs)]
    assert read("search_p50_ms", fake_run(late)) > 1e3 * np.percentile(lat, 50) + 5


def test_failed_requests_miss_every_limit():
    reqs = [req(100.0 + i, 100.0 + i, 100.0 + i + 0.001) for i in range(49)]
    reqs += [req(200.0 + i, 200.0 + i, 200.0 + i, error="boom") for i in range(51)]
    assert read("search_p50_ms", fake_run(reqs)) == math.inf


def test_batch_rate_counts_answered_queries_over_the_whole_window():
    reqs = [req(100.0 + i, 100.0 + i, 101.0 + i, m=1000) for i in range(10)]
    reqs.append(req(110.0, 110.0, 110.5, m=1000, error="boom"))
    # 10,000 answered queries over 100.0 .. 110.0
    assert read("search_qps", fake_run(reqs)) == pytest.approx(1000.0)


def test_writer_costs_per_acknowledged_op():
    steps = [WriterStep(100.0 + i, np.arange(4), 100.0 + i, 100.5 + i, 4, np.arange(4),
                        100.5 + i, 101.0 + i, 2) for i in range(5)]
    spans = {"delete": [(100.5 + i, 101.0 + i, 4) for i in range(5)]}
    reader = spec.load_reader(spec.HOME, {"name": "lire.delete_ms_per_kop"}, "per_layer")
    # 2.5 s of delete calls for 10 acknowledged deletes
    assert reader(fake_run(steps=steps, spans=spans)) == pytest.approx(2.5e3 / (10 / 1e3))


def test_update_latency_is_timed_from_the_due_time():
    # Steps due every second, each 0.25 s long, except a 4.5 s stall in the
    # fourth: the five behind it start late, and their wait counts.
    steps, t = [], 100.0
    for i in range(9):
        due = 100.0 + i
        start = max(due, t)
        t = start + (4.5 if i == 3 else 0.25)
        steps.append(WriterStep(due, np.arange(2), start, start + 0.1, 2, np.arange(2),
                                start + 0.1, t, 2))
    lat = sorted(s.del_end - s.due for s in steps)
    assert lat[4] > 0.25 + 1e-9   # the median step waited behind the stall
    assert read("update_p50_ms", fake_run(steps=steps), "per_layer") == pytest.approx(
        1e3 * lat[4])
    steps[0].error = steps[1].error = steps[2].error = steps[5].error = steps[6].error = "boom"
    assert read("update_p50_ms", fake_run(steps=steps), "per_layer") == math.inf


def test_rerank_bytes_and_operations():
    lens = np.array([10, 20, 30, 0])
    probes = np.array([[0, 1], [1, 2], [2, 2]])   # posting 2 probed twice by query 2
    w = rerank_work(probes, lens, dim=128, storage="bfloat16")
    members = 10 + 20 + 30                          # each probed posting once
    pairs = (10 + 20) + (20 + 30) + (30 + 30)
    assert w["bytes"] == members * 128 * 2 + 3 * 128 * 4 + pairs * 4
    assert w["ops"] == 3 * 128 * pairs
    assert bound_s(w["bytes"], w["ops"], "f32") == max(w["bytes"] / HBM_BPS,
                                                      w["ops"] / PEAK_OPS["f32"])


def test_int8_rerank_bytes_and_operations():
    lens = np.array([10, 20, 30, 0])
    probes = np.array([[0, 1], [1, 2], [2, 2]])
    w = rerank_work(probes, lens, dim=128, storage="int8")
    members = 10 + 20 + 30                          # each probed posting once, a byte a value
    pairs = (10 + 20) + (20 + 30) + (30 + 30)
    postings = 3                                    # their centroids and scales, once
    assert w["bytes"] == members * 128 + 3 * 128 * 4 + pairs * 4 + postings * (128 * 4 + 4)
    assert w["ops"] == 4 * 128 * pairs              # dequantize, difference, multiply, add


def test_centroid_scan_bytes_and_operations():
    w = centroid_scan_work(8192, 40_000, 128)
    windows = 313                                   # 40,000 centroids in windows of 128
    assert w["ops"] == 3 * 2 * 8192 * 40_000 * 128  # three TF32 passes of the product
    assert w["bytes"] == 4 * (8192 * 128 + 40_000 * 128 + 8192 * windows)
    assert bound_s(w["bytes"], w["ops"], "tf32") == w["ops"] / PEAK_OPS["tf32"]
    assert centroid_scan_work(3, 128, 4) == {"ops": 3 * 2 * 3 * 128 * 4,
                                             "bytes": 4 * (3 * 4 + 128 * 4 + 3 * 1)}
