"""Spans (``utils.profiling.span``) on the CPU: the counters each adds as it
closes, exact under threads; ``device_trace``'s export of the spans of every
thread on the profiler's timeline, and no record outside one; and the spans
of the search and live-update paths, read off small indexes."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spfresh_tpu_torch.index import Config, SpannIndexBuilder
from spfresh_tpu_torch.lire import LireConfig, SpFreshIndex
from spfresh_tpu_torch.lire.storage import LireStorageError
from spfresh_tpu_torch.utils import PhaseTimer, annotate, device_trace, metrics, profiling
from spfresh_tpu_torch.utils.profiling import current_span_id, span

torch.set_num_threads(2)


def totals(name):
    """(seconds, spans, items) of span ``name`` so far."""
    snap = metrics.snapshot()
    return tuple(snap.get(f"{name}.{part}", 0) for part in ("s", "n", "items"))


def grown(before, name):
    return tuple(a - b for a, b in zip(totals(name), before))


def traced(tmp_path, fn):
    """Run ``fn`` inside ``device_trace``; the exported trace."""
    out = tmp_path / "trace"
    with device_trace(str(out)):
        fn()
    (path,) = list(out.iterdir())
    return json.loads(path.read_text())


def spans_of(trace, name=None):
    return [e for e in trace["traceEvents"]
            if e.get("cat") == "spfresh_span" and (name is None or e["name"] == name)]


def encloses(outer, inner):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


# -- counters


def test_span_adds_seconds_count_and_items():
    before = totals("t.counts")
    with span("t.counts", 3):
        time.sleep(0.01)
    with span("t.counts") as sp:
        sp.items = 4
    s, n, items = grown(before, "t.counts")
    assert n == 2 and items == 7 and 0.01 <= s < 5


def test_nested_spans_each_count_and_the_outer_holds_the_inner():
    bo, bi = totals("t.outer"), totals("t.inner")
    with span("t.outer", 1):
        for _ in range(3):
            with span("t.inner", 2):
                time.sleep(0.002)
    so, no, io = grown(bo, "t.outer")
    si, ni, ii = grown(bi, "t.inner")
    assert (no, io, ni, ii) == (1, 1, 3, 6)
    assert so >= si >= 0.006


def test_three_threads_add_exact_totals():
    before = totals("t.threads")
    per = 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with span("t.threads", 1):
                    pass

        threads = [threading.Thread(target=work) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    _, n, items = grown(before, "t.threads")
    assert n == 3 * per and items == 3 * per


def test_span_totals_reset_and_unused_spans_stay_out_of_the_snapshot():
    m = metrics.Metrics()
    tot = m.span_totals("x")
    assert m.span_totals("x") is tot and m.snapshot() == {}
    tot.ns, tot.n, tot.items = 2_500_000_000, 2, 5
    assert m.snapshot() == {"x.s": 2.5, "x.n": 2.0, "x.items": 5.0}
    m.reset()
    assert m.snapshot() == {} and m.span_totals("x") is tot


def test_phase_timer_phase_is_a_span():
    before = totals("t.phase")
    timer = PhaseTimer("cpu")
    with timer.phase("t.phase", block=True):
        time.sleep(0.005)
    s, n, _ = grown(before, "t.phase")
    ((_, total, count),) = timer.totals()
    assert n == count == 1 and 0.005 <= total <= s  # the span holds the timed region


def test_no_program_span_calls_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    index, queries = small_index()
    before = totals("t.annotate")
    with annotate("t.annotate"), PhaseTimer("cpu").phase("t.annotate.phase"):
        index.search(queries, 5, nprobe=3)
    assert grown(before, "t.annotate")[1] == 1


# -- recording


def test_off_no_record_is_kept(tmp_path):
    assert profiling._recorder is None
    with span("t.off"):
        assert current_span_id() == 0
    trace = traced(tmp_path, lambda: None)
    assert spans_of(trace) == []
    assert trace["spfresh_spans"] == {"recorded": 0, "dropped": 0}
    assert profiling._recorder is None


def test_span_around_a_matmul_encloses_aten_mm_on_the_timeline(tmp_path):
    a = torch.ones(256, 256)
    ids = {}

    def body():
        with span("t.mm.request"):
            ids["root"] = current_span_id()
            with span("t.mm", 1):
                ids["mm"] = current_span_id()
                a @ a

    trace = traced(tmp_path, body)
    (root,), (mm_span,) = spans_of(trace, "t.mm.request"), spans_of(trace, "t.mm")
    mms = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert len(mms) == 1 and encloses(mm_span, mms[0]) and encloses(root, mm_span)
    assert mm_span["tid"] == mms[0]["tid"] == threading.get_native_id()
    assert root["args"] == {"id": ids["root"], "parent": 0, "request": ids["root"],
                            "cause": 0, "items": 0, "thread": threading.current_thread().name}
    assert mm_span["args"]["id"] == ids["mm"] != ids["root"]
    assert mm_span["args"]["parent"] == mm_span["args"]["request"] == ids["root"]
    assert trace["spfresh_spans"] == {"recorded": 2, "dropped": 0}


def test_a_span_on_another_thread_is_exported(tmp_path):
    seen = {}

    def other():
        with span("t.other", 5):
            seen["tid"] = threading.get_native_id()

    def body():
        th = threading.Thread(target=other, name="t-other-thread")
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()

    (ev,) = spans_of(traced(tmp_path, body), "t.other")
    assert ev["tid"] == seen["tid"] != threading.get_native_id()
    assert ev["args"]["thread"] == "t-other-thread" and ev["args"]["items"] == 5


def test_the_record_buffer_is_bounded_and_counts_what_it_dropped(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "RECORD_CAP", 5)

    def body():
        for _ in range(8):
            with span("t.cap"):
                pass

    trace = traced(tmp_path, body)
    assert len(spans_of(trace, "t.cap")) == 5
    assert trace["spfresh_spans"] == {"recorded": 5, "dropped": 3}


# -- the search path


def small_index(n=600, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = Config.from_dict({"clustering_params": {"initial_k": 4, "desired_cluster_size": 40,
                                                  "rng_seed": 42}})
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=False)
    return index, rng.standard_normal((37, dim)).astype(np.float32)


def test_search_spans_count_calls_batches_and_queries():
    index, queries = small_index()
    index.padded_view()
    names = ("search", "search.stage", "search.d2h", "view.refresh")
    before = {n: totals(n) for n in names}
    index.search(queries, 5, nprobe=3, batch_size=16)
    got = {n: grown(before[n], n) for n in names}
    assert got["search"][1:] == (1, 37)
    assert got["search.stage"][1:] == (3, 37)  # batches of 16, 16, 5
    assert got["search.d2h"][1] == 1
    assert got["view.refresh"][1] == 0  # the view was current
    assert got["search"][0] >= got["search.stage"][0] + got["search.d2h"][0]
    assert "search.queries" not in metrics.snapshot()


def test_view_refresh_counts_the_dirty_postings():
    index, queries = small_index()
    index.padded_view()
    cids = sorted(index.postings)[:2]
    for c in cids:
        ids, vecs = index.postings[c]
        index.replace_posting(c, ids[:-1], vecs[:-1])
    before = totals("view.refresh")
    index.search(queries, 5, nprobe=3)
    _, n, items = grown(before, "view.refresh")
    assert (n, items) == (1, 2)


# -- the live index


def build_fresh(tmp_path, n=120, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = Config.from_dict({"clustering_params": {"initial_k": 3, "desired_cluster_size": 20,
                                                  "rng_seed": 42}})
    index = SpannIndexBuilder(cfg, device="cpu").with_data(data).build(save=False)
    fresh = SpFreshIndex(index, str(tmp_path / "lire"),
                         LireConfig(max_partition_size=40, min_partition_size=2))
    return fresh, data, rng


def test_delete_batch_splits_into_storage_and_mirror(tmp_path):
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        names = ("lire.insert", "lire.delete", "lire.delete.storage", "lire.delete.mirror")
        before = {n: totals(n) for n in names}
        fresh.insert_batch(rng.standard_normal((10, 4)).astype(np.float32),
                           np.arange(1000, 1010))
        assert fresh.delete_batch(np.arange(0, 30)) == 30
        got = {n: grown(before[n], n) for n in names}
    assert got["lire.insert"][1:] == (1, 10)
    assert got["lire.delete"][1:] == (1, 30)
    storage, mirror = got["lire.delete.storage"][0], got["lire.delete.mirror"][0]
    assert storage > 0 and mirror > 0
    assert storage + mirror <= got["lire.delete"][0]


def test_insert_fallback_counts_the_batch(tmp_path):
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        orig = fresh.storage.store_vectors_multi
        calls = []

        def once(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise LireStorageError("destination retired")
            return orig(*a, **k)

        fresh.storage.store_vectors_multi = once
        before = totals("lire.insert.fallback")
        vecs = rng.standard_normal((7, 4)).astype(np.float32)
        fresh.insert_batch(vecs, np.arange(2000, 2007))
        _, n, items = grown(before, "lire.insert.fallback")
        assert (n, items) == (1, 7)
        ids, _ = fresh.search(vecs, k=1, nprobe=fresh.index.num_clusters)
    assert ids[:, 0].tolist() == list(range(2000, 2007))


def test_search_waits_for_the_live_index_lock(tmp_path):
    fresh, data, rng = build_fresh(tmp_path)
    with fresh:
        held = threading.Event()

        def holder():
            with fresh._lock:
                held.set()
                time.sleep(0.05)

        th = threading.Thread(target=holder)
        before = totals("lire.search.lock")
        th.start()
        assert held.wait(timeout=60)
        fresh.search(data[:3], k=2)
        th.join(timeout=60)
        assert not th.is_alive()
        s, n, _ = grown(before, "lire.search.lock")
    assert n == 1 and s >= 0.04


def test_background_op_is_a_span_caused_by_the_insert(tmp_path):
    fresh, data, rng = build_fresh(tmp_path)
    before, moved = totals("lire.op"), metrics.snapshot().get("lire.vectors_moved", 0)
    with fresh:
        # 60 vectors beside one row: its posting passes max_partition_size
        # and a Split (then a Reassign) runs on the worker.
        vecs = data[5] + 0.01 * rng.standard_normal((60, 4)).astype(np.float32)

        def body():
            fresh.insert_batch(vecs, np.arange(3000, 3060))
            fresh.flush()

        trace = traced(tmp_path, body)
    _, n, items = grown(before, "lire.op")
    assert n >= 1 and items == metrics.snapshot().get("lire.vectors_moved", 0) - moved
    (ins,) = spans_of(trace, "lire.insert")
    ops = spans_of(trace, "lire.op")
    assert ops and any(op["args"]["cause"] == ins["args"]["id"] for op in ops)
    assert all(op["tid"] != ins["tid"] for op in ops)
