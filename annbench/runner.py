"""One run of one cell: the inputs from the seed, the system's set-up and
warm-up, the measured window, the traced slice, and the comparison.

``execute`` returns an ``Outcome``; ``run.py`` prints it.  Every metric is a
reader of its own (``end_to_end/<name>.py``, ``layer_metrics/<name>.py``)
that takes the ``Run`` record, so a new metric is a new file.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from annbench import spec
from annbench.check import Answers, Ledger, compare
from annbench.clients import Recorder, Request, Spans, Traffic, WriterStep, now, run_reader, \
    run_writer
from annbench.data import generator, host_rng, make_corpus
from annbench.roofline import bound_s, centroid_scan_work, probed_postings, rerank_work
from annbench.tracing import Slice, Tracer

TRACE_SLICE_S = 6.0   # the traced slice, unless the mix names its own (``trace_slice_s``)
STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass
class Run:
    """What a metric reader can read of one run."""

    cell: spec.Cell
    seconds: float
    window_start: float
    window_end: float
    setup_s: float
    spans: Dict[str, list]
    requests: List[Request]
    steps: List[WriterStep]
    counters: Dict[str, float]          # the program's counters, deltas over the window
    slice: Optional[Slice]
    facts: Dict[str, float]


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: Dict[str, tuple]            # name -> (value, limit)
    memory_peak_bytes: int
    slice: Optional[Slice]
    notes: List[str]
    run: Run


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for key, val in over.items():
        out[key] = _merge(out[key], val) if isinstance(val, dict) and isinstance(
            out.get(key), dict) else val
    return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _kernel_facts(run_facts: dict, cfg: dict, traffic: Traffic, pool: np.ndarray, snap,
                  device) -> None:
    """The bounds a whole-pool request needs, per query batch of the index's
    batching (``roofline``): the slab rerank's over the postings the
    benchmark's own top-nprobe probes, and the windowed stage 1's scan over
    every centroid."""
    storage = cfg["index"]["storage_dtype"]
    lens = np.bincount(snap.member_post, minlength=len(snap.centroids))
    bs = cfg["index"]["search"]["query_batch_size"]
    # int8 storage routes on the f32 centroids; float storage in its own dtype.
    route = None if storage == "int8" else STORAGE[storage]
    probes = probed_postings(pool, snap.centroids, traffic.nprobe, route, device)
    bound = scan = 0.0
    batches = 0
    for s in range(0, len(pool), bs):
        w = rerank_work(probes[s:s + bs], lens, pool.shape[1], storage)
        bound += bound_s(w["bytes"], w["ops"], "f32")
        w = centroid_scan_work(len(probes[s:s + bs]), len(snap.centroids), pool.shape[1])
        scan += bound_s(w["bytes"], w["ops"], "tf32")
        batches += 1
    run_facts["rerank_bound_s_per_request"] = bound
    run_facts["rerank_launches_per_request"] = batches
    run_facts["centroid_scan_bound_s_per_request"] = scan
    run_facts["centroid_scan_launches_per_request"] = batches


def execute(cell: spec.Cell, seed: int, seconds: float, *, device, trace: bool,
            t_start: float, system_factory: Optional[Callable] = None,
            sizes: Optional[dict] = None) -> Outcome:
    """One run.  ``sizes`` (tests only) shrinks the configuration;
    ``system_factory(config, device)`` stands a control or a fault in the
    program's place."""
    device = torch.device(device)
    cfg = _merge(cell.config, sizes or {})
    mix_spec = cell.traffic
    corpus_spec = cfg["corpus"]
    n, pool_n = int(corpus_spec["n"]), int(corpus_spec["queries"])
    notes: List[str] = []

    mix = make_corpus(cfg, seed, device)
    corpus = mix.corpus()
    pool = mix.draw(pool_n, "queries")
    traffic = Traffic(mix_spec, seed, pool_n, seconds)
    writer = traffic.writer
    n_ins = int(writer["insert"]) * traffic.writer_steps if writer else 0
    # The writer's inputs, then one step's inserts for its warm-up (inserted,
    # searched, deleted again before the window).
    n_warm = int(writer["insert"]) if writer else 0
    extra = mix.draw(n_ins + n_warm, "inserts") if writer else corpus[:0]
    rows_all = torch.cat([corpus, extra])
    del_order = (torch.randperm(n, generator=generator(seed, "deletes", device), device=device)
                 .cpu().numpy() if writer else None)
    corpus_np = corpus.cpu().numpy()
    pool_np = pool.cpu().numpy()
    extra_np = extra.cpu().numpy()
    del corpus
    n_all = rows_all.shape[0]
    born = np.full(n_all, np.inf)
    born[:n] = -np.inf
    dead = np.full(n_all, np.inf)

    if system_factory is None:
        from annbench.system import ProgramSystem as system_factory
    system = system_factory(cfg, device)
    spans = Spans()
    with spans("build", n):
        system.build(corpus_np)
    del corpus_np
    if cfg.get("lire"):
        with spans("live_open", system.num_stored):
            system.open_live()

    # Warm-up: every shape the cell's traffic uses, and the update path once.
    k, nprobe = traffic.k, traffic.nprobe
    for m in traffic.request_sizes():
        system.search(pool_np[:m], k, nprobe)
    shortfall = 0
    if writer:
        wid = np.arange(n + n_ins, n + n_ins + n_warm)
        system.insert(extra_np[n_ins:], wid)
        system.search(pool_np[:8], k, nprobe)
        shortfall += n_warm - system.delete(wid)
        born[wid] = -np.inf
        dead[wid] = now()
        system.search(pool_np[:8], k, nprobe)
    slice_s = min(float(mix_spec.get("trace_slice_s", TRACE_SLICE_S)), seconds)
    tracer = Tracer(trace, slice_s, spans)
    tracer.warm()
    # The set-up's garbage is collected here, not by a collection that
    # would stall the window's first requests.
    gc.collect()
    gc.freeze()
    _synchronize(device)
    counters0 = system.counters()

    t0 = now()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    tracer.place(t0 + 0.5 * (seconds - slice_s))
    rec = Recorder(seed)
    steps: List[WriterStep] = []
    if writer:
        raised = []

        def reader():
            try:
                run_reader(system, traffic, pool_np, t0, deadline, rec, spans)
            except BaseException as e:  # re-raised in the main thread below
                raised.append(e)

        th = threading.Thread(target=reader, name="annbench-reader")
        th.start()
        try:
            run_writer(system, writer, extra_np[:n_ins], np.arange(n, n + n_ins), del_order,
                       t0, deadline, steps, spans, tick=tracer.tick)
        finally:
            th.join()
        if raised:
            raise raised[0]
    else:
        run_reader(system, traffic, pool_np, t0, deadline, rec, spans, tick=tracer.tick)
    t1 = now()
    slice_ = tracer.finish()
    if slice_ is not None:
        notes.append(f"traced slice {slice_.window_s:.3f} s read in {now() - t1:.1f} s")
    counters1 = system.counters()
    counters = {key: counters1.get(key, 0) - counters0.get(key, 0)
                for key in set(counters0) | set(counters1)}

    for st in steps:
        if st.ins_acked:
            born[st.ins_ids] = st.ins_start
        if st.error is None:
            dead[st.del_ids] = st.del_end
            shortfall += len(st.del_ids) - st.del_acked
    answers = [Answers(r.rows, r.ids, r.dists, r.start, r.end, judged=not writer)
               for r in rec.requests if r.kept or r.error is not None]
    table = pool
    if writer:
        # After the window: the pool, and a sample of the acknowledged
        # inserts searched for themselves, on the state the writer left.
        system.quiesce()
        after = cell.traffic.get("after_window", {})
        acked = np.flatnonzero(np.isfinite(born[n:n + n_ins])) + n
        probes = np.sort(host_rng(seed, "probes").choice(
            acked, size=min(len(acked), int(after.get("insert_probes", 0))), replace=False))
        table = torch.cat([pool, rows_all[torch.from_numpy(probes).to(device)]])
        rows = np.arange(table.shape[0])
        table_np = table.cpu().numpy()
        ta = now()
        (ids, d), snap = system.search_and_snapshot(table_np, k, nprobe)
        answers.append(Answers(rows, ids, d, ta, now(), judged=True))
    else:
        snap = system.snapshot()
    peak = int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else 0
    facts: Dict[str, float] = {}
    if slice_ is not None and snap is not None and traffic.sizes[0] >= pool_n:
        _kernel_facts(facts, cfg, traffic, pool_np, snap, device)
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = compare(rows_all, table, answers, Ledger(born, dead), snap, k=k, nprobe=nprobe,
                       storage=STORAGE[cfg["index"]["storage_dtype"]], shortfall=shortfall)
    facts["recall_at_10"] = readings.pop("recall_at_10")
    run = Run(cell, seconds, t0, t1, setup_s, spans.spans, rec.requests, steps, counters,
              slice_, facts)
    metrics = {}
    kind, group = ("per_layer", cell.per_layer) if trace else ("end_to_end", cell.end_to_end)
    for m in group:
        value = spec.load_reader(cell.home, m, kind)(run)
        if value is not None:
            metrics[m["name"]] = (float(value), m["unit"])
    limits = json.loads((cell.home / "limits" / f"{cell.name}.json").read_text())
    checks = {name: (float(readings[name]), float(limit)) for name, limit in limits.items()}
    failed = sum(r.error is not None for r in rec.requests) + sum(
        st.error is not None for st in steps)
    attempted = len(rec.requests) + 2 * len(steps)
    if steps:
        lag = max(st.ins_start - st.due for st in steps)
        notes.append(f"writer: {len(steps)} steps, the latest started {lag:.3f} s after its "
                     f"due time, the last acknowledged {steps[-1].del_end - deadline:+.3f} s "
                     "from the window's close")
    for r in rec.requests:
        if r.error is not None:
            notes.append(f"request failed: {r.error}")
            break
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    return Outcome(correct, attempted, failed, metrics, checks, peak, slice_, notes, run)
