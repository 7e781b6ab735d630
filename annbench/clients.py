"""The one traffic generator and its client loops.

A traffic mix is a data file (``traffic/<mix>.json``) of parameters that
this module reads; no mix has code of its own:

* ``reader``: the search client.  ``loop`` is ``closed`` (the next request
  goes when the last returns) or ``open`` (Poisson arrivals at
  ``rate_per_s``, served in FIFO order by one server loop, each timed from
  its due time).  ``request`` is ``"pool"`` (every request is the whole
  query pool) or ``{"min", "max"}``: log-uniform request sizes.
* ``writer`` (optional): an open loop of steps due every
  ``(insert + delete) / rate_ops_per_s`` seconds, each an insert of
  ``insert`` fresh vectors of the mixture and then a delete of ``delete``
  live base rows, drawn uniformly.  A step starts at its due time, or when
  the last one ends if that is later, and is timed from its due time; every
  step due in the window is made, so a stall's backlog counts.
* ``k``, ``nprobe``: the search's operating point.

Every seed gets the same multiset of request sizes and of arrival gaps (drawn
from the mix's own fixed seed), in an order of its own; the queries a request
takes, the inserted vectors and the deleted rows come from the run's seed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from annbench.data import host_rng

FIXED_SEED = 0        # the seed of the multisets every run shares
SIZES_CYCLE = 4096    # request sizes drawn once and cycled
KEEP_POOL_REQUESTS = 4  # whole-pool requests whose answers are kept (a seeded sample)

now = time.perf_counter


@dataclasses.dataclass
class Request:
    due: float
    start: float
    end: float
    rows: np.ndarray            # indices into the query table
    ids: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None
    error: Optional[str] = None
    kept: bool = False


@dataclasses.dataclass
class WriterStep:
    due: float
    ins_ids: np.ndarray
    ins_start: float
    ins_end: float
    ins_acked: int
    del_ids: np.ndarray
    del_start: float
    del_end: float
    del_acked: int
    error: Optional[str] = None


def loguniform_sizes(lo: int, hi: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """``m`` integer sizes in [lo, hi], log-uniform."""
    u = rng.uniform(np.log(lo), np.log(hi + 1), size=m)
    return np.minimum(np.floor(np.exp(u)).astype(np.int64), hi)


class Traffic:
    """The draws of one run of a mix: request sizes and rows, arrivals."""

    def __init__(self, mix: dict, seed: int, pool: int, seconds: float):
        self.mix, self.pool = mix, pool
        self.k, self.nprobe = int(mix["k"]), int(mix["nprobe"])
        reader = mix["reader"]
        self.loop = reader["loop"]
        fixed = np.random.default_rng(FIXED_SEED)
        rng = host_rng(seed, "traffic")
        req = reader["request"]
        # A whole-pool request hands the query table over as it is: one
        # shared, read-only row list, no copy of the table in the window.
        self.whole = np.arange(pool)
        self.whole.flags.writeable = False
        if req == "pool":
            self.sizes = np.array([pool], np.int64)
        else:
            self.sizes = rng.permutation(loguniform_sizes(req["min"], req["max"], SIZES_CYCLE,
                                                          fixed))
        self.order = rng.permutation(pool)
        self._next_row = 0
        self.arrivals = None
        if self.loop == "open":
            rate = float(reader["rate_per_s"])
            m = int(np.ceil(rate * seconds * 1.25)) + 64
            gaps = rng.permutation(fixed.exponential(1.0 / rate, size=m))
            self.arrivals = np.cumsum(gaps)
        elif self.loop != "closed":
            raise ValueError(f"unknown reader loop {self.loop!r}")
        self.writer = mix.get("writer")
        self.writer_steps = 0
        if self.writer:
            w = self.writer
            period = (int(w["insert"]) + int(w["delete"])) / float(w["rate_ops_per_s"])
            self.writer_steps = int(np.ceil(seconds / period))

    def request_sizes(self) -> List[int]:
        """Every size a request of this mix can have (the warm-up's)."""
        return sorted(set(int(s) for s in self.sizes))

    def rows(self, i: int) -> np.ndarray:
        """The query-table rows of request ``i`` (requests are taken in order)."""
        m = int(self.sizes[i % len(self.sizes)])
        if m >= self.pool:
            return self.whole
        idx = (self._next_row + np.arange(m)) % self.pool
        self._next_row = int((self._next_row + m) % self.pool)
        return self.order[idx]


class Recorder:
    """Requests of a reader, with the answers kept for the comparison:
    every answer of sized requests; a seeded reservoir sample of
    ``KEEP_POOL_REQUESTS`` whole-pool requests."""

    def __init__(self, seed: int):
        self.requests: List[Request] = []
        self._rng = host_rng(seed, "sample")
        self._pool_seen = 0
        self._pool_kept: List[int] = []

    def add(self, r: Request, whole_pool: bool) -> None:
        if r.error is None:
            if not whole_pool:
                r.kept = True
            else:
                i = self._pool_seen
                self._pool_seen += 1
                if len(self._pool_kept) < KEEP_POOL_REQUESTS:
                    r.kept = True
                    self._pool_kept.append(len(self.requests))
                else:
                    j = int(self._rng.integers(0, i + 1))
                    if j < KEEP_POOL_REQUESTS:
                        old = self.requests[self._pool_kept[j]]
                        old.kept, old.ids, old.dists = False, None, None
                        r.kept = True
                        self._pool_kept[j] = len(self.requests)
            if not r.kept:
                r.ids = r.dists = None
        self.requests.append(r)


def _search(system, traffic, table, i, span):
    rows = traffic.rows(i)
    queries = table if rows is traffic.whole else table[rows]
    with span("search", len(rows)):
        start = now()
        try:
            ids, dists = system.search(queries, traffic.k, traffic.nprobe)
            err = None
        except Exception as e:  # a failed request is counted, not fatal
            ids = dists = None
            err = f"{type(e).__name__}: {e}"
        end = now()
    return rows, start, end, ids, dists, err


def run_reader(system, traffic: Traffic, table: np.ndarray, t0: float, deadline: float,
               rec: Recorder, span, tick: Callable[[], None] = lambda: None) -> None:
    """The reader until ``deadline``: a closed loop starts no request at or
    after it; an open loop serves every request due before it, late ones
    included, so a backlog's wait counts."""
    whole = traffic.sizes[0] >= traffic.pool and len(traffic.sizes) == 1
    i = 0
    while True:
        tick()
        if traffic.loop == "closed":
            if now() >= deadline:
                return
            due = None
        else:
            if i >= len(traffic.arrivals):
                raise RuntimeError("open loop ran out of arrivals; the schedule is too short")
            due = t0 + float(traffic.arrivals[i])
            if due >= deadline:
                return
            wait = due - now()
            if wait > 0:
                time.sleep(wait)
        rows, start, end, ids, dists, err = _search(system, traffic, table, i, span)
        rec.add(Request(start if due is None else due, start, end, rows, ids, dists, err),
                whole)
        i += 1


def run_writer(system, writer: dict, inserts: np.ndarray, insert_ids: np.ndarray,
               delete_order: np.ndarray, t0: float, deadline: float, steps: List[WriterStep],
               span, tick: Callable[[], None] = lambda: None) -> None:
    """The writer's open loop of insert-then-delete steps: every step due
    before ``deadline``, each started at its due time or when the last ends."""
    ni, nd = int(writer["insert"]), int(writer["delete"])
    period = (ni + nd) / float(writer["rate_ops_per_s"])
    j = 0
    while True:
        tick()
        due = t0 + j * period
        if due >= deadline:
            return
        if (j + 1) * ni > len(inserts) or (j + 1) * nd > len(delete_order):
            raise RuntimeError("the writer's inputs ran out; the mix's `inserts` is too small")
        wait = due - now()
        if wait > 0:
            time.sleep(wait)
        vecs, ids = inserts[j * ni:(j + 1) * ni], insert_ids[j * ni:(j + 1) * ni]
        dels = delete_order[j * nd:(j + 1) * nd]
        err = None
        ins_acked = del_acked = 0
        ins_start = now()
        try:
            with span("insert", ni):
                ins_acked = system.insert(vecs, ids)
        except Exception as e:
            err = f"insert {type(e).__name__}: {e}"
        ins_end = del_start = now()
        if err is None:
            try:
                with span("delete", nd):
                    del_acked = system.delete(dels)
            except Exception as e:
                err = f"delete {type(e).__name__}: {e}"
        del_end = now()
        steps.append(WriterStep(due, ids, ins_start, ins_end, ins_acked, dels, del_start,
                                del_end, del_acked, err))
        j += 1


class Spans:
    """The benchmark's own spans around its calls into the system: name ->
    list of (start, end, items), host clock.  ``annotate`` also labels each
    span in the profiler's trace when a traced slice is open."""

    def __init__(self):
        self.spans = {}
        self._lock = threading.Lock()
        self.annotate = None

    def __call__(self, name: str, items: int = 0):
        return _Span(self, name, items)

    def add(self, name, start, end, items):
        with self._lock:
            self.spans.setdefault(name, []).append((start, end, items))


class _Span:
    def __init__(self, owner: Spans, name: str, items: int):
        self.owner, self.name, self.items = owner, name, items
        self.rf = None

    def __enter__(self):
        if self.owner.annotate is not None:
            self.rf = self.owner.annotate(f"annbench.{self.name}")
            self.rf.__enter__()
        self.start = now()
        return self

    def __exit__(self, *exc):
        end = now()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.owner.add(self.name, self.start, end, self.items)
        return False
