"""Phase timing, spans and profiler traces (counterpart of
``spfresh_tpu/utils/profiling.py``): ``PhaseTimer``, ``span`` (a timed
region whose totals feed ``utils.metrics``), ``device_trace`` (a
``torch.profiler`` trace of the CPU and the card, with the spans of every
thread on its timeline, written for Perfetto or chrome://tracing) and
``annotate`` (a span)."""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from spfresh_tpu_torch.utils import metrics

log = logging.getLogger(__name__)

RECORD_CAP = 1 << 18  # span records one device_trace keeps; later ones are counted as dropped

_clock = time.perf_counter_ns
_ids = itertools.count(1)
_local = threading.local()
# The recorder of the open device_trace, None outside one.  Process-wide, so
# spans of every thread are recorded, as the profiler sees the card's work
# of every thread.
_recorder: Optional["_Recorder"] = None


class _Recorder:
    """Span records kept in memory while a ``device_trace`` is open:
    (name, start ns, end ns, thread id, thread name, id, parent id, request
    id, cause id, items), on ``time.perf_counter_ns``."""

    def __init__(self, cap: int):
        self.cap = cap
        self.records: List[tuple] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, record: tuple) -> None:
        with self._lock:
            if len(self.records) < self.cap:
                self.records.append(record)
            else:
                self.dropped += 1


class Span:
    """A timed region (see ``span``).  ``items`` may be set inside it."""

    __slots__ = ("_tot", "items", "cause", "_t0", "_rec")

    def __init__(self, tot: metrics.SpanTotals, items: float, cause: int):
        self._tot, self.items, self.cause = tot, items, cause

    def __enter__(self) -> "Span":
        self._rec = None if _recorder is None else self._open(_recorder)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _clock()
        tot = self._tot
        lock = tot.lock
        lock.acquire()
        try:
            tot.ns += t1 - self._t0
            tot.n += 1
            tot.items += self.items
        finally:
            lock.release()
        if self._rec is not None:
            self._close(t1)
        return False

    @staticmethod
    def _open(rec: _Recorder) -> tuple:
        stack = getattr(_local, "stack", None)
        if stack is None:
            # The thread's id and name, read once: get_native_id is a system call.
            stack = _local.stack = []
            _local.thread = (threading.get_native_id(), threading.current_thread().name)
        sid = next(_ids)
        parent, root = stack[-1] if stack else (0, sid)
        stack.append((sid, root))
        return rec, sid, parent, root

    def _close(self, t1: int) -> None:
        rec, sid, parent, root = self._rec
        _local.stack.remove((sid, root))
        tid, tname = _local.thread
        rec.add((self._tot.name, self._t0, t1, tid, tname, sid, parent, root, self.cause,
                 self.items))


def span(name: str, items: float = 0, cause: int = 0) -> Span:
    """A named region of the program, timed on ``time.perf_counter_ns``.
    On close it adds its seconds, one, and ``items`` to the counters
    ``<name>.s``, ``<name>.n`` and ``<name>.items`` (``utils.metrics``).
    Inside ``device_trace`` it is also recorded, on any thread, with its
    parent (the span open around it on its thread), its request (the
    outermost such span) and ``cause`` (the ``current_span_id`` of the span
    that handed its work over from another thread)."""
    return Span(metrics.DEFAULT.span_totals(name), items, cause)


def current_span_id() -> int:
    """The id of the innermost recorded span open on this thread; 0 outside
    ``device_trace`` or outside any span."""
    stack = getattr(_local, "stack", None)
    return stack[-1][0] if stack else 0


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name; each phase is also
    a span of its name.

    ``device``: the device whose queued work a blocking phase waits for.
    On a CUDA device ``phase(..., block=True)`` calls
    ``torch.cuda.synchronize`` before and after, so asynchronous kernel
    launches land in the phase that issued them; on the CPU there is
    nothing to wait for.

    >>> timer = PhaseTimer(device="cuda")
    >>> with timer.phase("build/assign", block=True):
    ...     do_work()
    >>> timer.report()
    """

    def __init__(self, device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = False) -> Iterator[None]:
        if block:
            self._barrier()
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if block:
                    self._barrier()
                self._totals[name] += time.perf_counter() - t0
                self._counts[name] += 1

    def totals(self) -> List[Tuple[str, float, int]]:
        """(name, seconds, count) per phase, longest first."""
        return sorted(
            ((k, v, self._counts[k]) for k, v in self._totals.items()),
            key=lambda t: -t[1],
        )

    def report(self, logger: Optional[logging.Logger] = None) -> str:
        """One line per phase, longest first (the JAX package's format),
        logged at INFO and returned."""
        text = "\n".join(
            f"{name:<40s} {total:8.3f}s  ({count}x, {total / count * 1e3:8.2f} ms avg)"
            for name, total, count in self.totals()
        )
        (logger or log).info("phase timings:\n%s", text)
        return text

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()


def _unix_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few bracketed reads."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def _span_events(rec: _Recorder, offset_ns: int, base_ns: int, pid: int) -> List[dict]:
    """The records as complete ("X") events on the trace's clock: the
    exported ``ts`` is Unix time in µs less the trace's
    ``baseTimeNanoseconds``."""
    out = []
    for name, t0, t1, tid, tname, sid, parent, root, cause, items in rec.records:
        out.append({
            "ph": "X", "cat": "spfresh_span", "name": name, "pid": pid, "tid": tid,
            "ts": round((t0 + offset_ns - base_ns) / 1e3, 3), "dur": round((t1 - t0) / 1e3, 3),
            "args": {"id": sid, "parent": parent, "request": root, "cause": cause,
                     "items": items, "thread": tname}})
    return out


@contextlib.contextmanager
def device_trace(out_dir: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    when a card is present), record the spans every thread opens in it,
    and write the trace into ``out_dir`` on exit as
    ``trace_<pid>_<ns>.json``, viewable in Perfetto: the spans are host
    events (category ``spfresh_span``) on the profiler's timeline, each on
    its thread's row; ``spfresh_spans`` holds how many were recorded and
    dropped past ``RECORD_CAP``."""
    global _recorder
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    rec, outer = _Recorder(RECORD_CAP), _recorder
    prof.start()
    offset_ns = _unix_offset_ns()
    _recorder = rec
    try:
        yield
    finally:
        _recorder = outer
        prof.stop()
        path = os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        with rec._lock:
            trace["traceEvents"].extend(_span_events(
                rec, offset_ns, int(trace.get("baseTimeNanoseconds", 0)), os.getpid()))
            trace["spfresh_spans"] = {"recorded": len(rec.records), "dropped": rec.dropped}
        with open(path, "w") as f:
            json.dump(trace, f)


def annotate(name: str) -> Span:
    """A named region of the program: ``span(name)``, which a
    ``device_trace`` shows on its timeline."""
    return span(name)
