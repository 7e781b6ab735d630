"""Named counters and gauges (counterpart of ``spfresh_tpu/utils/metrics.py``).

The search path records which engine ran (``search.engine.cuda`` or
``search.engine.cpu``), the chunks of the probe axis each query batch
took (``search.probe_chunks``) and the bytes its queries moved to the
device through the configured wire (``search.stage.bytes``); the build
records which replica engine ran (``build.replica_engine.cuda`` or
``...cpu``).

Each span (``utils.profiling.span``) adds three counters as it closes:
``<name>.s`` (seconds it was open), ``<name>.n`` (spans closed) and
``<name>.items`` (the items they covered: queries, vectors, ids, postings).
The spans of the search and live-update paths are ``search``,
``search.stage``, ``search.d2h``, ``view.refresh``, ``lire.search.lock``,
``lire.insert``, ``lire.insert.fallback``, ``lire.delete``,
``lire.delete.storage``, ``lire.delete.mirror`` and ``lire.op``; a
``PhaseTimer`` phase is a span of its phase name."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict


class SpanTotals:
    """One span name's running totals: nanoseconds open, spans closed,
    items covered.  A closing span adds to them holding ``lock``, its
    ``Metrics``' lock, so ``snapshot`` reads them whole."""

    __slots__ = ("name", "lock", "ns", "n", "items")

    def __init__(self, name: str, lock: threading.Lock):
        self.name, self.lock = name, lock
        self.ns = self.n = self.items = 0


class Metrics:
    """Thread-safe counters + gauges; a process-global default instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._spans: Dict[str, SpanTotals] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def span_totals(self, name: str) -> "SpanTotals":
        """The running totals of the span ``name``, made on first use."""
        tot = self._spans.get(name)
        if tot is None:
            with self._lock:
                tot = self._spans.setdefault(name, SpanTotals(name, self._lock))
        return tot

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            for tot in self._spans.values():
                if tot.n:
                    out[f"{tot.name}.s"] = tot.ns * 1e-9
                    out[f"{tot.name}.n"] = float(tot.n)
                    out[f"{tot.name}.items"] = float(tot.items)
            out.update(self._gauges)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            for tot in self._spans.values():
                tot.ns = tot.n = tot.items = 0


DEFAULT = Metrics()


def inc(name: str, value: float = 1.0) -> None:
    DEFAULT.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    DEFAULT.set_gauge(name, value)


def snapshot() -> Dict[str, float]:
    return DEFAULT.snapshot()
