"""Named counters and gauges (counterpart of ``spfresh_tpu/utils/metrics.py``).

The search path records which engine ran (``search.engine.cuda`` or
``search.engine.cpu``) and the build which replica engine ran
(``build.replica_engine.cuda`` or ``...cpu``)."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict


class Metrics:
    """Thread-safe counters + gauges; a process-global default instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


DEFAULT = Metrics()


def inc(name: str, value: float = 1.0) -> None:
    DEFAULT.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    DEFAULT.set_gauge(name, value)


def snapshot() -> Dict[str, float]:
    return DEFAULT.snapshot()
