"""Phase timing and profiler traces (counterpart of
``spfresh_tpu/utils/profiling.py``): ``PhaseTimer``, ``device_trace`` (a
``torch.profiler`` trace of the CPU and the card, written for Perfetto or
chrome://tracing) and ``annotate`` (a named region in that trace)."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger(__name__)

class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name.

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


@contextlib.contextmanager
def device_trace(out_dir: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    when a card is present) and write the trace into ``out_dir`` on exit
    as ``trace_<pid>_<ns>.json``, viewable in Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in profiler traces (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield
