"""Phase timing (counterpart of ``spfresh_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device


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
    >>> timer.totals()
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
