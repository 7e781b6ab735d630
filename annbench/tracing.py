"""The traced slice of a ``--trace 1`` run: torch.profiler over a few
seconds in the middle of the window, opened and closed between two requests
of the main thread's loop, so the slice holds whole requests of that loop.

From the slice: the device's busy seconds (the union of kernel intervals),
its length on the host clock, each kernel's time, the device ops that took
most time (kernels under their launching op; those no op launched, the
program's own through ctypes, under their kernel names), and the
longest idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from annbench.clients import now


@dataclasses.dataclass
class Slice:
    start: float                 # host clock, right after the profiler started
    end: float                   # host clock, right before it stopped
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]    # kernel name -> (seconds, launches)
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernel(self, marker: str) -> Tuple[float, int]:
        """Seconds and launches of the kernels whose name contains ``marker``."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if marker in name:
                s, n = s + sec, n + cnt
        return s, n


class Tracer:
    """Opens the profiler at the first ``tick`` past ``place``'s start and
    closes it at the first past ``length`` seconds later (host clock)."""

    def __init__(self, enabled: bool, length: float, spans):
        self.enabled, self.length, self.spans = enabled, length, spans
        self.t_open = self.t_close = float("inf")
        self.prof = None
        self.opened = self.closed = None

    def place(self, start: float) -> None:
        self.t_open, self.t_close = start, start + self.length

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once (set-up): its first start
        initializes the device tracer, which takes seconds."""
        if not self.enabled:
            return
        import torch

        with self._profile():
            x = torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu")
            (x + 1).sum().item()

    def tick(self) -> None:
        if not self.enabled or self.closed is not None:
            return
        t = now()
        if self.prof is None and t >= self.t_open:
            import torch

            self.prof = self._profile()
            self.prof.__enter__()
            self.spans.annotate = torch.profiler.record_function
            self.opened = now()
        elif self.prof is not None and t >= self.t_close:
            self._stop()

    def _stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.closed = now()
        self.spans.annotate = None
        self.prof.__exit__(None, None, None)

    def finish(self) -> Optional[Slice]:
        """Close the profiler if the window ended first; the slice, or None
        where no slice was opened."""
        if self.prof is None:
            return None
        if self.closed is None:
            self._stop()
        return read_slice(self.prof, self.opened, self.closed)


def _union_seconds(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of (start, end) µs intervals, in seconds,
    and the gaps between its pieces."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6, gaps


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def read_slice(prof, opened: float, closed: float, top: int = 10) -> Slice:
    from torch.autograd import DeviceType

    events = prof.events()
    # The benchmark's own spans also show on the device's timeline (as user
    # annotations): they are not device work.
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("annbench.")]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy, gaps = _union_seconds(spans)
    if busy > closed - opened:
        # More device time than the slice lasted: something that is not
        # device work was counted as such.
        raise RuntimeError(f"traced slice: device busy {busy!r} s over a slice of "
                           f"{closed - opened!r} s")
    kernels: Dict[str, Tuple[float, int]] = {}
    for e in dev:
        s, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (s + (e.time_range.end - e.time_range.start) * 1e-6, n + 1)
    # Device time under each launching op; kernels that no op launched (the
    # program's own, launched through ctypes) under their kernel names.
    ops: Dict[str, float] = {}
    attached = set()
    for e in cpu:
        attached.update(kern.name for kern in e.kernels)
        if e.self_device_time_total > 0 and not e.name.startswith("annbench."):
            ops[e.name] = ops.get(e.name, 0.0) + e.self_device_time_total * 1e-6
    for name, (sec, _) in kernels.items():
        if name not in attached:
            ops[_short(name)] = ops.get(_short(name), 0.0) + sec
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    # Each idle gap under the innermost host event that covers its middle,
    # inside the outermost one (the benchmark's span, where there is one).
    labelled = []
    cpu_iv = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                     if not e.name.startswith("cuda")), key=lambda t: t[0])
    starts = [c[0] for c in cpu_iv]
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (g0 + g1)
        hi = bisect.bisect_right(starts, mid)
        covering = [c for c in cpu_iv[max(0, hi - 4096):hi] if c[1] >= mid]
        if covering:
            outer, inner = covering[0][2], covering[-1][2]
            label = outer if outer == inner else f"{outer} > {inner}"
        else:
            label = "no host op (between calls)"
        labelled.append((label, (g1 - g0) * 1e-6))
    return Slice(opened, closed, busy, kernels, device_ops, labelled)
