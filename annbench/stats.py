"""Window arithmetic: rates, tails and spreads from host-clock records."""

from __future__ import annotations

import math
import statistics

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default); +inf entries (failed requests) count as missing any limit."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.nan
    h = (v.size - 1) * q / 100.0
    lo = int(math.floor(h))
    hi, frac = min(lo + 1, v.size - 1), h - lo
    if frac == 0 or v[hi] == v[lo]:
        return float(v[lo])
    return math.inf if math.isinf(v[hi]) else float(v[lo] + frac * (v[hi] - v[lo]))


def rate(count: float, seconds: float) -> float:
    return count / seconds if seconds > 0 else math.nan


def closed_window(t0: float, ends) -> float:
    """A closed loop's window: from its start to the end of the last request
    it started before the deadline, so every request it counts lies inside."""
    ends = list(ends)
    return (max(ends) - t0) if ends else math.nan


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, quartiles as ``statistics.quantiles(n=4)`` gives."""
    v = [float(x) for x in values]
    if len(v) < 2:
        return math.nan
    q1, med, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / abs(med) if med else math.inf
