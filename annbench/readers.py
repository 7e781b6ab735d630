"""What the metric readers (``end_to_end/``, ``layer_metrics/``) share."""

from __future__ import annotations


def window_spans(run, name: str) -> list:
    """The run's spans of ``name`` that began inside the measured window."""
    return [s for s in run.spans.get(name, []) if s[0] >= run.window_start]


def traced_requests(run) -> list:
    """The reader's requests that lie wholly inside the traced slice."""
    sl = run.slice
    return [r for r in run.requests if r.start >= sl.start and r.end <= sl.end]

