"""The 50th percentile of every search request of the window, in ms: from
its due time in an open loop (so a backlog's wait counts), from its start in
a closed one; a failed request counts as past any limit."""

from annbench.stats import percentile


def read(run):
    if not run.requests:
        return None
    lat = [(r.end - r.due) if r.error is None else float("inf") for r in run.requests]
    return 1e3 * percentile(lat, 50)
