"""The 50th percentile of the writer's steps in the window, in ms: from a
step's due time to the acknowledgement of its last delete, so the wait a
stall imposes on later steps counts; a failed step counts as past any limit.
At the mix's fixed write load, a shorter step holds the index lock that the
readers wait on for less time."""

from annbench.stats import percentile


def read(run):
    if not run.steps:
        return None
    lat = [(s.del_end - s.due) if s.error is None else float("inf") for s in run.steps]
    return 1e3 * percentile(lat, 50)
