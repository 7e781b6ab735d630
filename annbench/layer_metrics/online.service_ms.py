"""Mean host time of one SpannIndex.search call in the window, call to
return (the request path's service time, without the queue's wait)."""

from annbench.readers import window_spans


def read(run):
    s = window_spans(run, "search")
    return 1e3 * sum(e - b for b, e, _ in s) / len(s) if s else None
