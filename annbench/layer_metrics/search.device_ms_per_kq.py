"""Device-busy ms per 1,000 queries over the traced slice (which opens and
closes between requests, so it holds whole requests)."""

from annbench.readers import traced_requests


def read(run):
    if run.slice is None or run.slice.busy_s <= 0:
        return None
    q = sum(len(r.rows) for r in traced_requests(run) if r.error is None)
    return 1e3 * run.slice.busy_s / (q / 1e3) if q else None
