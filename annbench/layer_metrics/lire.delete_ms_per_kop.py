"""Writer host ms of SpFreshIndex.delete_batch per 1,000 acknowledged deletes."""

from annbench.readers import window_spans


def read(run):
    acked = sum(s.del_acked for s in run.steps)
    spans = window_spans(run, "delete")
    return 1e3 * sum(e - b for b, e, _ in spans) / (acked / 1e3) if acked and spans else None
