"""Writer host ms of SpFreshIndex.insert_batch per 1,000 acknowledged inserts."""

from annbench.readers import window_spans


def read(run):
    acked = sum(s.ins_acked for s in run.steps)
    spans = window_spans(run, "insert")
    return 1e3 * sum(e - b for b, e, _ in spans) / (acked / 1e3) if acked and spans else None
