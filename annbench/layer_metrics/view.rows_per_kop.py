"""Rows the in-place view wrote (view.vectors_appended + view.rows_scattered,
the program's counters, deltas over the window) per 1,000 acknowledged
updates."""


def read(run):
    acked = sum(s.ins_acked + s.del_acked for s in run.steps)
    rows = run.counters.get("view.vectors_appended", 0) + run.counters.get("view.rows_scattered", 0)
    return rows / (acked / 1e3) if acked else None
