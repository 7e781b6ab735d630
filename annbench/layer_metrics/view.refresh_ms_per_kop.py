"""Host ms of the device view's refresh (the program's ``view.refresh``
span: in place, or a full repack, paid inside the first search after a
write) per 1,000 acknowledged updates, counters over the window.  None
where nothing was acknowledged, or the program has no such span."""


def read(run):
    c = run.counters
    acked = sum(s.ins_acked + s.del_acked for s in run.steps)
    if not acked or "view.refresh.n" not in c:
        return None
    return 1e3 * c.get("view.refresh.s", 0.0) / (acked / 1e3)
