"""Host ms of the LIRE background worker (the program's ``lire.op`` span: a
split, merge or reassign and its mirror sync) per 1,000 acknowledged
updates, counters over the window; 0 where no operation ran.  None where
nothing was acknowledged, or the program has no such span."""


def read(run):
    c = run.counters
    acked = sum(s.ins_acked + s.del_acked for s in run.steps)
    if not acked or "lire.insert.n" not in c:
        return None
    return 1e3 * c.get("lire.op.s", 0.0) / (acked / 1e3)
