"""Writer host ms in delete_batch's mirror rewrites (the program's
``lire.delete.mirror`` span: each touched posting's rewrite and id-map
update, and the stale-mirror sweep, under the index lock) per 1,000
acknowledged deletes, counters over the window.  None where no delete was
acknowledged, or the program has no such span."""


def read(run):
    c = run.counters
    acked = sum(s.del_acked for s in run.steps)
    if not acked or "lire.delete.n" not in c:
        return None
    return 1e3 * c.get("lire.delete.mirror.s", 0.0) / (acked / 1e3)
