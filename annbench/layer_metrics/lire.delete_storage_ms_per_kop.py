"""Writer host ms in delete_batch's storage tombstones (the program's
``lire.delete.storage`` span around each mark_deleted_batch) per 1,000
acknowledged deletes, counters over the window.  None where no delete was
acknowledged, or the program has no such span."""


def read(run):
    c = run.counters
    acked = sum(s.del_acked for s in run.steps)
    if not acked or "lire.delete.n" not in c:
        return None
    return 1e3 * c.get("lire.delete.storage.s", 0.0) / (acked / 1e3)
