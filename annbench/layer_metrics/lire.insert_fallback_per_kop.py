"""Vectors that insert_batch inserted one by one under the index lock, after
its batched storage append found a destination retired (the program's
``lire.insert.fallback`` span's items), per 1,000 acknowledged inserts,
counters over the window; 0 where none fell back.  None where no insert was
acknowledged, or the program has no such span."""


def read(run):
    c = run.counters
    acked = sum(s.ins_acked for s in run.steps)
    if not acked or "lire.insert.n" not in c:
        return None
    return c.get("lire.insert.fallback.items", 0.0) / (acked / 1e3)
