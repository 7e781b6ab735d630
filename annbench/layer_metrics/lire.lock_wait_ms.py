"""Mean ms a search of the live index waits for its lock (the program's
``lire.search.lock`` span) while a writer or the background worker holds
it, counters over the window.  None where no search ran, or the program has
no such span."""


def read(run):
    c = run.counters
    waits = c.get("lire.search.lock.n", 0)
    return 1e3 * c.get("lire.search.lock.s", 0.0) / waits if waits else None
