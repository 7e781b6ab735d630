"""Mean ms one SpannIndex.search call spends blocked in its device-to-host
copy of the answers (``search.d2h``: the wait for the device's queued work
and the copy), over the calls (``search.n``), counters over the window.
None where no search ran, or the program has no such span."""


def read(run):
    c = run.counters
    calls = c.get("search.n", 0)
    return 1e3 * c.get("search.d2h.s", 0.0) / calls if calls else None
