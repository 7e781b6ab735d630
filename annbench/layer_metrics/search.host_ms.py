"""Mean host ms of one SpannIndex.search call outside its final
device-to-host copy: the program's ``search`` span less its ``search.d2h``
span, over the calls (``search.n``), counters over the window.  None where
no search ran, or the program has no such span."""


def read(run):
    c = run.counters
    calls = c.get("search.n", 0)
    if not calls:
        return None
    return 1e3 * (c.get("search.s", 0.0) - c.get("search.d2h.s", 0.0)) / calls
