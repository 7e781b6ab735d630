"""Host ms spent staging queries per 1,000 queries searched: the program's
``search.stage`` span (each query batch's padded host copy and its copy to
the device, with that copy's wait for the stream) over ``search.items``,
counters over the window.  None where no query was searched, or the program
has no such span."""


def read(run):
    c = run.counters
    queries = c.get("search.items", 0)
    return 1e3 * c.get("search.stage.s", 0.0) / (queries / 1e3) if queries else None
