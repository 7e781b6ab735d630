"""Rate of the query staging's host-to-device copies, in GB/s: the bytes
the program's configured wire moved (its ``search.stage.bytes`` counter)
over the ``search.stage`` span's seconds, counters over the window.  None
where no batch was staged, or the program has no such counter."""


def read(run):
    c = run.counters
    nbytes, secs = c.get("search.stage.bytes"), c.get("search.stage.s", 0.0)
    return nbytes / secs / 1e9 if nbytes is not None and secs > 0 else None
