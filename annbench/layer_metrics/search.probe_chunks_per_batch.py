"""Chunks of the probe axis a query batch took (the program's
``search.probe_chunks`` counter over ``search.stage.n``, the batches
staged), counters over the window: 1 where every batch's candidate block
fits ``PROBE_CHUNK_BYTES``.  None where no batch was staged, or the
program has no such counter."""


def read(run):
    c = run.counters
    chunks, batches = c.get("search.probe_chunks"), c.get("search.stage.n", 0)
    return chunks / batches if chunks is not None and batches else None
