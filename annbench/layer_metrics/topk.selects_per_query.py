"""Rows the program's tie-stable top-k selected per query searched: its
``topk.select.rows`` counter over ``search.items``, counters over the
window.  A batch search selects three rows a query (stage 1, the dedup
prefilter, its final select).  None where no query was searched, or the
program has no such counter."""


def read(run):
    c = run.counters
    queries = c.get("search.items", 0)
    rows = c.get("topk.select.rows")
    return rows / queries if queries and rows is not None else None
