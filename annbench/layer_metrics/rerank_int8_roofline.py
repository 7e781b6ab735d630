"""The slab rerank kernel's int8 case (csrc/rerank.cu, the ``I8``
instantiation of ``rerank_kernel<``) against its roofline: the bound of the
traced requests' work (``roofline.rerank_work`` for int8 codes: each probed
posting's members once at a byte a coordinate, its centroid and scale once,
each query once, each distance written once) over the device time of those
launches alone; the windowed stage 1's float launches of the same kernel
are not counted.  Nothing to read where the launches do not match the
traced requests' batches."""

import re

from annbench.readers import traced_requests

INT8 = re.compile(r"rerank_kernel<[^>]*\bI8\b")


def read(run):
    per = run.facts.get("rerank_bound_s_per_request")
    if run.slice is None or per is None:
        return None
    reqs = [r for r in traced_requests(run) if r.error is None]
    secs = launches = 0
    for name, (s, n) in run.slice.kernels.items():
        if INT8.search(name):
            secs, launches = secs + s, launches + n
    if not reqs or not secs or launches != len(reqs) * run.facts["rerank_launches_per_request"]:
        return None
    return 100.0 * per * len(reqs) / secs
