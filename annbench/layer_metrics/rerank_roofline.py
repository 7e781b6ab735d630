"""The slab rerank kernel (csrc/rerank.cu) against its roofline: the bound
of the traced requests' work (``roofline.rerank_work``: each probed
posting's members once, each query once, each distance written once) over
the device time of ``rerank_kernel<`` launches in the slice.  Nothing to
read where the launches do not match the traced requests' batches."""

from annbench.readers import traced_requests


def read(run):
    per = run.facts.get("rerank_bound_s_per_request")
    if run.slice is None or per is None:
        return None
    reqs = [r for r in traced_requests(run) if r.error is None]
    secs, launches = run.slice.kernel("rerank_kernel<")
    if not reqs or not secs or launches != len(reqs) * run.facts["rerank_launches_per_request"]:
        return None
    return 100.0 * per * len(reqs) / secs
