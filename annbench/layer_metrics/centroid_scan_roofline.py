"""The windowed centroid scan (csrc/centroid_scan.cu: its operand pass and
``window_scan_kernel``) against its roofline: the bound of the traced
requests' stage-1 scan (``roofline.centroid_scan_work``: every real
centroid against every query, f32-grade, at the TF32 peak) over the device
time of the scan's launches in the slice, both kernels.  Nothing to read
where the scan did not run (a dense stage 1) or its launches do not match
the traced requests' batches."""

from annbench.readers import traced_requests


def read(run):
    per = run.facts.get("centroid_scan_bound_s_per_request")
    if run.slice is None or per is None:
        return None
    reqs = [r for r in traced_requests(run) if r.error is None]
    secs, launches = run.slice.kernel("window_scan_kernel<")
    operand_secs, _ = run.slice.kernel("operand_kernel<")
    if (not reqs or not secs
            or launches != len(reqs) * run.facts["centroid_scan_launches_per_request"]):
        return None
    return 100.0 * per * len(reqs) / (secs + operand_secs)
