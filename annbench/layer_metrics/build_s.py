"""Host wall of the index build and its device view pack, synchronized."""


def read(run):
    spans = run.spans.get("build")
    return (spans[0][1] - spans[0][0]) if spans else None
