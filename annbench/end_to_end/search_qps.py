"""Queries answered over the whole window: every query of every request that
returned, over the time from the window's start to the end of the last
request the closed loop started in it."""

from annbench.stats import closed_window, rate


def read(run):
    done = [r for r in run.requests if r.error is None]
    if not done:
        return None
    return rate(sum(len(r.rows) for r in done), closed_window(run.window_start,
                                                                (r.end for r in done)))
