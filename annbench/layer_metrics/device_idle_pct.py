"""The share of the traced slice in which no kernel ran on the device: one
reader for every cell's ``device_idle_pct.<part>``."""


def read(run):
    if run.slice is None or run.slice.window_s <= 0 or run.slice.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
