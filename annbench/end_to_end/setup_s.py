"""Set-up: process start to the window's start (imports, CUDA start, inputs,
kernel build on a checkout's first run, index build, warm-up)."""


def read(run):
    return run.setup_s
