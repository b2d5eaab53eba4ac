"""Seconds from the start of the process until the warm-up batch is back:
imports, inputs, the index build, the kernels' build on a checkout's
first run, and one batch."""


def read(run):
    return run.setup_s
