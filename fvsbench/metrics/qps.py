"""Queries answered in the window over the window's whole time."""


def read(run):
    return run.answered / run.window_s
