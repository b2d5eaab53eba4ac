"""Share of the traced window in which nothing ran on the card."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["window_s"]) * 100.0
