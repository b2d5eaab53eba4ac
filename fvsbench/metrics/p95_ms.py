"""95th percentile of per-query latency over every query of the window: a
query's latency runs from its batch's submission (open loop: from when it
fell due) until its batch's ids and distances are on the host."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies(), 95)) * 1e3
