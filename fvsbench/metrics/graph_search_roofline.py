"""A graph search's share of the card's roofline: the least time the work
the batch's counters say it needs could take, over the device's busy
time in the trace.

The work, from counters and shapes only, so it reads the same whatever
kernel does it: every scored row (`distance_comps`) read once as float32
and its distance taken (2 * dim FLOPs), every filter check a 4-byte
bitmap word, and each of the k results written (an id and a distance,
8 bytes)."""
from fvsbench import peaks


def least_seconds(distance_comps: int, filter_checks: int, results: int,
                  dim: int) -> float:
    flops = 2.0 * dim * distance_comps
    nbytes = 4.0 * dim * distance_comps + 4.0 * filter_checks + 8.0 * results
    return max(flops / peaks.FP32_FLOPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0 \
            or run.cell.method.startswith("scann"):
        return None
    t = least_seconds(int(run.counter("distance_comps").sum()),
                      int(run.counter("filter_checks").sum()),
                      run.answered * run.k, run.dim)
    return t / run.trace["busy_s"] * 100.0
