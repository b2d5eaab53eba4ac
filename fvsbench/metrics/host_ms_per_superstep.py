"""Host milliseconds a superstep: the traced batches' wall time (host
clock) less the device's busy time in the trace, over their supersteps
(a batch's largest `SearchStats.hops`)."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0 \
            or run.cell.method.startswith("scann"):
        return None
    wall = sum(b.done - b.submitted for b in run.batches)
    steps = sum(int(b.stats["hops"].max()) for b in run.batches)
    return (wall - run.trace["busy_s"]) / steps * 1e3
