"""Mean `SearchStats.filter_checks` (bitmap probes) per answered query."""


def read(run):
    return float(run.counter("filter_checks").mean())
