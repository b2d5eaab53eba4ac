"""Mean `SearchStats.distance_comps` (rows scored) per answered query."""


def read(run):
    return float(run.counter("distance_comps").mean())
