"""Mean over every answered query of its overlap with the reference's
exact filtered top-k (k = 10 in every cell)."""


def read(run):
    return float(run.recall.mean())
