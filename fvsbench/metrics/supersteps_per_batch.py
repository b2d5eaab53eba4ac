"""Supersteps a graph batch runs: the lockstep loop runs until its slowest
lane stops, so the batch's largest `SearchStats.hops`, averaged over the
window's batches.  Nothing to read for a ScaNN search."""
import numpy as np


def supersteps(batch):
    return int(batch.stats["hops"].max())


def read(run):
    if run.cell.method.startswith("scann"):
        return None
    return float(np.mean([supersteps(b) for b in run.batches]))
