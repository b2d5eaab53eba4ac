"""Query-hardness metrics (paper §5, Table 2): LID and LRC, and Table 2's
distance-versus-filter relative cost.

LID — Local Intrinsic Dimensionality, MLE estimator (Amsaleg et al. 2015):
  LID(q) = - (1/k · Σ_i ln(d_i / d_k))^{-1}  over the query's k NNs.
LRC — how little the query's UNFILTERED nearest neighbours overlap its
  FILTERED ones at a reference selectivity: 1 − |NN_unf ∩ NN_filt| / k,
  in [0, 1]; higher = harder.

The distances are `workload.full_distances` on the store's device, a block
of queries at a time, so the (Q, N) matrix is never whole.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import workload
from repro_torch.core.types import (VectorStore, check_store_device,
                                    pack_bool_bitmap, probe_batch)

# queries whose (block, N) distances are held at a time
QUERY_BLOCK = 256


def lid_mle(store: VectorStore, queries: torch.Tensor, k: int = 100,
            device="cuda") -> float:
    """Mean MLE local intrinsic dimensionality over the queries' k nearest
    rows, each query's LID clipped to [0, 1e4]."""
    check_store_device(store, device)
    lids = []
    for s in range(0, queries.shape[0], QUERY_BLOCK):
        d = workload.full_distances(store, queries[s:s + QUERY_BLOCK])
        d = torch.topk(d, min(k, store.n), dim=1, largest=False).values
        d = d.to(torch.float64)
        if store.metric == "l2":
            d = torch.sqrt(d.clamp(min=1e-12))
        else:
            # inner-product "distances" are negative: shift each query's
            # onto a positive ray
            d = d - d[:, :1] + 1e-3 * (d[:, -1:] - d[:, :1] + 1e-9)
        ratios = torch.log(d[:, :-1].clamp(min=1e-12)
                           / d[:, -1:].clamp(min=1e-12))
        lids.append(-1.0 / ratios.mean(1))
    return float(torch.cat(lids).clamp(0, 1e4).mean())


def lrc(store: VectorStore, queries: torch.Tensor, k: int = 10,
        selectivity: float = 0.1, seed: int = 0,
        correlation: str = "low_pos", device="cuda") -> float:
    """Mean over the queries of 1 − |NN_unf ∩ NN_filt| / k for the
    predicate `generate_passing_rows` simulates at (selectivity,
    correlation).  The filtered k nearest are the first k passing rows of
    the distance order, so the overlap is the number of passing rows among
    the k unfiltered nearest; rows are ranked by a stable sort."""
    dev = check_store_device(store, device)
    rows = workload.generate_passing_rows(
        store, queries, workload.WorkloadSpec(selectivity, correlation),
        seed, device=device).to(dev)
    vals = []
    for s in range(0, queries.shape[0], QUERY_BLOCK):
        d = workload.full_distances(store, queries[s:s + QUERY_BLOCK])
        top = torch.sort(d, dim=1, stable=True).indices[:, :k]
        passing = torch.zeros(d.shape, dtype=torch.bool, device=dev)
        passing.scatter_(1, rows[s:s + QUERY_BLOCK], True)
        hits = passing.gather(1, top).sum(1)
        vals.append(1.0 - hits.to(torch.float64) / k)
    return float(torch.cat(vals).mean())


def dist_filter_relative_cost(dim: int, trials: int = 50, n: int = 4096,
                              device="cuda") -> float:
    """Paper Table 2 'Dist-Filt. Rel. Cost': the time of n distance
    computations over the time of n bitmap probes, each a torch call on
    `device` timed in isolation (library-style, no storage engine): CUDA
    events on a card, the host clock on the CPU.  The inputs are numpy's
    RandomState(0) draws, as in the reference."""
    dev = torch.device(device)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(n, dim).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.randn(dim).astype(np.float32), device=dev)
    bm = pack_bool_bitmap(torch.as_tensor(rng.rand(n) < 0.5, device=dev))
    ids = torch.as_tensor(rng.randint(0, n, n), device=dev)

    def dist():
        return ((x - q) ** 2).sum(-1)

    def probe():
        return probe_batch(bm[None], ids[None])

    return _seconds(dist, trials, dev) / max(_seconds(probe, trials, dev),
                                             1e-9)


def _seconds(fn, trials: int, dev: torch.device) -> float:
    """Seconds of `trials` back-to-back calls after one warm-up call."""
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(trials):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(trials):
        fn()
    return time.perf_counter() - t0
