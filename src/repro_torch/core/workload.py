"""Filtered-vector-search workload generator (paper §4).

Given a vector dataset, queries, a selectivity and a correlation type,
produces one packed row-id bitmap per query, standing in for the result of
evaluating a relational predicate.

Correlation types (paper §4.2):
  high_pos   — softmax-biased sample from the closest THIRD of rows
  med_pos    — softmax-biased sample from the closest HALF
  low_pos    — softmax-biased sample from ALL rows (closer rows likelier)
  negative   — as low_pos with the ranking reversed (farther rows likelier)
  none       — uniform random sample

Sampling without replacement is Gumbel-top-k over a rank-based softmax, as
in the reference generator; the noise comes from a `torch.Generator` seeded
with the caller's seed, so the bits differ from the reference's (which uses
`jax.random`) while the popcount (`round(selectivity * n)`) and the
correlation ordering are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.types import (VectorStore, check_store_device,
                                    pack_bool_bitmap)

CORRELATIONS = ("high_pos", "med_pos", "low_pos", "negative", "none")
# The paper's nine selectivities (§5 Workloads): 0.01 .. 0.9.
PAPER_SELECTIVITIES = (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8, 0.9)

_POOL_FRAC = {"high_pos": 1.0 / 3.0, "med_pos": 0.5, "low_pos": 1.0,
              "negative": 1.0, "none": 1.0}
_BETA = 4.0          # the closest row of a pool is e^BETA likelier than the
#                      farthest (scale-free across datasets and metrics)
QUERY_CHUNK = 64     # queries per pass over the full (chunk, n) distances


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    selectivity: float
    correlation: str  # one of CORRELATIONS


def full_distances(store: VectorStore, queries: torch.Tensor) -> torch.Tensor:
    """(Q, N) dense distance matrix ||q||^2 + ||x||^2 - 2 q.x, -q.x for the
    inner product, or 1 - q.x / ((||q|| + 1e-12)(||x|| + 1e-12)) for cos
    (`types.distance`'s guards), its cross term as one matrix product."""
    q = queries.to(torch.float32)
    ip = q @ store.vectors.T
    if store.metric == "ip":
        return -ip
    if store.metric == "cos":
        qn = torch.linalg.norm(q, dim=-1) + 1e-12
        xn = torch.linalg.norm(store.vectors, dim=-1) + 1e-12
        return 1.0 - ip / (qn[:, None] * xn[None, :])
    if store.metric != "l2":
        raise ValueError(f"unknown metric {store.metric!r}")
    return (q * q).sum(-1, keepdim=True) + store.norms_sq[None, :] - 2.0 * ip


def query_distance_order(store: VectorStore,
                         queries: torch.Tensor) -> torch.Tensor:
    """(Q, N) int64 row ids sorted by increasing distance from each query
    (a stable sort: equal distances keep row order)."""
    return torch.sort(full_distances(store, queries), dim=1,
                      stable=True).indices


def _sample_chunk(order: torch.Tensor, n_sel: int, pool: int, negate: bool,
                  uniform: bool, gen: torch.Generator) -> torch.Tensor:
    """Gumbel-top-k biased sample of n_sel ids per row of `order` (rows
    sorted by distance), from its first `pool` entries; past the pool the
    rest is drawn uniformly (maximum-feasible-correlation completion)."""
    qc, n = order.shape
    dev = order.device
    if uniform:
        logits = torch.zeros(pool, device=dev)
    else:
        rank = torch.arange(pool, dtype=torch.float32, device=dev)
        rank = (pool - 1) - rank if negate else rank
        logits = -_BETA * rank / max(pool - 1, 1)
    u = torch.rand((qc, pool), generator=gen, device=dev).clamp_(min=1e-20)
    keys = logits[None, :] - torch.log(-torch.log(u))
    idx = torch.topk(keys, min(n_sel, pool), dim=1).indices
    chosen = torch.gather(order[:, :pool], 1, idx)
    if n_sel > pool:
        r = torch.rand((qc, n - pool), generator=gen, device=dev)
        extra = torch.topk(r, n_sel - pool, dim=1).indices
        chosen = torch.cat([chosen, torch.gather(order[:, pool:], 1, extra)],
                           1)
    return chosen


def _sample_params(store: VectorStore, spec: WorkloadSpec):
    if spec.correlation not in CORRELATIONS:
        raise ValueError(f"unknown correlation {spec.correlation!r}")
    if not (0.0 < spec.selectivity <= 1.0):
        raise ValueError("selectivity must be in (0, 1]")
    n = store.n
    n_sel = max(1, round(spec.selectivity * n))
    pool = max(n_sel if spec.correlation != "none" else 1,
               int(np.ceil(_POOL_FRAC[spec.correlation] * n)))
    return n_sel, min(pool, n)


def _passing_chunks(store: VectorStore, queries: torch.Tensor,
                    spec: WorkloadSpec, seed: int):
    """Yield (query slice, (chunk, n_sel) passing row ids) chunk by chunk."""
    n_sel, pool = _sample_params(store, spec)
    uniform = spec.correlation == "none"
    negate = spec.correlation == "negative"
    gen = torch.Generator(device=store.device)
    gen.manual_seed(seed)
    n = store.n
    for s in range(0, queries.shape[0], QUERY_CHUNK):
        qs = queries[s:s + QUERY_CHUNK]
        if uniform and pool == n:
            # a uniform sample of the whole store does not depend on the
            # distance order, so the (chunk, n) sort is skipped
            order = torch.arange(n, device=store.device).expand(qs.shape[0],
                                                                 n)
        else:
            order = torch.sort(full_distances(store, qs), dim=1,
                               stable=True).indices
        yield slice(s, s + qs.shape[0]), _sample_chunk(
            order, n_sel, pool, negate, uniform, gen)


def generate_passing_rows(store: VectorStore, queries: torch.Tensor,
                          spec: WorkloadSpec, seed: int = 0,
                          device="cuda") -> torch.Tensor:
    """(Q, n_sel) int64 ids of the rows satisfying each query's simulated
    predicate, distinct within a row."""
    check_store_device(store, device)
    return torch.cat([c for _, c in _passing_chunks(store, queries, spec,
                                                     seed)])


def generate_bitmaps(store: VectorStore, queries: torch.Tensor,
                     spec: WorkloadSpec, seed: int = 0,
                     device="cuda") -> torch.Tensor:
    """Per-query packed filter bitmaps, (Q, ceil(N/32)) int32 words."""
    dev = check_store_device(store, device)
    out = torch.empty((queries.shape[0], (store.n + 31) // 32),
                      dtype=torch.int32, device=dev)
    for sl, rows in _passing_chunks(store, queries, spec, seed):
        bits = torch.zeros((rows.shape[0], store.n), dtype=torch.bool,
                           device=dev)
        bits.scatter_(1, rows, True)
        out[sl] = pack_bool_bitmap(bits)
    return out


def generate_grid(store: VectorStore, queries: torch.Tensor,
                  selectivities: Sequence[float] = PAPER_SELECTIVITIES,
                  correlations: Sequence[str] = CORRELATIONS,
                  seed: int = 0, device="cuda"
                  ) -> dict[tuple[float, str], torch.Tensor]:
    """The paper's full workload grid: {(selectivity, correlation): (Q, W)
    bitmaps}, correlation-major; each cell takes the next seed, as in the
    reference."""
    grid = {}
    for corr in correlations:
        for sel in selectivities:
            grid[(sel, corr)] = generate_bitmaps(
                store, queries, WorkloadSpec(sel, corr), seed, device=device)
            seed += 1
    return grid


def generate_families(store: VectorStore, selectivity: float,
                      num_families: int = 2, seed: int = 0,
                      device="cuda") -> dict[str, torch.Tensor]:
    """Hot predicate families for the selectivity-aware tiers: family f
    passes the ceil(selectivity·n) rows nearest a random centre row (numpy
    RandomState(seed), as in the reference).  Returns tag -> packed (W,)
    int32 bitmap on the store's device.  Equal distances may order
    differently from the reference's unstable argsort, so a boundary row
    can differ; the popcount and the nearest-rows property hold."""
    dev = check_store_device(store, device)
    if not (0.0 < selectivity <= 1.0):
        raise ValueError("selectivity must be in (0, 1]")
    n = store.n
    n_sel = max(2, int(np.ceil(selectivity * n)))
    rng = np.random.RandomState(seed)
    centers = rng.choice(n, size=num_families, replace=False)
    cvecs = store.vectors[torch.as_tensor(centers, device=dev)]
    d = full_distances(store, cvecs)                          # (F, N)
    out = {}
    for f in range(len(centers)):
        rows = torch.sort(d[f], stable=True).indices[:n_sel]
        bits = torch.zeros(n, dtype=torch.bool, device=dev)
        bits[rows] = True
        out[f"fam{f}_s{selectivity:g}"] = pack_bool_bitmap(bits)
    return out


def assign_family_bitmaps(families: dict[str, torch.Tensor],
                          num_queries: int, seed: int = 0
                          ) -> tuple[torch.Tensor, np.ndarray]:
    """Random assignment of queries to families (numpy RandomState(seed),
    as in the reference): each query carries its family's bitmap verbatim.
    Returns ((Q, W) int32 bitmaps, (Q,) int32 family index into
    sorted(families))."""
    tags = sorted(families)
    rng = np.random.RandomState(seed)
    assign = rng.randint(0, len(tags), size=num_queries).astype(np.int32)
    fam = torch.stack([families[t] for t in tags])
    return fam[torch.as_tensor(assign, device=fam.device).long()], assign


def empirical_correlation(store: VectorStore, query: torch.Tensor,
                          passing_rows: torch.Tensor, k: int = 100) -> float:
    """Fraction of the query's k unfiltered nearest neighbours that pass:
    a measurable proxy for vector-predicate correlation."""
    d = full_distances(store, query[None])[0]
    nn = torch.sort(d, stable=True).indices[:k]
    return float(torch.isin(nn, passing_rows.to(nn.device)).float().mean())
