"""The one traffic generator: a traffic file's filters, batch and
arrivals turned into the query pool's bitmaps and the window's schedule.

Filters follow the program's workload recipe (paper §4: a selectivity and
a correlation type per query), rewritten here so that the yardstick does
not move with the program.  A query's passing rows are a Gumbel-top-k
sample, without replacement, over a rank-based softmax of its distance
order: `high_pos` samples the closest third of the rows, `med_pos` the
closest half, `low_pos` all rows with the closer likelier, `negative` the
farther likelier, and `none` is a uniform sample.  Each query passes
exactly `round(selectivity * n)` rows.

A traffic file may hold several filters, each with its share of the pool
(`"filters": [{"selectivity": .., "correlation": .., "share": ..}]`), and
arrivals that are a closed loop (`{"kind": "closed"}`: the next batch goes
out when the last one is back) or an open one (`{"kind": "poisson",
"rate_qps": r}`: queries fall due on a Poisson schedule drawn from the
seed, and a batch takes those that are due, at most `batch` of them).
"""
from __future__ import annotations

import math

import numpy as np
import torch

CORRELATIONS = ("high_pos", "med_pos", "low_pos", "negative", "none")
_POOL_FRAC = {"high_pos": 1.0 / 3.0, "med_pos": 0.5, "low_pos": 1.0,
              "negative": 1.0, "none": 1.0}
_BETA = 4.0        # the closest row of a pool is e^BETA likelier than the
#                    farthest
QUERY_CHUNK = 64   # queries per pass over the (chunk, n) distances


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream of draws (data, filters, order,
    builds), below 2**32 so numpy's RandomState takes it too."""
    x = (seed * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9) \
        % 2 ** 64
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) % 2 ** 64
    return (x ^ (x >> 29)) % 2 ** 32


def l2_distances(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared L2 distances, the cross term as one product."""
    return (queries * queries).sum(1, keepdim=True) \
        + (rows * rows).sum(1)[None, :] - 2.0 * (queries @ rows.T)


def _pack_rows(chosen: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, s) distinct row ids per query -> (Q, ceil(n / 32)) int32 words,
    bit r & 31 of word r >> 5 set for each chosen row r."""
    words = torch.zeros((chosen.shape[0], (n + 31) // 32), dtype=torch.int64,
                        device=chosen.device)
    bit = torch.bitwise_left_shift(torch.ones_like(chosen), chosen & 31)
    words.scatter_add_(1, chosen >> 5, bit)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _sample(order: torch.Tensor, n_sel: int, pool: int, negate: bool,
            gen: torch.Generator) -> torch.Tensor:
    """n_sel ids per row of `order` (row ids by increasing distance):
    Gumbel-top-k over the first `pool`, then uniform over the rest."""
    qc, n = order.shape
    dev = order.device
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


def _all_rows(n: int, dev) -> torch.Tensor:
    """(ceil(n / 32),) int32 words with every row's bit set."""
    words = torch.full(((n + 31) // 32,), -1, dtype=torch.int32, device=dev)
    if n % 32:
        words[-1] = (1 << (n % 32)) - 1
    return words


def _uniform(qc: int, n: int, n_sel: int, gen: torch.Generator, dev
             ) -> torch.Tensor:
    """Packed words of a uniform sample of n_sel distinct rows per query.
    Past half the rows the rows left out are drawn instead."""
    keys = torch.rand((qc, n), generator=gen, device=dev)
    if n_sel <= n // 2:
        return _pack_rows(torch.topk(keys, n_sel, dim=1).indices, n)
    out = _pack_rows(torch.topk(keys, n - n_sel, dim=1).indices, n)
    return torch.bitwise_xor(_all_rows(n, dev)[None, :], out)


def filter_bitmaps(rows: torch.Tensor, queries: torch.Tensor,
                   selectivity: float, correlation: str, seed: int
                   ) -> torch.Tensor:
    """(Q, ceil(n / 32)) int32 packed bitmaps, one per query."""
    if correlation not in CORRELATIONS:
        raise ValueError(f"unknown correlation {correlation!r}")
    if not 0.0 < selectivity <= 1.0:
        raise ValueError("selectivity must be in (0, 1]")
    n = rows.shape[0]
    dev = rows.device
    n_sel = max(1, round(selectivity * n))
    pool = min(n, max(n_sel if correlation != "none" else 1,
                      math.ceil(_POOL_FRAC[correlation] * n)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = torch.empty((queries.shape[0], (n + 31) // 32), dtype=torch.int32,
                      device=dev)
    for s in range(0, queries.shape[0], QUERY_CHUNK):
        qs = queries[s:s + QUERY_CHUNK]
        if correlation == "none":
            out[s:s + qs.shape[0]] = _uniform(qs.shape[0], n, n_sel, gen,
                                              dev)
            continue
        order = torch.sort(l2_distances(rows, qs), dim=1,
                           stable=True).indices
        chosen = _sample(order, n_sel, pool, correlation == "negative", gen)
        out[s:s + qs.shape[0]] = _pack_rows(chosen, n)
    return out


def filters_of(traffic: dict) -> list[dict]:
    """The traffic's filters with their shares; one filter by default."""
    if "filters" in traffic:
        return traffic["filters"]
    return [{"selectivity": traffic["selectivity"],
             "correlation": traffic["correlation"], "share": 1.0}]


def pool_bitmaps(rows: torch.Tensor, queries: torch.Tensor, traffic: dict,
                 seed: int) -> tuple[torch.Tensor, np.ndarray]:
    """Bitmaps of the whole pool and each query's filter index: the pool is
    cut into consecutive spans by the filters' shares."""
    filters = filters_of(traffic)
    total = sum(f["share"] for f in filters)
    p = queries.shape[0]
    bounds = np.round(np.cumsum([0.0] + [f["share"] / total
                                         for f in filters]) * p).astype(int)
    out = torch.empty((p, (rows.shape[0] + 31) // 32), dtype=torch.int32,
                      device=rows.device)
    label = np.zeros(p, np.int32)
    for i, f in enumerate(filters):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if hi > lo:
            out[lo:hi] = filter_bitmaps(rows, queries[lo:hi],
                                        f["selectivity"], f["correlation"],
                                        sub_seed(seed, i))
        label[lo:hi] = i
    return out, label


def query_order(pool: int, seed: int) -> np.ndarray:
    """The order the window sends the pool in; it wraps around."""
    return np.random.RandomState(seed).permutation(pool)


def due_times(arrivals: dict, count: int, seed: int) -> np.ndarray | None:
    """Seconds after the window opens at which each of the first `count`
    queries falls due, or None for a closed loop."""
    kind = arrivals.get("kind", "closed")
    if kind == "closed":
        return None
    if kind != "poisson":
        raise ValueError(f"unknown arrivals {kind!r}")
    gaps = np.random.RandomState(seed).exponential(
        1.0 / arrivals["rate_qps"], count)
    return np.cumsum(gaps)
