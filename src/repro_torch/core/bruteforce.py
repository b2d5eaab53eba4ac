"""Exact (optionally filtered) KNN: the ground truth of every recall number.

Queries are processed in chunks so the (chunk, N) distance block stays
bounded at millions of rows; the top-k is a stable sort, so ties keep the
lowest row id first, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import (VectorStore, topk_smallest,
                                    unpack_bitmap)
from repro_torch.core.workload import QUERY_CHUNK, full_distances

INF = float("inf")


def knn(store: VectorStore, queries: torch.Tensor, k: int):
    """Unfiltered exact top-k. Returns (dists, ids) each (Q, k)."""
    outs = [topk_smallest(full_distances(store, queries[s:s + QUERY_CHUNK]),
                          k) for s in range(0, queries.shape[0], QUERY_CHUNK)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def filtered_knn(store: VectorStore, queries: torch.Tensor,
                 bitmaps: torch.Tensor, k: int):
    """Exact top-k restricted to rows whose bitmap bit is set.

    bitmaps: (Q, ceil(N/32)) int32.  Rows failing the filter get +inf.
    Returns (dists, ids); ids are -1 where fewer than k rows pass."""
    ds, ids = [], []
    for s in range(0, queries.shape[0], QUERY_CHUNK):
        d = full_distances(store, queries[s:s + QUERY_CHUNK])
        passing = unpack_bitmap(bitmaps[s:s + QUERY_CHUNK], store.n)
        d = torch.where(passing, d, torch.full_like(d, INF))
        dk, idx = topk_smallest(d, k)
        ds.append(dk)
        ids.append(torch.where(torch.isinf(dk), torch.full_like(idx, -1),
                               idx))
    return torch.cat(ds), torch.cat(ids)


def filtered_knn_partial(store: VectorStore, queries: torch.Tensor,
                         bitmaps: torch.Tensor, k: int, max_rows: int):
    """Budgeted partial seqscan: exact top-k over the first `max_rows`
    PASSING rows in row order.  Returns (dists, ids, n_scored, probes,
    truncated), all per query: passing rows fetched and scored, rows probed
    before the scan stopped (n when it never stopped), and whether the cap
    cut the scan short."""
    d = full_distances(store, queries)
    passing = unpack_bitmap(bitmaps, store.n)
    cum = torch.cumsum(passing.to(torch.int32), 1)
    scored = passing & (cum <= max_rows)
    d = torch.where(scored, d, torch.full_like(d, INF))
    dists, idx = topk_smallest(d, k)
    idx = torch.where(torch.isinf(dists), torch.full_like(idx, -1), idx)
    n_scored = scored.sum(1).to(torch.int32)
    truncated = cum[:, -1] > max_rows
    first_over = torch.argmax((cum > max_rows).to(torch.int32), 1)
    probes = torch.where(truncated, first_over.to(torch.int32) + 1,
                         torch.full_like(n_scored, store.n))
    return dists, idx, n_scored, probes, truncated
