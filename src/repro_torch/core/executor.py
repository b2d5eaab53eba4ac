"""Executor layer: every search strategy of the slice behind one API.

    Executor.plan(queries, bitmaps, params)  -> SearchPlan
    Executor.execute(plan)                   -> SearchResult
    Executor.search(queries, bitmaps, params) = execute(plan(...))

`GraphExecutor` (the frontier engine), `ScannExecutor` (the query-batched
pipeline) and `BruteForceExecutor` (exact filtered KNN with seqscan
counters) are ports of the reference executors of the same names, without
storage accounting, exclusion radii or the stepped driver.  `make_executor`
builds them by method name; the reference's other methods raise
NotImplementedError naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.bruteforce import filtered_knn, filtered_knn_partial
from repro_torch.core.graph_search import search_batch
from repro_torch.core.hnsw import HNSWGraph
from repro_torch.core.scann import (ScannIndex, leaves_within_budget,
                                    scann_search_batch)
from repro_torch.core.types import (SearchParams, SearchResult, SearchStats,
                                    VectorStore, bitmap_popcount,
                                    check_store_device, heap_pages_per_vector)

GRAPH_STRATEGIES = costmodel.GRAPH_STRATEGIES
PORTED_METHODS = GRAPH_STRATEGIES + ("scann", "bruteforce")

# Methods of the reference's registry that this slice does not run yet,
# with the ROADMAP item that ports them.
_NOT_PORTED = {
    "adaptive": "ROADMAP 1.6b (AdaptivePlanner, slice 2)",
    "scann_vmapped": "ROADMAP 1.8 (legacy vmapped engines)",
    "sweeping_excl": "ROADMAP 1.9 (selectivity-aware tiers)",
    "sweeping_excl_sq8": "ROADMAP 1.9 (selectivity-aware tiers)",
    "partitioned": "ROADMAP 1.9 (selectivity-aware tiers)",
    "partitioned_sq8": "ROADMAP 1.9 (selectivity-aware tiers)",
    "delta": "ROADMAP 1.11 (mutability)",
}


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """What an executor decided to run for one query batch."""

    strategy: str
    params: SearchParams
    queries: Any                   # (Q, d)
    bitmaps: Any                   # (Q, words) int32
    notes: Any = None              # plan-level adjustments (budget clamps)


@runtime_checkable
class Executor(Protocol):
    """Anything that can plan and execute filtered top-k search."""

    name: str
    store: VectorStore

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan: ...

    def execute(self, plan: SearchPlan) -> SearchResult: ...

    def search(self, queries, bitmaps,
               params: SearchParams) -> SearchResult: ...


class BaseExecutor:
    """plan/execute split with the one-call convenience wrapper."""

    name: str = "base"

    def search(self, queries, bitmaps, params: SearchParams) -> SearchResult:
        return self.execute(self.plan(queries, bitmaps, params))

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        raise NotImplementedError

    def execute(self, plan: SearchPlan) -> SearchResult:
        raise NotImplementedError


class GraphExecutor(BaseExecutor):
    """The graph strategies (paper §2.3) on the frontier engine."""

    def __init__(self, graph: HNSWGraph, store: VectorStore,
                 strategy: str = "sweeping"):
        if strategy not in GRAPH_STRATEGIES:
            raise ValueError(f"unknown graph strategy {strategy!r}")
        self.graph = graph
        self.store = store
        self.strategy = strategy
        self.name = strategy

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        if params.strategy != self.strategy:
            params = dataclasses.replace(params, strategy=self.strategy)
        return SearchPlan(self.strategy, params, queries, bitmaps)

    def execute(self, plan: SearchPlan) -> SearchResult:
        d, ids, stats = search_batch(self.graph, self.store, plan.queries,
                                     plan.bitmaps, plan.params)
        return SearchResult(dists=d, ids=ids, stats=stats,
                            strategy=self.strategy, plan=plan,
                            anytime=costmodel.evaluate_anytime(
                                stats, plan.params, self.store.dim, ids,
                                hop_cap=plan.params.max_hops))


class ScannExecutor(BaseExecutor):
    """Filtered ScaNN (paper §2.3.7), query-batched pipeline."""

    name = "scann"

    def __init__(self, index: ScannIndex, store: VectorStore):
        self.index = index
        self.store = store

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        if params.strategy != "scann":
            params = dataclasses.replace(params, strategy="scann")
        # anytime budgets clamp the (static) number of leaves at plan time
        nl, clamped = leaves_within_budget(self.index, self.store, params)
        notes = None
        if clamped:
            params = dataclasses.replace(params, num_leaves_to_search=nl)
            notes = {"leaf_clamp": nl}
        return SearchPlan("scann", params, queries, bitmaps, notes=notes)

    def execute(self, plan: SearchPlan) -> SearchResult:
        d, ids, stats = scann_search_batch(self.index, self.store,
                                           plan.queries, plan.bitmaps,
                                           plan.params)
        clamped = plan.notes is not None and "leaf_clamp" in plan.notes
        anytime = costmodel.evaluate_anytime(
            None, plan.params, self.store.dim, ids,
            extra_budget=np.full((ids.shape[0],), clamped, bool))
        return SearchResult(dists=d, ids=ids, stats=stats, strategy="scann",
                            plan=plan, anytime=anytime)


class BruteForceExecutor(BaseExecutor):
    """Exact filtered KNN with seqscan counters: every row is
    filter-checked; passing rows are fetched from the heap and scored."""

    name = "bruteforce"

    def __init__(self, store: VectorStore):
        self.store = store

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        if params.strategy != "bruteforce":
            params = dataclasses.replace(params, strategy="bruteforce")
        max_rows = self._budget_rows(params)
        notes = {"max_rows": max_rows} if max_rows is not None else None
        return SearchPlan("bruteforce", params, queries, bitmaps,
                          notes=notes)

    def _budget_rows(self, params: SearchParams) -> Optional[int]:
        """The passing-row cap a page or deadline budget affords (at least
        k), or None when the whole scan fits."""
        if params.page_budget <= 0 and params.deadline_cycles <= 0:
            return None
        n = self.store.n
        ppv = heap_pages_per_vector(self.store.dim)
        rows = n
        if params.page_budget > 0:
            rows = min(rows, params.page_budget // ppv)
        if params.deadline_cycles > 0:
            w = costmodel.budget_cycle_weights(self.store.dim)
            per_row = w["distance_comps"] + ppv * w["page_accesses_heap"]
            fixed = n * w["filter_checks"]
            rows = min(rows, int(max(params.deadline_cycles - fixed, 0.0)
                                 // max(per_row, 1e-9)))
        rows = max(min(rows, n), params.k)
        return None if rows >= n else rows

    def execute(self, plan: SearchPlan) -> SearchResult:
        q = plan.queries.shape[0]
        n = self.store.n
        ppv = heap_pages_per_vector(self.store.dim)
        z = torch.zeros((q,), dtype=torch.int32, device=plan.queries.device)
        max_rows = (plan.notes or {}).get("max_rows")
        if max_rows is None:
            d, ids = filtered_knn(self.store, plan.queries, plan.bitmaps,
                                  plan.params.k)
            npass = bitmap_popcount(plan.bitmaps)
            stats = SearchStats(
                distance_comps=npass, filter_checks=z + n, hops=z,
                page_accesses_index=z, page_accesses_heap=npass * ppv,
                tmap_lookups=z, reorder_rows=z)
            truncated = np.zeros((q,), bool)
        else:
            d, ids, n_scored, probes, trunc = filtered_knn_partial(
                self.store, plan.queries, plan.bitmaps, plan.params.k,
                max_rows)
            stats = SearchStats(
                distance_comps=n_scored, filter_checks=probes, hops=z,
                page_accesses_index=z, page_accesses_heap=n_scored * ppv,
                tmap_lookups=z, reorder_rows=z)
            truncated = trunc.cpu().numpy()
        return SearchResult(dists=d, ids=ids.to(torch.int32), stats=stats,
                            strategy="bruteforce", plan=plan,
                            anytime=costmodel.evaluate_anytime(
                                None, plan.params, self.store.dim, ids,
                                extra_budget=truncated))


def make_executor(method: str, store: VectorStore, *,
                  graph: Optional[HNSWGraph] = None,
                  index: Optional[ScannIndex] = None,
                  device="cuda") -> Executor:
    """Build the executor for `method` on `device` (the store must live
    there): a graph strategy needs `graph`, "scann" needs `index`."""
    check_store_device(store, device)
    if method in GRAPH_STRATEGIES:
        if graph is None:
            raise ValueError(f"{method!r} needs graph=")
        return GraphExecutor(graph, store, strategy=method)
    if method == "scann":
        if index is None:
            raise ValueError(f"{method!r} needs index=")
        return ScannExecutor(index, store)
    if method == "bruteforce":
        return BruteForceExecutor(store)
    if method in _NOT_PORTED:
        raise NotImplementedError(f"{method!r} is not ported yet: "
                                  f"{_NOT_PORTED[method]}")
    if method.endswith("_sq8") and method[:-4] in GRAPH_STRATEGIES:
        raise NotImplementedError(f"{method!r} is not ported yet: ROADMAP "
                                  "1.4b (the SQ8 graph tier, slice 2)")
    raise ValueError(f"unknown method {method!r}; ported: {PORTED_METHODS}")
