"""Executor layer: every search strategy of the port behind one API.

    Executor.plan(queries, bitmaps, params)  -> SearchPlan
    Executor.execute(plan)                   -> SearchResult
    Executor.search(queries, bitmaps, params) = execute(plan(...))

`GraphExecutor` (the frontier engine, with the SQ8 tier and FAVOR
exclusion pruning, and the stepped driver's hooks that continuous batching
calls), `PartitionedGraphExecutor` (JAG family subgraphs),
`ScannExecutor` (the query-batched pipeline, or the legacy per-query one),
`BruteForceExecutor` (exact filtered KNN with seqscan counters),
`DeltaExecutor` (the exact scan of the mutable delta tier) and
`AdaptivePlanner` (per-batch system-aware dispatch on the predictive cost
model) are ports of the reference executors of the same names.  With a
`storage` engine (`storage.make_storage_engine`)
attached, a search also collects its access trace and replays it through
the buffer pool: the result carries measured StorageStats, and the planner
prices each candidate with the pool's residency.  `make_executor` builds
them by method name, as the reference's registry does ("delta" is not a
method there either: `core.mutable.MutableIndex` builds its
`DeltaExecutor` itself).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Mapping, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.bruteforce import filtered_knn, filtered_knn_partial
from repro_torch.core.exclusion import (ExclusionIndex, match_families,
                                        select_radii)
from repro_torch.core.graph_search import (FrontierState, frontier_finalize,
                                           frontier_idle, frontier_init,
                                           frontier_write_slot, search_batch,
                                           step_supersteps)
from repro_torch.core.hnsw import HNSWGraph, PartitionedGraph
from repro_torch.core.scann import (ScannIndex, _quant_pages_per_leaf,
                                    leaves_within_budget, project_query,
                                    scann_search_batch,
                                    scann_search_batch_vmapped)
from repro_torch.core.types import (SearchParams, SearchResult, SearchStats,
                                    VectorStore, bitmap_popcount,
                                    check_store_device, heap_pages_per_vector,
                                    pack_bool_bitmap, probe_batch,
                                    quantize_store, topk_smallest)
from repro_torch.core.workload import QUERY_CHUNK, exact_distances
from repro_torch.storage.engine import (TRACE_UNTOUCHED, StorageEngine,
                                        merge_storage_stats)

GRAPH_STRATEGIES = costmodel.GRAPH_STRATEGIES
GRAPH_SQ8_METHODS = tuple(f"{s}_sq8" for s in GRAPH_STRATEGIES)
EXCL_METHODS = ("sweeping_excl", "sweeping_excl_sq8")
PARTITIONED_METHODS = ("partitioned", "partitioned_sq8")
REGISTERED_METHODS = GRAPH_STRATEGIES + GRAPH_SQ8_METHODS + EXCL_METHODS \
    + PARTITIONED_METHODS + ("scann", "scann_vmapped", "bruteforce",
                             "adaptive")
DEFAULT_PLANNER_CANDIDATES = ("bruteforce", "scann", "sweeping",
                              "sweeping_sq8", "navix", "iterative_scan")


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """What an executor decided to run for one query batch."""

    strategy: str
    params: SearchParams
    queries: Any                   # (Q, d)
    bitmaps: Any                   # (Q, words) int32
    # planner annotations (None for fixed executors)
    est_selectivity: Optional[np.ndarray] = None    # (Q,) popcount / n
    correlation_proxy: Optional[float] = None       # local / global density
    predicted_cycles: Optional[Mapping[str, float]] = None
    notes: Any = None              # plan-level adjustments (budget clamps,
    #                                radii, partition matches)


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
    """The graph strategies (paper §2.3) on the frontier engine, on the
    full-precision or the SQ8 tier (`graph_quant`), with FAVOR exclusion
    pruning when an `exclusion` index is given (sweeping, l2 only).  With
    a `storage` engine the search collects its trace (ids, dists and
    counters unchanged) and the result carries measured StorageStats."""

    def __init__(self, graph: HNSWGraph, store: VectorStore,
                 strategy: str = "sweeping", graph_quant: str = "none",
                 exclusion: Optional[ExclusionIndex] = None,
                 storage: Optional[StorageEngine] = None):
        if strategy not in GRAPH_STRATEGIES:
            raise ValueError(f"unknown graph strategy {strategy!r}")
        if graph_quant not in ("none", "sq8"):
            raise ValueError(f"unknown graph_quant {graph_quant!r}")
        if storage is not None and storage.graph is None:
            raise ValueError("storage engine lacks a graph adjacency "
                             "layout; build it with graph=")
        if graph_quant == "sq8":
            if not store.has_sq8:
                raise ValueError("graph_quant='sq8' needs a quantize_store'd"
                                 " VectorStore (SQ8 shadow missing)")
            if storage is not None and storage.qheap is None:
                raise ValueError("storage engine lacks the qheap (SQ8 "
                                 "shadow) segment; build it from the "
                                 "quantized store")
        if exclusion is not None:
            # the keep rule is a triangle-inequality argument in l2 root
            # space, composed with sweeping's W-tail threshold
            if strategy != "sweeping":
                raise ValueError("exclusion pruning only composes with the "
                                 "sweeping strategy")
            if store.metric != "l2":
                raise ValueError("exclusion pruning needs metric='l2'")
            if exclusion.n != store.n:
                raise ValueError(
                    f"exclusion index built over n={exclusion.n} rows but "
                    f"store has n={store.n} (stale radii)")
        self.graph = graph
        self.store = store
        self.strategy = strategy
        self.graph_quant = graph_quant
        self.exclusion = exclusion
        self.storage = storage
        base = strategy if exclusion is None else f"{strategy}_excl"
        self.name = base if graph_quant == "none" \
            else f"{base}_{graph_quant}"

    def resolve_params(self, params: SearchParams) -> SearchParams:
        """The executor's strategy and tier on the caller's params; an
        exclusion mode is dropped on an executor without radii."""
        if params.strategy != self.strategy or \
                params.graph_quant != self.graph_quant:
            params = dataclasses.replace(params, strategy=self.strategy,
                                         graph_quant=self.graph_quant)
        if self.exclusion is None and params.exclusion != "none":
            params = dataclasses.replace(params, exclusion="none")
        return params

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        params = self.resolve_params(params)
        notes = None
        if self.exclusion is not None:
            # family-exact radii when the whole batch hits registered
            # families ("prune_exact": a family radius is 0 iff the row
            # passes, so a pruned candidate's probe is provably moot);
            # any other query demotes the batch to the ladder ("prune")
            fam = match_families(self.exclusion, bitmaps)
            mode = "prune_exact" if fam.numel() and bool((fam >= 0).all()) \
                else "prune"
            params = dataclasses.replace(params, exclusion=mode)
            notes = {"excl": select_radii(self.exclusion, bitmaps)}
        return SearchPlan(self.strategy, params, queries, bitmaps,
                          notes=notes)

    # ---- the stepped frontier driver, for continuous batching: trace
    # collection follows the storage attachment, as in `execute`

    def _no_stepped_exclusion(self):
        if self.exclusion is not None:
            raise ValueError("exclusion pruning is not supported by the "
                             "stepped frontier driver (radii don't ride in "
                             "FrontierState); use the one-shot search path")

    def idle_frontier(self, params: SearchParams,
                      width: int) -> FrontierState:
        self._no_stepped_exclusion()
        return frontier_idle(self.graph, self.store,
                             self.resolve_params(params), width,
                             collect_trace=self.storage is not None)

    def init_frontier(self, queries, bitmaps, params: SearchParams,
                      deadlines=None) -> FrontierState:
        self._no_stepped_exclusion()
        return frontier_init(self.graph, self.store, queries, bitmaps,
                             self.resolve_params(params),
                             collect_trace=self.storage is not None,
                             deadlines=deadlines)

    def write_frontier_slot(self, state: FrontierState,
                            lane: FrontierState, slot: int) -> FrontierState:
        return frontier_write_slot(state, lane, slot)

    def step_frontier(self, state: FrontierState, params: SearchParams,
                      n_hops: int, dynamic_deadline: bool = False
                      ) -> FrontierState:
        return step_supersteps(self.graph, self.store, state,
                               self.resolve_params(params), n_hops,
                               dynamic_deadline=dynamic_deadline)

    def finalize_frontier(self, state: FrontierState, params: SearchParams):
        return frontier_finalize(self.graph, self.store, state,
                                 self.resolve_params(params))

    def execute(self, plan: SearchPlan) -> SearchResult:
        excl = None if plan.notes is None else plan.notes.get("excl")
        sstats = None
        if self.storage is None:
            d, ids, stats = search_batch(self.graph, self.store,
                                         plan.queries, plan.bitmaps,
                                         plan.params, excl=excl)
        else:
            if plan.params.graph_exec_mode != "frontier":
                raise ValueError("storage accounting needs the frontier "
                                 "engine (graph_exec_mode='frontier')")
            d, ids, stats, trace = search_batch(
                self.graph, self.store, plan.queries, plan.bitmaps,
                plan.params, excl=excl, collect_trace=True)
            sstats = self.storage.account_graph(
                trace["heap_steps"], trace["index_steps"],
                rerank_rows=trace.get("rerank_rows"),
                quant=self.graph_quant == "sq8")
        return SearchResult(dists=d, ids=ids, stats=stats,
                            strategy=self.strategy, plan=plan,
                            storage=sstats,
                            anytime=costmodel.evaluate_anytime(
                                stats, plan.params, self.store.dim, ids,
                                hop_cap=plan.params.max_hops))


def _scatter_storage_stats(stats, qsel: np.ndarray, q: int):
    """A query subset's StorageStats widened to the whole batch: per-query
    arrays scatter to their slots (zeros / False elsewhere), so
    `merge_storage_stats` can sum same-shaped parts."""
    def scatter(arr, fill):
        full = np.full(q, fill, np.asarray(arr).dtype)
        full[qsel] = np.asarray(arr)
        return full

    return dataclasses.replace(
        stats, index_pages=scatter(stats.index_pages, 0),
        heap_pages=scatter(stats.heap_pages, 0),
        faulted=(None if stats.faulted is None
                 else scatter(stats.faulted, False)))


def _allpass_bitmap(n: int, device) -> torch.Tensor:
    """(W,) int32 bitmap passing exactly rows [0, n)."""
    return pack_bool_bitmap(torch.ones(n, dtype=torch.bool, device=device))


def _first_of_each_distinct(bitmaps: torch.Tensor,
                            match: torch.Tensor) -> torch.Tensor:
    """Index of the first query of each distinct bitmap row.  A matched
    query carries its family's bitmap word for word, so the matched rows'
    distinct bitmaps are their distinct matches, and no unmatched row
    equals one of them; only the unmatched rows need a row-wise unique (a
    lexicographic sort of their words, which over a whole 1M-row batch is
    the largest device item of a partitioned search)."""
    q = bitmaps.shape[0]
    qidx = torch.arange(q, device=bitmaps.device)

    def firsts(inv: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        n_keys = int(inv.max()) + 1 if inv.numel() else 0
        first = torch.full((n_keys,), q, dtype=torch.int64,
                           device=bitmaps.device)
        first = first.scatter_reduce(0, inv, rows, reduce="amin")
        return first[first < q]

    matched = match >= 0
    out = firsts(match[matched].to(torch.int64), qidx[matched])
    unmatched = qidx[~matched]
    if unmatched.numel():
        _, inv = torch.unique(bitmaps[unmatched], dim=0, return_inverse=True)
        out = torch.cat([out, firsts(inv, unmatched)])
    return out


class PartitionedGraphExecutor(BaseExecutor):
    """JAG-style attribute-partitioned graphs behind the executor API.

    A query whose bitmap equals a registered family bitmap word for word
    runs UNFILTERED on that family's subgraph: the partition is the filter,
    so its only filter work is the plan-time family match (F·W word
    comparisons per distinct bitmap, charged to its first query).  Other
    queries fall back to the wrapped base executor on the full graph; a
    store grown past `built_n` demotes the whole batch to the fallback.
    Local ids map back to global ids on the device.

    With a `storage` engine, matched queries' subgraph traces are scattered
    to global row ids and replayed through the base heap and adjacency
    layouts: exact for heap pages, conservative for index pages (a
    family's adjacency packs denser than the base layout)."""

    def __init__(self, partitions: PartitionedGraph, store: VectorStore,
                 base: Optional[Executor] = None,
                 graph_quant: str = "none",
                 storage: Optional[StorageEngine] = None):
        if graph_quant not in ("none", "sq8"):
            raise ValueError(f"unknown graph_quant {graph_quant!r}")
        if not partitions.partitions:
            raise ValueError("PartitionedGraph holds no partitions")
        if graph_quant == "sq8" and any(
                not p.store.has_sq8 for p in partitions.partitions):
            raise ValueError("graph_quant='sq8' needs partitions built from "
                             "a quantize_store'd VectorStore (SQ8 shadow "
                             "missing in a partition)")
        if storage is not None and storage.graph is None:
            raise ValueError("storage engine lacks a graph adjacency "
                             "layout; build it with graph=")
        self.partitions = partitions
        self.store = store
        self.base = base
        self.graph_quant = graph_quant
        self.storage = storage
        self.strategy = "partitioned"
        self.name = "partitioned" if graph_quant == "none" \
            else f"partitioned_{graph_quant}"

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        stale = self.partitions.built_n != self.store.n
        match = torch.full((queries.shape[0],), -1, dtype=torch.int32,
                           device=queries.device) if stale \
            else self.partitions.match(bitmaps)
        sub = dataclasses.replace(params, strategy="unfiltered",
                                  graph_quant=self.graph_quant,
                                  exclusion="none")
        return SearchPlan("partitioned", sub, queries, bitmaps,
                          notes={"match": match, "caller_params": params})

    def execute(self, plan: SearchPlan) -> SearchResult:
        match = plan.notes["match"]
        q, k = int(plan.queries.shape[0]), plan.params.k
        dev = plan.queries.device
        unmatched = torch.nonzero(match < 0).flatten()
        if unmatched.numel() and self.base is None:
            raise ValueError(
                f"{unmatched.numel()} queries match no partition family and "
                "no base executor is attached for fallback")
        dists = torch.full((q, k), float("inf"), device=dev)
        ids = torch.full((q, k), -1, dtype=torch.int32, device=dev)
        counters = {f.name: torch.zeros(q, dtype=torch.int32, device=dev)
                    for f in dataclasses.fields(SearchStats)}
        sparts = []
        tracing = self.storage is not None
        for f_idx in torch.unique(match[match >= 0]).tolist():
            part = self.partitions.partitions[f_idx]
            qsel = torch.nonzero(match == f_idx).flatten()
            bm = _allpass_bitmap(part.store.n, dev).expand(
                qsel.numel(), -1).contiguous()
            out = search_batch(part.graph, part.store, plan.queries[qsel],
                               bm, plan.params, collect_trace=tracing)
            d, lids, stats = out[:3]
            if tracing:
                qsel_np = qsel.cpu().numpy()
                sparts.append(_scatter_storage_stats(
                    self._account_partition(out[3], part.rows), qsel_np, q))
            dists[qsel] = d
            ids[qsel] = torch.where(
                lids >= 0, part.rows[lids.clamp(min=0).long()].to(
                    torch.int32), torch.full_like(lids, -1))
            for name in counters:
                counters[name][qsel] = getattr(stats, name)
        if unmatched.numel():
            fres = self.base.search(plan.queries[unmatched],
                                    plan.bitmaps[unmatched],
                                    plan.notes["caller_params"])
            dists[unmatched] = fres.dists[:, :k]
            ids[unmatched] = fres.ids[:, :k].to(torch.int32)
            for name in counters:
                counters[name][unmatched] = getattr(fres.stats, name)
            if fres.storage is not None:
                sparts.append(_scatter_storage_stats(
                    fres.storage, unmatched.cpu().numpy(), q))
        # the plan-time family match, charged once per distinct bitmap
        first = _first_of_each_distinct(plan.bitmaps, match)
        counters["filter_checks"][first] += (
            len(self.partitions.partitions) * int(plan.bitmaps.shape[1]))
        stats = SearchStats(**counters)
        return SearchResult(dists=dists, ids=ids, stats=stats,
                            strategy="partitioned", plan=plan,
                            storage=merge_storage_stats(sparts)
                            if sparts else None,
                            anytime=costmodel.evaluate_anytime(
                                stats, plan.params, self.store.dim, ids,
                                hop_cap=plan.params.max_hops))

    def _account_partition(self, trace, rows: torch.Tensor):
        """A subgraph trace's first-touch stamps (Qg, n_f) scattered to
        global row ids (Qg, n) and replayed through the base layout."""
        n = self.store.n
        hs, isteps = trace["heap_steps"], trace["index_steps"]
        cols = rows.to(hs.device, torch.int64)
        heap_g = torch.full((hs.shape[0], n), TRACE_UNTOUCHED,
                            dtype=torch.int32, device=hs.device)
        idx_g = torch.full_like(heap_g, TRACE_UNTOUCHED)
        heap_g[:, cols] = hs
        idx_g[:, cols] = isteps
        rr = trace.get("rerank_rows")
        if rr is not None:
            rr = torch.where(rr >= 0, cols[rr.clamp(min=0).to(torch.int64)],
                             torch.full_like(rr, -1, dtype=torch.int64))
        return self.storage.account_graph(heap_g, idx_g, rerank_rows=rr,
                                          quant=self.graph_quant == "sq8")


class ScannExecutor(BaseExecutor):
    """Filtered ScaNN (paper §2.3.7): pipeline="batched" is the
    query-batched union scan, "vmapped" the legacy per-query path (its
    equivalence oracle).  A `storage` engine needs the batched
    pipeline."""

    def __init__(self, index: ScannIndex, store: VectorStore,
                 pipeline: str = "batched",
                 storage: Optional[StorageEngine] = None):
        if pipeline not in ("batched", "vmapped"):
            raise ValueError(f"unknown scann pipeline {pipeline!r}")
        if storage is not None:
            if pipeline != "batched":
                raise ValueError("storage accounting needs the batched "
                                 "scann pipeline")
            if storage.scann is None:
                raise ValueError("storage engine lacks a scann leaf "
                                 "layout; build it with index=")
        self.index = index
        self.store = store
        self.pipeline = pipeline
        self.storage = storage
        self.name = "scann" if pipeline == "batched" else "scann_vmapped"

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
        sstats = None
        if self.storage is not None:
            d, ids, stats, trace = scann_search_batch(
                self.index, self.store, plan.queries, plan.bitmaps,
                plan.params, collect_trace=True)
            sstats = self.storage.account_scann(
                trace["leaves"], trace["cand_rows"], trace["cand_ok"],
                accounting=plan.params.scann_page_accounting,
                query_block=plan.params.scann_query_block)
        else:
            fn = scann_search_batch if self.pipeline == "batched" \
                else scann_search_batch_vmapped
            d, ids, stats = fn(self.index, self.store, plan.queries,
                               plan.bitmaps, plan.params)
        clamped = plan.notes is not None and "leaf_clamp" in plan.notes
        anytime = costmodel.evaluate_anytime(
            None, plan.params, self.store.dim, ids,
            extra_budget=np.full((ids.shape[0],), clamped, bool))
        return SearchResult(dists=d, ids=ids, stats=stats, strategy="scann",
                            plan=plan, storage=sstats, anytime=anytime)


class BruteForceExecutor(BaseExecutor):
    """Exact filtered KNN with seqscan counters: every row is
    filter-checked; passing rows are fetched from the heap and scored."""

    name = "bruteforce"

    def __init__(self, store: VectorStore,
                 storage: Optional[StorageEngine] = None):
        self.store = store
        self.storage = storage

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
            scan_bitmaps = plan.bitmaps
        else:
            d, ids, n_scored, probes, trunc = filtered_knn_partial(
                self.store, plan.queries, plan.bitmaps, plan.params.k,
                max_rows)
            stats = SearchStats(
                distance_comps=n_scored, filter_checks=probes, hops=z,
                page_accesses_index=z, page_accesses_heap=n_scored * ppv,
                tmap_lookups=z, reorder_rows=z)
            truncated = trunc.cpu().numpy()
            # the storage replay sees only the scanned prefix
            scan_bitmaps = _mask_bitmap_prefix(plan.bitmaps, probes)
        # the bitmap is the seqscan's trace: passing rows in row-id order
        sstats = None if self.storage is None \
            else self.storage.account_seqscan(scan_bitmaps)
        return SearchResult(dists=d, ids=ids.to(torch.int32), stats=stats,
                            strategy="bruteforce", plan=plan, storage=sstats,
                            anytime=costmodel.evaluate_anytime(
                                None, plan.params, self.store.dim, ids,
                                extra_budget=truncated))


class DeltaExecutor(BaseExecutor):
    """Exact scan over the mutable delta tier (`storage.delta.DeltaTier`):
    the unindexed tail every base strategy's top-k merges with
    (`core.mutable.MutableIndex`, `types.merge_topk`).

    Seqscan counters scaled to the tier: every live delta row is filter
    checked (its bit probed at its global id, so a tombstone-composed
    bitmap applies unchanged), the passing ones are fetched and scored
    (`costmodel.delta_scan_counters`).  The distances are
    `workload.exact_distances`, the arithmetic of `filtered_knn`, so the
    merge is bit-equal to one exact scan over base and delta.  With a
    `storage` engine (built with delta_capacity=) each query's scan
    replays through the pool's "delta" segment."""

    name = "delta"

    def __init__(self, tier, metric: str,
                 storage: Optional[StorageEngine] = None):
        self.tier = tier
        self.metric = metric
        self.storage = storage

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        if params.strategy != "delta":
            params = dataclasses.replace(params, strategy="delta")
        # snapshot the mutable tier at plan time: a copy of its live rows,
        # so a mutation or a compaction landing mid-request cannot leak in
        count = int(self.tier.count)
        rows = self.tier.device_vectors
        if rows is None or rows.device != queries.device:
            rows = torch.as_tensor(self.tier.vectors[:count],
                                   device=queries.device)
        notes = {"count": count, "base_n": int(self.tier.base_n),
                 "vectors": rows[:count].clone()}
        return SearchPlan("delta", params, queries, bitmaps, notes=notes)

    def execute(self, plan: SearchPlan) -> SearchResult:
        notes = plan.notes
        vecs, count, base_n = notes["vectors"], notes["count"], \
            notes["base_n"]
        k = plan.params.k
        q = plan.queries.shape[0]
        dev = plan.queries.device
        nsq = (vecs * vecs).sum(-1)           # VectorStore.build's norms
        gids = base_n + torch.arange(count, device=dev)
        ds, ids, npass = [], [], []
        for s in range(0, q, QUERY_CHUNK):
            qs = plan.queries[s:s + QUERY_CHUNK]
            d = exact_distances(vecs, nsq, self.metric, qs)
            passing = probe_batch(plan.bitmaps[s:s + QUERY_CHUNK],
                                  gids.expand(qs.shape[0], count))
            d = torch.where(passing, d, torch.full_like(d, float("inf")))
            dk, idx = topk_smallest(d, min(k, count))
            ds.append(dk)
            ids.append(torch.where(torch.isinf(dk), torch.full_like(idx, -1),
                                   idx + base_n))
            npass.append(passing.sum(1).to(torch.int32))
        d = torch.cat(ds)
        ids = torch.cat(ids).to(torch.int32)
        npass = torch.cat(npass)
        if k > count:                          # the tier holds fewer than k
            d = torch.nn.functional.pad(d, (0, k - count),
                                        value=float("inf"))
            ids = torch.nn.functional.pad(ids, (0, k - count), value=-1)
        z = torch.zeros((q,), dtype=torch.int32, device=dev)
        ppv = heap_pages_per_vector(vecs.shape[1])
        stats = SearchStats(
            distance_comps=npass, filter_checks=z + count, hops=z,
            page_accesses_index=z, page_accesses_heap=npass * ppv,
            tmap_lookups=z, reorder_rows=z)
        sstats = None if self.storage is None \
            else self.storage.account_delta_scan(count, q)
        return SearchResult(dists=d, ids=ids, stats=stats, strategy="delta",
                            plan=plan, storage=sstats,
                            anytime=costmodel.evaluate_anytime(
                                None, plan.params, vecs.shape[1], ids))


def _mask_bitmap_prefix(bitmaps: torch.Tensor,
                        probes: torch.Tensor) -> torch.Tensor:
    """Zero every bit at row id >= probes[q]: the part of a budgeted
    seqscan that was never reached."""
    words = bitmaps.shape[1]
    keep = (probes.to(torch.int64)[:, None]
            - torch.arange(words, device=bitmaps.device)[None, :] * 32
            ).clamp(0, 32)
    mask = (torch.bitwise_left_shift(torch.ones_like(keep), keep) - 1)
    return bitmaps & torch.where(mask >= 2 ** 31, mask - 2 ** 32,
                                 mask).to(torch.int32)


def index_shape(store: VectorStore, index: Optional[ScannIndex] = None,
                graph_m: int = 16) -> costmodel.IndexShape:
    """Static shape facts for the predictive cost model."""
    kw = dict(n=store.n, dim=store.dim, graph_m=graph_m)
    if index is not None:
        L, C, _ = index.leaf_tiles.shape
        if index.levels >= 2:
            B, Lb = index.branch_leaves.shape
            nb = max(1, -(-32 * 2 * B // L))
            cent = B + nb * Lb
        else:
            cent = L
        # average valid rows per leaf (the padded capacity over-counts)
        fill = max(1, round(store.n / L))
        kw.update(scann_leaves=L, scann_rows_per_leaf=min(fill, C),
                  scann_cent_scored=cent,
                  scann_pages_per_leaf=_quant_pages_per_leaf(index))
    return costmodel.IndexShape(**kw)


def _leaf_local_selectivity(index: ScannIndex, queries: torch.Tensor,
                            bitmaps: torch.Tensor,
                            probe_leaves: int) -> torch.Tensor:
    """Bitmap density inside each query's nearest `probe_leaves` ScaNN
    leaves, on the device: the correlation proxy's numerator.  (Q,) f32."""
    qp = project_query(index, queries)                        # (Q, dp)
    cents = index.leaf_centroids
    cn = (cents * cents).sum(-1)
    d = (qp * qp).sum(-1)[:, None] + cn[None, :] - 2.0 * (qp @ cents.T)
    _, leaves = topk_smallest(d, probe_leaves)                # (Q, P)
    rows = index.leaf_rowids[leaves].reshape(queries.shape[0], -1)
    ok = probe_batch(bitmaps, rows)
    valid = rows >= 0
    return (ok & valid).sum(-1).to(torch.float32) \
        / valid.sum(-1).clamp(min=1).to(torch.float32)


class AdaptivePlanner(BaseExecutor):
    """Per-batch system-aware strategy selection.

    plan():  s_q = popcount(bitmap_q) / n, γ = mean local leaf density /
             mean s (1.0 without a ScaNN candidate), pick = argmin over
             recall- and batch-feasible candidates of predict_cycles.
    execute(): the chosen executor's search, plus the planning overhead
    charged to the counters (n/32 filter-word reads per query, the proxy's
    centroid scan and leaf probes).

    With a `storage` engine the dispatch is warm-cache-aware: every plan
    reads the pool's per-segment residency and each candidate's predicted
    cycles include its expected miss penalty; the page-sharing fraction
    measured on the last full-precision graph batch replaces the
    calibration constant in the next predictions."""

    name = "adaptive"

    def __init__(self, candidates: Mapping[str, Executor],
                 store: VectorStore,
                 constants: costmodel.CostConstants = costmodel.SYSTEM,
                 graph_m: int = 16, probe_leaves: int = 4,
                 recall_margin: float = 2.0,
                 scann_recall_margin: float = 10.0,
                 storage: Optional[StorageEngine] = None):
        if not candidates:
            raise ValueError("AdaptivePlanner needs at least one candidate")
        for name, ex in candidates.items():
            kind = _strategy_kind(ex)
            if kind not in costmodel.PREDICTABLE_STRATEGIES:
                raise ValueError(
                    f"candidate {name!r} ({kind!r}) has no predictive "
                    f"model; supported: {costmodel.PREDICTABLE_STRATEGIES}")
        self.candidates = dict(candidates)
        self.store = store
        self.constants = constants
        self.graph_m = graph_m
        self.probe_leaves = probe_leaves
        self.recall_margin = recall_margin
        self.scann_recall_margin = scann_recall_margin
        self.storage = storage
        self._scann = next((ex for ex in self.candidates.values()
                            if isinstance(ex, ScannExecutor)), None)
        # the last full-precision graph batch's measured unique-page
        # fraction (StorageStats.unique_fraction), None until one ran
        self._measured_unique: Optional[float] = None
        # memoized (selectivity, γ) of the last batch: see
        # _selectivity_proxy
        self._proxy_key: Optional[tuple] = None
        self._proxy_val: Optional[tuple] = None

    def _shape(self) -> costmodel.IndexShape:
        return index_shape(
            self.store,
            self._scann.index if self._scann is not None else None,
            self.graph_m)

    def _recall_feasible(self, strategy: str, shape: costmodel.IndexShape,
                         params: SearchParams, s_eff: float) -> bool:
        """Guards against a strategy whose expected candidate pool cannot
        hold k passing rows; bruteforce is always feasible."""
        k = params.k * self.recall_margin
        if strategy == "scann":
            nl = min(params.num_leaves_to_search, shape.scann_leaves or 1)
            return s_eff * nl * (shape.scann_rows_per_leaf or 0) >= \
                params.k * self.scann_recall_margin
        if strategy in ("acorn", "navix"):
            return shape.n * s_eff * costmodel.FILTER_FIRST_POOL >= \
                max(params.ef_search, k)
        if strategy in ("sweeping", "iterative_scan", "sweeping_excl"):
            hops = min(max(params.ef_search, 2 * params.k) / max(s_eff, 1e-9),
                       float(params.max_hops))
            return costmodel.GRAPH_NEW_PER_HOP * hops * s_eff >= k
        return True

    def _batch_feasible(self, ex: Executor, bitmaps) -> bool:
        """The partitioned tier answers a batch only when every query's
        bitmap equals a registered family bitmap and the partitions are
        fresh; anything else would route through its fallback."""
        if isinstance(ex, PartitionedGraphExecutor):
            if ex.partitions.built_n != ex.store.n:
                return False
            return bool((ex.partitions.match(bitmaps) >= 0).all())
        return True

    def _selectivity_proxy(self, queries, bitmaps):
        """Memoized (per-query selectivity (Q,) float64, γ) of one batch.
        The reference keys the memo by a CRC of the batch's bytes; here the
        key is the two tensors' identity and version counters, so no
        device-to-host copy of the bitmaps is needed (the popcount and the
        leaf probe are the same either way, and the charged overhead lives
        in execute())."""
        key = (id(queries), queries._version, id(bitmaps), bitmaps._version)
        if self._proxy_key is not None and self._proxy_key[0] == key \
                and self._proxy_key[1]() is queries \
                and self._proxy_key[2]() is bitmaps:
            return self._proxy_val
        n = self.store.n
        sel = (bitmap_popcount(bitmaps).to(torch.float64) / n).cpu().numpy()
        gamma = 1.0
        if self._scann is not None:
            local = _leaf_local_selectivity(self._scann.index, queries,
                                            bitmaps, self.probe_leaves)
            gamma = float(np.clip(local.cpu().numpy().mean()
                                  / max(float(sel.mean()), 1.0 / n),
                                  0.05, 20.0))
        self._proxy_key = (key, weakref.ref(queries), weakref.ref(bitmaps))
        self._proxy_val = (sel, gamma)
        return sel, gamma

    def plan(self, queries, bitmaps, params: SearchParams) -> SearchPlan:
        n = self.store.n
        sel, gamma = self._selectivity_proxy(queries, bitmaps)
        s_mean = float(sel.mean())
        shape = self._shape()
        s_eff = min(max(s_mean * gamma, 1.0 / n), 1.0)
        batch_q = int(queries.shape[0])
        pool_state = self.storage.state() if self.storage is not None \
            else None
        # each candidate priced on the params it would resolve (strategy +
        # graph_quant), e.g. sweeping_sq8 on the quantized tier
        preds = {name: costmodel.predict_cycles(
            _strategy_kind(ex), shape, _candidate_params(ex, params),
            s_mean, gamma, self.constants, batch_q=batch_q,
            pool_state=pool_state,
            measured_unique_frac=self._measured_unique)
            for name, ex in self.candidates.items()}
        batch_ok = {name: self._batch_feasible(ex, bitmaps)
                    for name, ex in self.candidates.items()}
        feasible = {name: p for name, p in preds.items()
                    if self._recall_feasible(_strategy_kind(
                        self.candidates[name]), shape, params, s_eff)
                    and batch_ok[name]}
        # never empty: fall back to the argmin, keeping a batch-infeasible
        # candidate out even then
        pool = feasible or {nm: p for nm, p in preds.items()
                            if batch_ok[nm]} or preds
        chosen = min(pool, key=pool.get)
        inner = self.candidates[chosen].plan(queries, bitmaps, params)
        return SearchPlan(strategy=chosen, params=inner.params,
                          queries=queries, bitmaps=bitmaps,
                          est_selectivity=sel, correlation_proxy=gamma,
                          predicted_cycles=preds, notes=inner.notes)

    def execute(self, plan: SearchPlan) -> SearchResult:
        chosen = self.candidates[plan.strategy]
        res = chosen.execute(plan)
        if res.storage is not None and isinstance(chosen, GraphExecutor) \
                and chosen.graph_quant == "none":
            # only the f32 tier updates it: the calibration constant it
            # replaces was set on full-precision heap geometry
            self._measured_unique = res.storage.unique_fraction()
        if res.stats is not None:
            words = int(plan.bitmaps.shape[1])
            probe_fc = probe_dc = 0
            if self._scann is not None:
                idx = self._scann.index
                probe_fc = self.probe_leaves * idx.leaf_rowids.shape[1]
                probe_dc = idx.leaf_centroids.shape[0]
            st = res.stats
            stats = dataclasses.replace(
                st, filter_checks=st.filter_checks + words + probe_fc,
                distance_comps=st.distance_comps + probe_dc)
            res = dataclasses.replace(res, stats=stats, plan=plan)
        return res


def _strategy_kind(ex: Executor) -> str:
    """Predictive-model key of an executor (quant variants share their
    strategy's law; the exclusion and partitioned tiers have their own)."""
    if isinstance(ex, ScannExecutor):
        return "scann"
    if isinstance(ex, PartitionedGraphExecutor):
        return "partitioned"
    if isinstance(ex, GraphExecutor) and ex.exclusion is not None:
        return "sweeping_excl"
    return getattr(ex, "strategy", ex.name)


def _candidate_params(ex: Executor, params: SearchParams) -> SearchParams:
    """The params a candidate would resolve in plan(): what its prediction
    is priced on."""
    if isinstance(ex, PartitionedGraphExecutor):
        return dataclasses.replace(params, strategy="unfiltered",
                                   graph_quant=ex.graph_quant,
                                   exclusion="none")
    if isinstance(ex, GraphExecutor):
        return dataclasses.replace(
            params, strategy=ex.strategy, graph_quant=ex.graph_quant,
            exclusion="none" if ex.exclusion is None else "prune")
    return params


def _parse_graph_method(method: str) -> tuple[str, str]:
    """"sweeping_sq8" -> ("sweeping", "sq8"); plain names pass through."""
    if method.endswith("_sq8") and method[:-4] in GRAPH_STRATEGIES:
        return method[:-4], "sq8"
    return method, "none"


def make_executor(method: str, store: VectorStore, *,
                  graph: Optional[HNSWGraph] = None,
                  index: Optional[ScannIndex] = None,
                  constants: costmodel.CostConstants = costmodel.SYSTEM,
                  graph_m: int = 16,
                  exclusion: Optional[ExclusionIndex] = None,
                  partitions: Optional[PartitionedGraph] = None,
                  planner_candidates: tuple[str, ...] =
                  DEFAULT_PLANNER_CANDIDATES,
                  storage: Optional[StorageEngine] = None,
                  device="cuda") -> Executor:
    """Build the executor for `method` on `device` (the store must live
    there).  Graph strategies need `graph`; "<strategy>_sq8" runs the SQ8
    tier on the store's shadow (`quantize_store`: pass a quantized store
    to build several executors on one shadow); "scann" / "scann_vmapped"
    need `index`; "sweeping_excl[_sq8]" needs `graph` and `exclusion`
    (core.exclusion.build_exclusion); "partitioned[_sq8]" needs
    `partitions` (hnsw.build_graph_partitioned), with `graph` as the
    unmatched-query fallback; "adaptive" builds every candidate of
    `planner_candidates` the given components support.  `storage` attaches
    a paged storage engine (host-side, no device): results carry measured
    StorageStats, and for "adaptive" one pool backs every candidate (but
    "scann_vmapped") and feeds the planner's predictions."""
    check_store_device(store, device)

    def excl_executor(quant: str, st: VectorStore) -> GraphExecutor:
        if graph is None or exclusion is None:
            raise ValueError("'sweeping_excl' variants need graph= and "
                             "exclusion=")
        return GraphExecutor(graph, st, strategy="sweeping",
                             graph_quant=quant, exclusion=exclusion,
                             storage=storage)

    def part_executor(quant: str, st: VectorStore) -> Executor:
        if partitions is None:
            raise ValueError("'partitioned' variants need partitions=")
        fallback = None if graph is None else GraphExecutor(
            graph, st, strategy="sweeping", graph_quant=quant,
            storage=storage)
        return PartitionedGraphExecutor(partitions, st, base=fallback,
                                        graph_quant=quant, storage=storage)

    def quant_of(name: str) -> str:
        return "sq8" if name.endswith("_sq8") else "none"

    if method in EXCL_METHODS:
        quant = quant_of(method)
        return excl_executor(quant, quantize_store(store)
                             if quant == "sq8" else store)
    if method in PARTITIONED_METHODS:
        quant = quant_of(method)
        return part_executor(quant, quantize_store(store)
                             if quant == "sq8" else store)
    base, quant = _parse_graph_method(method)
    if base in GRAPH_STRATEGIES:
        if graph is None:
            raise ValueError(f"{method!r} needs graph=")
        return GraphExecutor(graph, quantize_store(store)
                             if quant == "sq8" else store, strategy=base,
                             graph_quant=quant, storage=storage)
    if method in ("scann", "scann_vmapped"):
        if index is None:
            raise ValueError(f"{method!r} needs index=")
        return ScannExecutor(index, store, pipeline="batched"
                             if method == "scann" else "vmapped",
                             storage=storage)
    if method == "bruteforce":
        return BruteForceExecutor(store, storage=storage)
    if method == "adaptive":
        if graph is not None and any(n.endswith("_sq8")
                                     for n in planner_candidates):
            store = quantize_store(store)
        cands: dict[str, Executor] = {}
        for name in planner_candidates:
            cbase, cquant = _parse_graph_method(name)
            if name == "bruteforce":
                cands[name] = BruteForceExecutor(store, storage=storage)
            elif name in EXCL_METHODS:
                if graph is not None and exclusion is not None:
                    cands[name] = excl_executor(quant_of(name), store)
            elif name in PARTITIONED_METHODS:
                if partitions is not None:
                    cands[name] = part_executor(quant_of(name), store)
            elif cbase in GRAPH_STRATEGIES and graph is not None:
                cands[name] = GraphExecutor(graph, store, strategy=cbase,
                                            graph_quant=cquant,
                                            storage=storage)
            elif name in ("scann", "scann_vmapped") and index is not None:
                # the legacy pipeline has no trace, so no storage
                cands[name] = ScannExecutor(
                    index, store, pipeline="batched" if name == "scann"
                    else "vmapped",
                    storage=storage if name == "scann" else None)
        return AdaptivePlanner(cands, store, constants=constants,
                               graph_m=graph_m, storage=storage)
    raise ValueError(
        f"unknown method {method!r}; registered: {REGISTERED_METHODS}")
