"""System-tax cost model (paper §3.4, §6.2, Fig. 10).

Two modes share one set of per-operation constants:

  post-hoc     — `cycle_breakdown` translates MEASURED SearchStats counters
                 into modeled CPU cycles of a PostgreSQL-like page engine
                 (SYSTEM) or a flat-memory library (LIBRARY);
  predictive   — `predict_counters` / `predict_cycles` give closed-form
                 EXPECTED counters per strategy from the index shape, a
                 selectivity estimate and a correlation proxy, before
                 anything runs; the adaptive planner dispatches to the
                 argmin.

The constants, laws and formulas are the reference's, copied verbatim.
Pure Python and numpy on host values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.types import (AnytimeInfo, SearchParams, SearchStats,
                                    heap_pages_per_vector,
                                    quant_heap_pages_per_vector)


@dataclasses.dataclass(frozen=True)
class CostConstants:
    page_access: float          # buffer HIT: pin + lock + read + release
    tuple_materialize: float    # palloc + copy, per byte
    distance_per_dim: float     # SIMD distance cycles per dimension
    filter_check: float         # bitmap probe
    tmap_lookup: float          # in-memory hash probe
    reorder_sort_per_row: float  # reordering sort/merge work
    page_miss_extra: float = 1.0
    collective_per_byte: float = 0.5


SYSTEM = CostConstants(
    page_access=2400.0,
    tuple_materialize=0.25,
    distance_per_dim=2.0,
    filter_check=18.0,
    tmap_lookup=40.0,
    reorder_sort_per_row=60.0,
    page_miss_extra=10.0,
)

LIBRARY = CostConstants(
    page_access=12.0,
    tuple_materialize=0.0,
    distance_per_dim=0.5,
    filter_check=15.0,
    tmap_lookup=0.0,
    reorder_sort_per_row=30.0,
    page_miss_extra=1.0,
)

GRAPH_STRATEGIES = ("unfiltered", "sweeping", "acorn", "navix",
                    "iterative_scan")

# Frontier-engine page-cost amortization: the batch-synchronous engine
# fetches each superstep's candidate union once for the whole batch, so the
# effective per-page cost of a batch lands at about half the per-query
# engine's.  A single query amortizes nothing.
FRONTIER_PAGE_AMORT = 0.5
# The unique-fetch fraction FRONTIER_PAGE_AMORT was calibrated against.
FRONTIER_CALIB_UNIQUE = 0.88


def engine_scale(strategy: str, params: SearchParams,
                 batch_q: int = 1,
                 measured_unique_frac: Optional[float] = None
                 ) -> Optional[dict[str, float]]:
    """Per-component cycle multipliers for the execution engine that will
    run `strategy` (None = per-query costs); `measured_unique_frac`
    replaces the FRONTIER_PAGE_AMORT constant with a measured
    amortization, anchored at FRONTIER_CALIB_UNIQUE."""
    if strategy not in GRAPH_STRATEGIES or batch_q <= 1:
        return None
    if params.graph_exec_mode != "frontier":
        return None
    amort = FRONTIER_PAGE_AMORT
    if measured_unique_frac is not None:
        amort = min(1.0, max(
            0.05, FRONTIER_PAGE_AMORT * measured_unique_frac
            / FRONTIER_CALIB_UNIQUE))
    return {"index_page_access": amort, "vector_retrieval": amort}


def component_cycles(counters: Mapping[str, float], dim: int,
                     constants: CostConstants = SYSTEM,
                     scale: Optional[Mapping[str, float]] = None,
                     graph_quant: str = "none") -> dict[str, float]:
    """Per-component modeled cycles for one query from a counter mapping
    (the Table 6 column names).  `scale` multiplies named components;
    `graph_quant="sq8"` materializes traversal rows at 1 byte/dim."""
    vec_bytes = dim * 4
    if graph_quant == "sq8":
        rr = counters["reorder_rows"]
        trav_dc = max(counters["distance_comps"] - rr, 0.0)
        materialize = (trav_dc * dim + rr * vec_bytes) \
            * constants.tuple_materialize
    else:
        materialize = counters["distance_comps"] * vec_bytes \
            * constants.tuple_materialize
    comp = {
        "index_page_access": counters["page_accesses_index"]
        * constants.page_access,
        "vector_retrieval": counters["page_accesses_heap"]
        * constants.page_access + materialize,
        "distance_compute": counters["distance_comps"] * dim
        * constants.distance_per_dim,
        "filter_checks": counters["filter_checks"] * constants.filter_check,
        "translation_map": counters["tmap_lookups"] * constants.tmap_lookup,
        "reordering": counters["reorder_rows"]
        * constants.reorder_sort_per_row,
    }
    if scale:
        for k, f in scale.items():
            comp[k] *= f
    comp["total"] = sum(comp.values())
    return comp


def index_segment(strategy: str) -> Optional[str]:
    """The page segment that holds a strategy's index pages; every
    strategy's row fetches hit the "heap" segment."""
    if strategy == "scann":
        return "scann"
    if strategy in GRAPH_STRATEGIES:
        return "graph"
    return None                     # bruteforce: seqscan, no index


def cache_miss_penalty(counters: Mapping[str, float], strategy: str,
                       pool_state, constants: CostConstants = SYSTEM,
                       graph_quant: str = "none",
                       dim: Optional[int] = None) -> float:
    """Expected extra cycles from buffer-pool misses, per query, given a
    pool state with `miss_fraction(segment)`: the `BufferPoolState`
    snapshot that `storage/bufferpool.py`'s pool returns from `state()`
    (the planner reads it from a storage engine's `state()`).  With no pool
    state (a search without storage) or page_miss_extra == 1 it is 0 and
    predictions reduce to the classic ones."""
    if pool_state is None or constants.page_miss_extra <= 1.0:
        return 0.0
    extra = constants.page_access * (constants.page_miss_extra - 1.0)
    if graph_quant == "sq8" and dim is not None:
        rr_pages = counters["reorder_rows"] * heap_pages_per_vector(dim)
        trav_pages = max(counters["page_accesses_heap"] - rr_pages, 0.0)
        pen = trav_pages * pool_state.miss_fraction("qheap") * extra \
            + rr_pages * pool_state.miss_fraction("heap") * extra
    else:
        pen = counters["page_accesses_heap"] * \
            pool_state.miss_fraction("heap") * extra
    seg = index_segment(strategy)
    if seg is not None:
        pen += counters["page_accesses_index"] * \
            pool_state.miss_fraction(seg) * extra
    return pen


def beam_exchange_bytes(counters: Mapping[str, float], params: SearchParams,
                        num_shards: int) -> float:
    """Per-query collective bytes of the sharded frontier engine: lockstep
    (E = 1) all-reduces 8 B per scored candidate, drift (E > 1) gathers the
    other shards' beams every E supersteps."""
    S = int(num_shards)
    if S <= 1:
        return 0.0
    E = max(1, int(params.beam_exchange_interval))
    if E == 1:
        return 8.0 * counters["distance_comps"] * 2.0 * (S - 1) / S
    exchanges = -(-counters["hops"] // E)
    return 8.0 * params.ef_search * exchanges * (S - 1)


def cycle_breakdown(stats: SearchStats, dim: int,
                    constants: CostConstants = SYSTEM,
                    scale: Optional[Mapping[str, float]] = None,
                    graph_quant: str = "none") -> dict[str, float]:
    """Per-component modeled cycles for one query (Fig. 10 bars); a batch
    of counters is averaged over its queries first."""
    s = {k: float(np.asarray(v, np.float64).mean())
         for k, v in stats.as_dict().items()}
    return component_cycles(s, dim, constants, scale, graph_quant)


def measured_miss_penalty(storage_stats, batch_q: int,
                          constants: CostConstants = SYSTEM) -> float:
    """Per-query extra cycles of the MEASURED pool misses of one executor
    call (a `storage.StorageStats`): the post-hoc currency of
    `cache_miss_penalty`'s predictions."""
    extra = constants.page_access * (constants.page_miss_extra - 1.0)
    return storage_stats.miss_total * extra / max(batch_q, 1)


def modeled_qps(stats: SearchStats, dim: int,
                constants: CostConstants = SYSTEM,
                clock_hz: float = 3.0e9, threads: int = 16,
                thread_overhead: Mapping[int, float] | None = None) -> float:
    """Modeled queries per second at a given concurrency: `threads` over
    the modeled seconds of one query, whose cycles `thread_overhead`
    inflates for contention (the paper's Table 7; default +50 % at any
    concurrency above one)."""
    cycles = cycle_breakdown(stats, dim, constants)["total"]
    amp = 1.0
    if threads > 1:
        amp = (thread_overhead or {16: 1.5}).get(threads, 1.5)
    return threads / (cycles * amp / clock_hz)


def stats_table_row(stats: SearchStats) -> dict[str, float]:
    """Mean counters over a query batch — one row of the paper's Table 6."""
    return {k: float(np.asarray(v, np.float64).mean())
            for k, v in stats.as_dict().items()}


# ---------------------------------------------------------------------------
# Predictive mode: closed-form EXPECTED Table-6 counters per strategy from
# the index shape, a per-batch selectivity estimate s (popcount / n) and a
# correlation proxy γ (local / global selectivity; > 1 = positively
# correlated).  Traversal sees the effective selectivity s̃ = clip(s·γ, 1/n,
# 1).  The laws and their calibration are the reference's.
# ---------------------------------------------------------------------------

GRAPH_NEW_PER_HOP = 2.5     # newly scored rows per hop (visited overlap)
SWEEP_FC_PER_DC = 0.6       # would-enter-W checks per scored row
NAVIX_EXPAND_FRAC = 0.5     # adaptive-heuristic 2-hop gating vs ACORN's 1.0
FILTER_FIRST_HOPS = 1.06    # hops ≈ FILTER_FIRST_HOPS · ef when connected
FILTER_FIRST_POOL = 0.7     # subgraph-exhaustion cap: hops ≤ 0.7·n·s̃
ITER_HOP_FACTOR = 1.6       # iterative-scan hops per emitted candidate
ITER_HOP_BASE = 40.0        # beam settle-down tail per scan round-trip

# Selectivity-aware tiers: exclusion-pruned sweeping scales sweeping's hop
# count by an expected keep fraction that bites only for clustered
# predicates (γ > 1); at γ ≤ 1 it prices exactly like sweeping.
EXCL_PRUNE_MAX = 0.4        # asymptotic pruned hop fraction (γ → ∞)
# The partitioned tier's plan-time family match, priced for a nominal
# catalog of families.
PART_FAMILIES_EST = 4.0     # families assumed registered, for match fc
# One-off subgraph build work amortized per query over the horizon a hot
# predicate family serves before its partition goes stale.
PART_BUILD_DC_PER_ROW = 64.0
PART_AMORT_QUERIES = 50_000.0

PREDICTABLE_STRATEGIES = ("bruteforce", "scann", "sweeping", "acorn",
                          "navix", "iterative_scan", "unfiltered",
                          "sweeping_excl", "partitioned")

# Predictive kind -> the graph strategy whose machinery it runs: the
# exclusion tier runs sweeping, the partitioned tier runs unfiltered on a
# subgraph.
GRAPH_KIND_ALIAS = {"sweeping_excl": "sweeping", "partitioned": "unfiltered"}


@dataclasses.dataclass(frozen=True)
class IndexShape:
    """Static shape facts the predictive model needs."""

    n: int
    dim: int
    graph_m: int = 16                    # HNSW M; level-0 degree = 2M
    scann_leaves: Optional[int] = None   # L
    scann_rows_per_leaf: Optional[int] = None    # C (capacity, padded)
    scann_cent_scored: Optional[int] = None      # centroids scored
    scann_pages_per_leaf: int = 1


def predict_counters(strategy: str, shape: IndexShape, params: SearchParams,
                     selectivity: float, correlation: float = 1.0,
                     batch_q: int = 1) -> dict[str, float]:
    """Expected per-query Table-6 counters for `strategy`.  `batch_q`
    matters for scann under "batch" page accounting: each opened leaf is
    paid once per batch, E[unique leaves] = L·(1−(1−nl/L)^Q)."""
    n, k = shape.n, params.k
    ppv = heap_pages_per_vector(shape.dim)
    s = min(max(selectivity, 1.0 / n), 1.0)
    s_eff = min(max(s * max(correlation, 1e-3), 1.0 / n), 1.0)
    c = dict(distance_comps=0.0, filter_checks=0.0, hops=0.0,
             page_accesses_index=0.0, page_accesses_heap=0.0,
             tmap_lookups=0.0, reorder_rows=0.0)

    if strategy == "bruteforce":
        c["filter_checks"] = float(n)
        c["distance_comps"] = s * n
        c["page_accesses_heap"] = s * n * ppv
        return c

    if strategy == "scann":
        if shape.scann_leaves is None or shape.scann_rows_per_leaf is None:
            raise ValueError("scann prediction needs scann_* shape facts")
        nl = min(params.num_leaves_to_search, shape.scann_leaves)
        rows = nl * shape.scann_rows_per_leaf
        r = min(k * params.reorder_factor, rows)
        cent = shape.scann_cent_scored or shape.scann_leaves
        c["filter_checks"] = float(rows)
        c["distance_comps"] = s_eff * rows + cent + r
        c["hops"] = float(nl)
        leaves_per_q = float(nl)
        if params.scann_page_accounting == "batch" and batch_q > 1:
            lf = float(shape.scann_leaves)
            uniq = lf * (1.0 - (1.0 - nl / lf) ** batch_q)
            leaves_per_q = min(uniq / batch_q, float(nl))
        c["page_accesses_index"] = leaves_per_q * shape.scann_pages_per_leaf
        c["page_accesses_heap"] = float(r * ppv)
        c["reorder_rows"] = float(r)
        return c

    deg = 2.0 * shape.graph_m
    ef = max(params.ef_search, 2 * k)
    tm = 1.0 if params.translation_map else 0.0

    def graph_quant_rerank(c: dict, r: float) -> dict:
        """SQ8 tier: traversal rows fetch shadow pages, and the exact
        rerank of ~r beam entries adds r distance comps and r full-width
        heap pages, counted in reorder_rows."""
        if params.graph_quant != "sq8":
            return c
        qppv = quant_heap_pages_per_vector(shape.dim)
        trav_rows = c["page_accesses_heap"] / ppv
        c["page_accesses_heap"] = trav_rows * qppv + r * ppv
        c["distance_comps"] += r
        c["reorder_rows"] = r
        return c

    if strategy in ("sweeping", "unfiltered"):
        s_nav = 1.0 if strategy == "unfiltered" else s_eff
        hops = min(ef / s_nav, float(params.max_hops), n / GRAPH_NEW_PER_HOP)
        dc = min(GRAPH_NEW_PER_HOP * hops + ef, float(n))
        fc = 0.0 if strategy == "unfiltered" else SWEEP_FC_PER_DC * dc
        c.update(distance_comps=dc, filter_checks=fc, hops=hops,
                 page_accesses_index=hops + (1 - tm) * fc,
                 page_accesses_heap=dc * ppv, tmap_lookups=tm * fc)
        return graph_quant_rerank(c, float(ef))

    if strategy == "sweeping_excl":
        corr_gain = max(0.0, 1.0 - 1.0 / max(correlation, 1.0))
        prune = EXCL_PRUNE_MAX * corr_gain * (1.0 - s)
        hops = min(ef / s_eff, float(params.max_hops),
                   n / GRAPH_NEW_PER_HOP) * (1.0 - prune)
        dc = min(GRAPH_NEW_PER_HOP * hops + ef, float(n))
        fc = SWEEP_FC_PER_DC * dc * (1.0 - prune)
        c.update(distance_comps=dc, filter_checks=fc, hops=hops,
                 page_accesses_index=hops + (1 - tm) * fc,
                 page_accesses_heap=dc * ppv, tmap_lookups=tm * fc)
        return graph_quant_rerank(c, float(ef))

    if strategy == "partitioned":
        n_f = max(s * n, float(k))
        hops = min(float(ef), float(params.max_hops),
                   n_f / GRAPH_NEW_PER_HOP)
        dc = min(GRAPH_NEW_PER_HOP * hops + ef, n_f)
        fc = PART_FAMILIES_EST * math.ceil(n / 32)
        c.update(distance_comps=dc, filter_checks=fc, hops=hops,
                 page_accesses_index=hops,
                 page_accesses_heap=dc * ppv)
        return graph_quant_rerank(c, float(ef))

    if strategy == "iterative_scan":
        bt = params.batch_tuples
        emitted = float(min(bt * np.ceil((k / s_eff) / bt),
                            bt * params.max_rounds))
        hops = min(ITER_HOP_FACTOR * emitted + ITER_HOP_BASE,
                   float(params.max_hops), n / GRAPH_NEW_PER_HOP)
        dc = min(GRAPH_NEW_PER_HOP * hops, float(n))
        c.update(distance_comps=dc, filter_checks=emitted, hops=hops,
                 page_accesses_index=hops + (1 - tm) * emitted,
                 page_accesses_heap=dc * ppv, tmap_lookups=tm * emitted)
        return graph_quant_rerank(
            c, float(min(k * params.reorder_factor, emitted)))

    if strategy in ("acorn", "navix"):
        gate = 1.0 if strategy == "acorn" else NAVIX_EXPAND_FRAC
        if strategy == "navix" and s_eff > 0.35:
            gate = 0.05                      # adaptive-local: onehop zone
        hops = min(FILTER_FIRST_HOPS * ef, FILTER_FIRST_POOL * n * s_eff)
        hops = max(hops, 1.0)
        expand = deg * (1.0 - s_eff) * gate  # branches expanded per hop
        fc = hops * (deg + expand * deg)
        dc = min(hops * GRAPH_NEW_PER_HOP * (1.0 + gate), float(n))
        c.update(distance_comps=dc, filter_checks=fc, hops=hops,
                 page_accesses_index=hops * (1.0 + expand) + (1 - tm) * fc,
                 page_accesses_heap=dc * ppv, tmap_lookups=tm * fc)
        return graph_quant_rerank(c, float(ef))

    raise ValueError(f"no predictive model for strategy {strategy!r}")


def predict_cycles(strategy: str, shape: IndexShape, params: SearchParams,
                   selectivity: float, correlation: float = 1.0,
                   constants: CostConstants = SYSTEM,
                   batch_q: int = 1, pool_state=None,
                   measured_unique_frac: Optional[float] = None,
                   num_shards: int = 1) -> float:
    """Expected per-query modeled cycles (the planner's ranking metric),
    priced on the engine that will run the strategy (`engine_scale`), its
    quantization tier, the pool's expected misses when a pool state is
    given, the partitioned tier's amortized build and the sharded
    engine's collective volume."""
    counters = predict_counters(strategy, shape, params, selectivity,
                                correlation, batch_q)
    gstrat = GRAPH_KIND_ALIAS.get(strategy, strategy)
    gq = params.graph_quant if gstrat in GRAPH_STRATEGIES else "none"
    base = component_cycles(
        counters, shape.dim, constants,
        engine_scale(gstrat, params, batch_q, measured_unique_frac),
        graph_quant=gq)["total"]
    total = base + cache_miss_penalty(counters, gstrat, pool_state,
                                      constants, graph_quant=gq,
                                      dim=shape.dim)
    if strategy == "partitioned":
        n_f = max(selectivity * shape.n, float(params.k))
        total += n_f * PART_BUILD_DC_PER_ROW * shape.dim \
            * constants.distance_per_dim / PART_AMORT_QUERIES
    if num_shards > 1 and gstrat in GRAPH_STRATEGIES:
        total = total / num_shards \
            + beam_exchange_bytes(counters, params, num_shards) \
            * constants.collective_per_byte
    return total


def budget_cycle_weights(dim: int, constants: CostConstants = SYSTEM
                         ) -> dict[str, float]:
    """Per-counter cycle weights of the linear cost form: cycles =
    Σ counter · weight (component_cycles with no scale, graph_quant none)."""
    return {
        "distance_comps": dim * constants.distance_per_dim
        + dim * 4 * constants.tuple_materialize,
        "filter_checks": constants.filter_check,
        "hops": 0.0,
        "page_accesses_index": constants.page_access,
        "page_accesses_heap": constants.page_access,
        "tmap_lookups": constants.tmap_lookup,
        "reorder_rows": constants.reorder_sort_per_row,
    }


def linear_cycles(stats: SearchStats, dim: int,
                  constants: CostConstants = SYSTEM) -> np.ndarray:
    """Per-query modeled cycles under the linear budget form, in float32 and
    in the same term order as the in-loop deadline predicate."""
    w = budget_cycle_weights(dim, constants)
    d = stats.as_dict()
    out = None
    for name, weight in w.items():
        term = np.asarray(d[name], np.float32) * np.float32(weight)
        out = term if out is None else out + term
    return np.atleast_1d(out)


def evaluate_anytime(stats: Optional[SearchStats], params: SearchParams,
                     dim: int, ids, constants: CostConstants = SYSTEM,
                     hop_cap: Optional[int] = None,
                     extra_truncated: Optional[np.ndarray] = None,
                     extra_budget: Optional[np.ndarray] = None
                     ) -> AnytimeInfo:
    """Per-query AnytimeInfo flags from final counters (host side).

    hop_cap: the graph engines' safety cap (params.max_hops), None for
    executors whose `hops` is not a traversal length.  extra_truncated /
    extra_budget: executor-supplied masks the counters cannot show."""
    ids = ids.detach().cpu().numpy() if hasattr(ids, "detach") \
        else np.asarray(ids)
    completion = np.atleast_1d(np.mean(ids >= 0, axis=-1, dtype=np.float32))
    q = completion.shape[0]
    budget = np.zeros(q, bool)
    truncated = np.zeros(q, bool)
    if stats is not None:
        d = stats.as_dict()
        hops = np.atleast_1d(np.asarray(d["hops"], np.int64))
        pages = np.atleast_1d(np.asarray(d["page_accesses_index"], np.int64)
                              + np.asarray(d["page_accesses_heap"],
                                           np.int64))
        if params.page_budget > 0:
            budget |= pages >= params.page_budget
        if params.hop_budget > 0:
            budget |= hops >= params.hop_budget
        if params.deadline_cycles > 0:
            budget |= linear_cycles(stats, dim, constants) \
                >= params.deadline_cycles
        if hop_cap is not None:
            truncated |= hops >= hop_cap
    if extra_budget is not None:
        budget |= np.atleast_1d(np.asarray(extra_budget, bool))
    truncated |= budget
    if extra_truncated is not None:
        truncated |= np.atleast_1d(np.asarray(extra_truncated, bool))
    return AnytimeInfo(truncated=truncated, budget_exhausted=budget,
                       completion=completion)


def queueing_delay_cycles(offered_per_cycle: float, service_cycles: float,
                          servers: int) -> float:
    """Expected queueing wait (modeled cycles) at an open-loop arrival
    rate of `offered_per_cycle` requests a cycle against `servers` slots
    each taking `service_cycles` a request.

    Sakasegawa's M/M/c approximation, Lq ~ rho^sqrt(2(c+1)) / (1 - rho)
    with rho = lambda S / c and Wq = Lq / lambda, halved toward M/D/c
    since slot service times cluster within a deadline bucket.  0.0 when
    idle (lambda = 0), +inf at or past saturation (rho >= 1)."""
    if offered_per_cycle <= 0.0 or service_cycles <= 0.0:
        return 0.0
    c = max(int(servers), 1)
    rho = offered_per_cycle * service_cycles / c
    if rho >= 1.0:
        return float("inf")
    lq = rho ** math.sqrt(2.0 * (c + 1)) / (1.0 - rho)
    return 0.5 * lq / offered_per_cycle


def queue_aware_floor(floor: float, queued: int, servers: int,
                      service_cycles: float) -> float:
    """The deadline admission floor inflated by the wait already visible in
    the arrival queue: `queued` requests ahead drain at about `servers`
    per `service_cycles`.  The plain floor when the queue is empty."""
    if queued <= 0 or service_cycles <= 0.0:
        return floor
    return floor + (queued / max(int(servers), 1)) * service_cycles


def fault_penalty(storage_stats, batch_q: int,
                  constants: CostConstants = SYSTEM) -> float:
    """Per-query extra cycles from injected storage faults (a StorageStats
    with fault counters): every retry re-pays a miss-grade read and every
    latency spike pays the same surcharge on the access it slowed, as
    `measured_miss_penalty` prices a miss."""
    extra = constants.page_access * (constants.page_miss_extra - 1.0)
    events = getattr(storage_stats, "retries", 0) \
        + getattr(storage_stats, "spikes", 0)
    return events * extra / max(batch_q, 1)
