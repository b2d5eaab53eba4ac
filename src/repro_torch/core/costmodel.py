"""System-tax cost model, counter-to-cycles half (paper §3.4, §6.2, Fig. 10).

`cycle_breakdown` translates MEASURED SearchStats counters into modeled CPU
cycles of a PostgreSQL-like page engine (SYSTEM) or a flat-memory library
(LIBRARY).  The constants and formulas are the reference's; the predictive
half (`predict_counters` / `predict_cycles`, used by the adaptive planner)
is a later slice of the port.  Pure numpy on host values.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.types import AnytimeInfo, SearchParams, SearchStats


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


def _is_batched(stats: SearchStats) -> bool:
    return stats.distance_comps.ndim > 0


def cycle_breakdown(stats: SearchStats, dim: int,
                    constants: CostConstants = SYSTEM,
                    scale: Optional[Mapping[str, float]] = None,
                    graph_quant: str = "none") -> dict[str, float]:
    """Per-component modeled cycles for one query (Fig. 10 bars); a batch
    of counters is averaged over its queries first."""
    s = {k: float(np.asarray(v, np.float64).mean())
         for k, v in stats.as_dict().items()}
    return component_cycles(s, dim, constants, scale, graph_quant)


def stats_table_row(stats: SearchStats) -> dict[str, float]:
    """Mean counters over a query batch — one row of the paper's Table 6."""
    return {k: float(np.asarray(v, np.float64).mean())
            for k, v in stats.as_dict().items()}


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
