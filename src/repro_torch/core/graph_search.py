"""Graph-based filtered vector search: the batch-synchronous frontier engine
(paper §2.3, §3.1–3.2).

Strategies, one superstep loop for the whole query batch:

  unfiltered      — plain HNSW base-layer search (zoom-in + beam)
  sweeping        — traversal-first: navigate the full graph, filter-check a
                    candidate only when it would enter the result queue W
  acorn           — filter-first: predicate-subgraph traversal with run-time
                    2-hop neighbor expansion (ACORN-1), with the "hardened"
                    adaptive skip of 2-hop for passing branches
  navix           — ACORN-1 base + NaviX heuristics (blind / directed /
                    onehop / adaptive-local)
  iterative_scan  — pgvector 0.8.0 resumable post-filtering

Two tiers sit on every strategy: `graph_quant="sq8"` navigates over the
store's SQ8 shadow rows (the `frontier_scan_sq8` kernel) and re-scores the
final result beam exactly from the full-precision rows; FAVOR exclusion
pruning (sweeping only) drops a scored candidate from the pool, never from
W, when its exclusion radius proves no passing row behind it can beat the
result tail (the `frontier_scan_excl[_sq8]` kernels).

Every query advances one hop per superstep.  The per-query state machine
(pop order, masks, counter formulas, stable tie order of every merge) is
the reference engine's, so ids, distances and the seven Table-6 counters
agree with it exactly wherever the arithmetic is exact.  Each superstep's
candidates are scored by the `frontier_scan` kernel, which gathers the
candidate rows by id itself.  Finished lanes are frozen by masking: their
pops are suppressed, their candidates are all +inf (an identity merge) and
their counter increments are zero.

The visited set is a (Q, n + 1) bool map: column n is a sink that absorbs
the writes of -1 padding, so marking is a plain scatter.

`collect_trace=True` also returns the storage-access trace: per query, the
first-touch superstep stamp of every heap row fetched and every adjacency
entry read (`TRACE_UNTOUCHED` where never), for the storage engine to
replay in traversal order.  Rows are stamped with a scatter-min of the
superstep's post-increment hop count as the superstep marks them visited,
which are exactly the rows the reference finds newly set between two
snapshots of its visited bitsets.

The same loop is exposed as a stepped driver for continuous batching
(`frontier_init`, `step_supersteps`, `frontier_finalize`,
`frontier_write_slot`, `frontier_idle` over a `FrontierState`):
`search_batch` is init, steps to completion and harvest, so the one-shot
and stepped paths run the same code.

`graph_exec_mode="vmapped"` runs the reference's legacy per-query beam
search instead, with the query batch written out as a leading dimension:
every lane steps until its own stop and finished lanes are frozen.  It is
the equivalence oracle of the frontier engine and scores through the
search engines' `distance`, not through a kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.costmodel import budget_cycle_weights
from repro_torch.core.hnsw import HNSWGraph
from repro_torch.core.types import (SearchParams, SearchStats, VectorStore,
                                    bitset_words, distance,
                                    heap_pages_per_vector,
                                    probe_batch, quant_heap_pages_per_vector,
                                    topk_smallest)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import dequantize
from repro_torch.storage.engine import TRACE_UNTOUCHED

INF = float("inf")

GRAPH_QUANT_MODES = ("none", "sq8")


@dataclasses.dataclass(frozen=True)
class QueryRadii:
    """Per-query exclusion radii without a (Q, n) block: query q reads row
    `rows[q]` of the (R + F, n) squared-radius table (a ladder rung or an
    exact family row)."""

    table: torch.Tensor     # (R + F, n) f32
    rows: torch.Tensor      # (Q,) int32

    def dense(self) -> torch.Tensor:
        """The (Q, n) block the reference's `select_radii` returns (tests
        at small n only)."""
        return self.table[self.rows.to(torch.int64)]

    def take(self, qsel: torch.Tensor) -> "QueryRadii":
        return QueryRadii(self.table, self.rows[qsel])


def _ppv(store: VectorStore, quant: str) -> int:
    """Heap pages per traversal-fetched vector: full-width rows for the
    classic tier, SQ8 shadow rows for the quantized tier."""
    return (quant_heap_pages_per_vector(store.dim) if quant == "sq8"
            else heap_pages_per_vector(store.dim))


def _budget_over(st: SearchStats, params: SearchParams, dim: int,
                 deadline: torch.Tensor | None = None):
    """Anytime budget-stop predicate over the carried counters, or None
    when no budget is set.  The deadline term prices the counters with
    `budget_cycle_weights` in float32, in a fixed term order.  `deadline`
    is the stepped driver's per-lane (Q,) float32 deadline (+inf for
    none), compared with the same cycles as the static
    `params.deadline_cycles`, so a lane with deadline b stops where a
    batch with deadline_cycles=b does."""
    terms = []
    if params.page_budget > 0:
        terms.append(st.page_accesses_index + st.page_accesses_heap
                     >= params.page_budget)
    if params.hop_budget > 0:
        terms.append(st.hops >= params.hop_budget)
    if params.deadline_cycles > 0 or deadline is not None:
        # float32 constants filled on the device: a tensor copied from
        # the host would cost a host sync every superstep
        dev = st.hops.device
        cyc = None
        for name, weight in budget_cycle_weights(dim).items():
            w = torch.full((), weight, dtype=torch.float32, device=dev)
            t = getattr(st, name).to(torch.float32) * w
            cyc = t if cyc is None else cyc + t
        if params.deadline_cycles > 0:
            terms.append(cyc >= torch.full((), params.deadline_cycles,
                                           dtype=torch.float32, device=dev))
        if deadline is not None:
            terms.append(cyc >= deadline)
    if not terms:
        return None
    out = terms[0]
    for t in terms[1:]:
        out = out | t
    return out


def _gather_vec_dist(store: VectorStore, queries: torch.Tensor,
                     ids: torch.Tensor, quant: str = "none") -> torch.Tensor:
    """(Q, m) distances of each query to the rows `ids` (Q, m); a -1 id
    reads row 0, as in the reference, and callers mask it.  quant="sq8"
    reads the shadow rows, dequantized, with their precomputed norms."""
    safe = ids.clamp(min=0).to(torch.int64)
    if quant == "sq8":
        vecs = dequantize(store.q_vectors[safe], store.q_scale, store.q_mean)
        nsq = store.q_norms_sq[safe]
    else:
        vecs, nsq = store.vectors[safe], store.norms_sq[safe]
    return distance(store.metric, queries[:, None, :], vecs, nsq)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _masked(active: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(active, _i32(v), torch.zeros_like(_i32(v)))


@dataclasses.dataclass
class _Trace:
    """First-touch superstep stamps, (Q, n) int32 each: heap rows fetched
    and adjacency entries read."""
    heap: torch.Tensor
    index: torch.Tensor

    @staticmethod
    def empty(qn: int, n: int, device) -> "_Trace":
        return _Trace(*(torch.full((qn, n), TRACE_UNTOUCHED,
                                   dtype=torch.int32, device=device)
                        for _ in range(2)))


def _stamp(steps: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
           step: torch.Tensor) -> None:
    """steps[q, ids[q, j]] = min(., step[q]) where mask[q, j] and the id is
    not padding, in place."""
    qn = ids.shape[0]
    live = (mask & (ids >= 0)).reshape(qn, -1)
    val = torch.where(live, step.to(torch.int32)[:, None],
                      torch.full_like(live, TRACE_UNTOUCHED,
                                      dtype=torch.int32))
    steps.scatter_reduce_(1, ids.reshape(qn, -1).clamp(min=0).to(
        torch.int64), val, reduce="amin")


def _zoom_in(graph: HNSWGraph, store: VectorStore, queries: torch.Tensor,
             quant: str = "none", trace: _Trace | None = None):
    """Greedy upper-layer descent of every query (always unfiltered, paper
    §2.3.1 phase (i)), on the tier `quant` names.  With a `trace`, the
    entry and every scored neighbor are stamped into its heap stamps and
    every node whose adjacency is read into its index stamps, with the hop
    count at fetch time.  Returns (entry (Q,), entry_d (Q,), stats)."""
    qn = queries.shape[0]
    dev = queries.device
    ppv = _ppv(store, quant)
    cur = torch.full((qn,), graph.entry_point, dtype=torch.int64, device=dev)
    cur_d = _gather_vec_dist(store, queries, cur[:, None], quant)[:, 0]
    st = SearchStats.zeros((qn,), device=dev)
    st.distance_comps += 1
    st.page_accesses_heap += ppv
    if trace is not None:
        _stamp(trace.heap, cur[:, None], torch.ones_like(cur[:, None],
                                                         dtype=torch.bool),
               st.hops)
    for lvl in range(graph.num_levels - 1, 0, -1):
        improved = torch.ones(qn, dtype=torch.bool, device=dev)
        while bool(improved.any()):
            nbrs = graph.neighbors[lvl, cur].to(torch.int64)   # (Q, 2M)
            valid = nbrs >= 0
            d = torch.where(valid, _gather_vec_dist(store, queries, nbrs,
                                                    quant),
                            torch.full_like(cur_d[:, None], INF))
            j = torch.argmin(d, 1, keepdim=True)
            dj = torch.gather(d, 1, j)[:, 0]
            better = improved & (dj < cur_d)
            n_valid = valid.sum(1)
            st.distance_comps += _masked(improved, n_valid)
            st.hops += _i32(improved)
            st.page_accesses_index += _i32(improved)
            st.page_accesses_heap += _masked(improved, n_valid * ppv)
            if trace is not None:
                _stamp(trace.index, cur[:, None], improved[:, None], st.hops)
                _stamp(trace.heap, nbrs, valid & improved[:, None], st.hops)
            cur = torch.where(better, torch.gather(nbrs, 1, j)[:, 0], cur)
            cur_d = torch.where(better, dj, cur_d)
            improved = better
    return cur, cur_d, st


def _frontier_scores(queries, store: VectorStore, cids, bitmaps,
                     quant: str = "none"):
    """Scoring + filter probe of one (Q, C) candidate id block: the
    `frontier_scan[_sq8]` kernel on the card, its plain version on the
    CPU."""
    if quant == "sq8":
        return ops.frontier_scan_sq8(queries, store.q_vectors, store.q_scale,
                                     store.q_mean, store.q_norms_sq, cids,
                                     bitmaps, metric=store.metric)
    return ops.frontier_scan(queries, store.vectors, store.norms_sq, cids,
                             bitmaps, metric=store.metric)


def _frontier_scores_excl(queries, store: VectorStore, cids, bitmaps,
                          quant: str, excl: QueryRadii, tau, margin: float):
    """`_frontier_scores` plus the FAVOR keep mask; each candidate's radius
    is read by the kernel from the radius table.  Returns (dists, pass,
    keep)."""
    if quant == "sq8":
        return ops.frontier_scan_excl_sq8(
            queries, store.q_vectors, store.q_scale, store.q_mean,
            store.q_norms_sq, cids, bitmaps, excl.table, excl.rows, tau,
            metric=store.metric, margin=margin)
    return ops.frontier_scan_excl(queries, store.vectors, store.norms_sq,
                                  cids, bitmaps, excl.table, excl.rows, tau,
                                  metric=store.metric, margin=margin)


def _merge_smallest(buf_d, buf_id, cand_d, cand_id, drop_head=None):
    """Keep the B smallest of buffer ∪ candidates, sorted ascending, ties
    in concat order (buffer first, then candidates in order).  `drop_head`
    (per-row bool) first drops the buffer's slot 0: the pool pop."""
    qn, b = buf_d.shape
    if drop_head is not None:
        sd = torch.cat([buf_d[:, 1:], torch.full_like(buf_d[:, :1], INF)], 1)
        si = torch.cat([buf_id[:, 1:], torch.full_like(buf_id[:, :1], -1)],
                       1)
        buf_d = torch.where(drop_head[:, None], sd, buf_d)
        buf_id = torch.where(drop_head[:, None], si, buf_id)
    d = torch.cat([buf_d, cand_d], 1)
    i = torch.cat([buf_id, cand_id], 1)
    nd, pos = topk_smallest(d, b)
    return nd, torch.gather(i, 1, pos)


def _probe_visited(visited: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(Q, n + 1) visited map probed at (Q, ...) ids; -1 -> False."""
    flat = ids.reshape(ids.shape[0], -1)
    hit = torch.gather(visited, 1, flat.clamp(min=0))
    return (hit & (flat >= 0)).reshape(ids.shape)


def _mark(visited: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
          trace: _Trace | None = None, step=None) -> torch.Tensor:
    """Mark ids[mask] visited, in place (the map is Q x n bytes, too large
    to copy each superstep); everything else lands in the sink column.
    Every probe that needs the unmarked state runs before the mark.  The
    marked ids are unvisited until now, so with a `trace` they are the
    superstep's newly fetched rows and get its heap stamp `step`."""
    sink = visited.shape[1] - 1
    idx = torch.where(mask & (ids >= 0), ids, torch.full_like(ids, sink))
    if trace is not None:
        _stamp(trace.heap, ids, mask, step)
    return visited.scatter_(1, idx.reshape(ids.shape[0], -1), True)


def _dedup_first(ids: torch.Tensor) -> torch.Tensor:
    """Per row, mask of first occurrences (-1 -> False)."""
    srt, order = torch.sort(ids, dim=1, stable=True)
    first = torch.cat([torch.ones_like(srt[:, :1], dtype=torch.bool),
                       srt[:, 1:] != srt[:, :-1]], 1)
    mask = torch.zeros_like(first).scatter(1, order, first)
    return mask & (ids >= 0)


def _compact_positions(mask: torch.Tensor, pad_to: int) -> torch.Tensor:
    """Per row, positions of the True entries in order, -1 padded."""
    cs = torch.cumsum(mask.to(torch.int64), 1)
    want = torch.arange(1, pad_to + 1, device=mask.device)
    pos = torch.searchsorted(cs, want.expand(mask.shape[0], pad_to)
                             .contiguous())
    return torch.where(want[None, :] <= cs[:, -1:], pos,
                       torch.full_like(pos, -1))


def _score_insert_chunks(queries, bitmaps, store, cand_ids, sel_mask,
                         chunk: int, pool, w, visited, sweep_worst=None,
                         dedup: bool = False, drop_head=None,
                         quant: str = "none", excl=None,
                         excl_margin: float = 0.5, excl_exact: bool = False,
                         trace: _Trace | None = None, step=None):
    """Score the selected candidates chunk at a time and merge them into
    the pool and the result queue, marking them visited as chunks finish.

    cand_ids (Q, m), sel_mask (Q, m): candidates needing distances, walked
    in flat order so insertion (and tie) order is the single-shot one.
    `sweep_worst` (sweeping) gates W insertion on d < sweep_worst and the
    filter probe, and counts the would-enter-W checks.  `dedup` (filter-
    first 2-hop) drops candidates already visited and repeats within a
    chunk.  `drop_head` folds the superstep's pool pop into the first
    merge.  `quant` picks the scored tier.  `excl` (sweeping only) gates
    POOL insertion on the keep mask with tau = `sweep_worst`: a dropped
    candidate keeps its distance, W eligibility, visited mark and filter
    check, but its branch is never popped; `excl_exact` (family-exact
    radii) stops charging the filter check of a pruned candidate.
    `trace` / `step` stamp the marked rows (`_mark`).
    Returns (pool_d, pool_id, w_d, w_id, visited, n_would)."""
    qn, m = cand_ids.shape
    c = m if chunk <= 0 else min(chunk, m)
    pool_d, pool_id = pool
    w_d, w_id = w
    n_would = torch.zeros(qn, dtype=torch.int32, device=queries.device)

    def chunk_step(pd, pi, wd, wi, vis, nw, cids, drop):
        if dedup:
            seen = _probe_visited(vis, cids)
            cids = torch.where(_dedup_first(cids) & ~seen, cids,
                               torch.full_like(cids, -1))
        valid = cids >= 0
        keep = None
        if excl is not None:
            dch, pch, keep = _frontier_scores_excl(
                queries, store, cids, bitmaps, quant, excl, sweep_worst,
                excl_margin)
        else:
            dch, pch = _frontier_scores(queries, store, cids, bitmaps, quant)
        cd = torch.where(valid, dch, torch.full_like(dch, INF))
        if sweep_worst is not None:
            would = valid & (cd < sweep_worst[:, None])
            charged = would & keep if (excl_exact and keep is not None) \
                else would
            nw = nw + _i32(charged.sum(1))
            enter = would & pch
            wd_in = torch.where(enter, cd, torch.full_like(cd, INF))
            wi_in = torch.where(enter, cids, torch.full_like(cids, -1))
        else:
            wd_in, wi_in = cd, cids
        if keep is None:
            pd, pi = _merge_smallest(pd, pi, cd, cids, drop)
        else:
            pd, pi = _merge_smallest(
                pd, pi, torch.where(keep, cd, torch.full_like(cd, INF)),
                torch.where(keep, cids, torch.full_like(cids, -1)), drop)
        wd, wi = _merge_smallest(wd, wi, wd_in, wi_in)
        return pd, pi, wd, wi, _mark(vis, cids, valid, trace, step), nw

    if c >= m:
        # one chunk: score the masked candidates in place
        cids = torch.where(sel_mask, cand_ids, torch.full_like(cand_ids, -1))
        return chunk_step(pool_d, pool_id, w_d, w_id, visited, n_would,
                          cids, drop_head)

    if drop_head is not None:   # pop up front: the loop may not run at all
        pool_d = torch.where(drop_head[:, None], torch.cat(
            [pool_d[:, 1:], torch.full_like(pool_d[:, :1], INF)], 1), pool_d)
        pool_id = torch.where(drop_head[:, None], torch.cat(
            [pool_id[:, 1:], torch.full_like(pool_id[:, :1], -1)], 1),
            pool_id)
    padlen = -(-m // c) * c
    pos = _compact_positions(sel_mask, padlen)
    n_chunks = -(-int(sel_mask.sum(1).max()) // c) if qn else 0
    for i in range(n_chunks):
        cpos = pos[:, i * c:(i + 1) * c]
        cids = torch.where(cpos >= 0,
                           torch.gather(cand_ids, 1, cpos.clamp(min=0)),
                           torch.full_like(cpos, -1))
        pool_d, pool_id, w_d, w_id, visited, n_would = chunk_step(
            pool_d, pool_id, w_d, w_id, visited, n_would, cids, None)
    return pool_d, pool_id, w_d, w_id, visited, n_would


@dataclasses.dataclass
class _Lanes:
    """Per-query loop state of the frontier engines."""
    pool_d: torch.Tensor
    pool_id: torch.Tensor
    w_d: torch.Tensor
    w_id: torch.Tensor
    visited: torch.Tensor
    st: SearchStats
    done: torch.Tensor


def _init_lanes(graph: HNSWGraph, entry, entry_d, st: SearchStats,
                params: SearchParams, w_width: int,
                seed_ok: torch.Tensor) -> _Lanes:
    qn = entry.shape[0]
    dev = entry.device
    rows = torch.arange(qn, device=dev)
    pool_d = torch.full((qn, params.beam_width), INF, device=dev)
    pool_id = torch.full((qn, params.beam_width), -1, dtype=torch.int64,
                         device=dev)
    pool_d[:, 0], pool_id[:, 0] = entry_d, entry
    visited = torch.zeros((qn, graph.n + 1), dtype=torch.bool, device=dev)
    visited[rows, entry] = True
    w_d = torch.full((qn, w_width), INF, device=dev)
    w_id = torch.full((qn, w_width), -1, dtype=torch.int64, device=dev)
    w_d[:, 0] = torch.where(seed_ok, entry_d, torch.full_like(entry_d, INF))
    w_id[:, 0] = torch.where(seed_ok, entry, torch.full_like(entry, -1))
    return _Lanes(pool_d, pool_id, w_d, w_id, visited, st,
                  torch.zeros(qn, dtype=torch.bool, device=dev))


def _count(st: SearchStats, active, dc, fc, pai, pah, tm) -> SearchStats:
    return SearchStats(st.distance_comps + _masked(active, dc),
                       st.filter_checks + _masked(active, fc),
                       st.hops + _i32(active),
                       st.page_accesses_index + _masked(active, pai),
                       st.page_accesses_heap + _masked(active, pah),
                       st.tmap_lookups + _masked(active, tm),
                       st.reorder_rows)


def _base_superstep(graph: HNSWGraph, store: VectorStore, queries, bitmaps,
                    params: SearchParams, ef_result: int, s: _Lanes,
                    excl=None, trace: _Trace | None = None,
                    deadline=None) -> _Lanes:
    """One superstep of the base (non-iterative) engine.  `excl`
    (QueryRadii, sweeping only) prunes pool insertion; `trace` collects
    the storage trace; `deadline` is the per-lane deadline of the stepped
    driver.  A lane that is done or stopping scores no candidate (its ids
    reach the kernels as -1) and moves no counter."""
    qn = queries.shape[0]
    strat = params.strategy
    quant = params.graph_quant
    ppv = _ppv(store, quant)
    deg = graph.neighbors.shape[2]
    tm_on = params.translation_map
    we_idx = params.ef_search - 1 if ef_result >= params.ef_search \
        else ef_result - 1

    # the pool is kept sorted, so the pop is always slot 0
    best_d, best_id = s.pool_d[:, 0], s.pool_id[:, 0]
    w_worst = s.w_d[:, we_idx]
    stop = (best_d > w_worst) | torch.isinf(best_d) | \
        (s.st.hops >= params.max_hops)
    over = _budget_over(s.st, params, store.dim, deadline)
    if over is not None:
        stop = stop | over
    active = ~s.done & ~stop
    node = best_id.clamp(min=0)
    step = s.st.hops + 1          # this superstep's post-increment stamp
    if trace is not None:         # adjacency read of the popped node
        _stamp(trace.index, node[:, None], active[:, None], step)

    nb1 = graph.neighbors[0, node].to(torch.int64)            # (Q, deg)
    v1 = nb1 >= 0
    unv1 = v1 & ~_probe_visited(s.visited, nb1)
    zero = torch.zeros(qn, dtype=torch.int64, device=queries.device)
    dc, fc, pai, pah, tm = zero, zero, zero + 1, zero, zero

    if strat in ("unfiltered", "sweeping"):
        # traversal-first: score every unvisited 1-hop neighbor
        n_s = unv1.sum(1)
        dc, pah = dc + n_s, pah + n_s * ppv
        pool_d, pool_id, w_d, w_id, visited, n_w = _score_insert_chunks(
            queries, bitmaps, store, nb1, unv1 & active[:, None],
            params.frontier_chunk, (s.pool_d, s.pool_id), (s.w_d, s.w_id),
            s.visited, sweep_worst=w_worst if strat == "sweeping" else None,
            drop_head=active, quant=quant,
            excl=excl if strat == "sweeping" else None,
            excl_margin=params.exclusion_margin,
            excl_exact=params.exclusion == "prune_exact", trace=trace,
            step=step)
        if strat == "sweeping":
            fc = fc + n_w
            if tm_on:
                tm = tm + n_w
            else:
                pai = pai + n_w
    else:
        # filter-first (acorn / navix): the predicate subgraph
        d1, pass1 = _frontier_scores(
            queries, store, torch.where(active[:, None], nb1,
                                        torch.full_like(nb1, -1)),
            bitmaps, quant)
        n1 = v1.sum(1)
        fc = fc + n1                                   # check all 1-hop
        if tm_on:
            tm = tm + n1
        else:
            pai = pai + n1
        pass1v = pass1 & v1
        local_sel = pass1v.sum(1) / n1.clamp(min=1)
        false = torch.zeros(qn, dtype=torch.bool, device=queries.device)
        do_directed, do_twohop_all = false, ~false
        if strat == "navix":
            h = params.navix_heuristic
            if h == "directed":
                do_directed, do_twohop_all = ~false, false
            elif h == "onehop":
                do_twohop_all = false
            elif h != "blind":       # adaptive-local (paper §2.3.4)
                sel32 = local_sel.to(torch.float32)
                do_directed = (sel32 > 0.08) & (sel32 <= 0.35)
                do_twohop_all = sel32 <= 0.08

        # 1-hop: score the passing, unvisited ones
        s1 = pass1v & unv1
        n_s1 = s1.sum(1)
        dc, pah = dc + n_s1, pah + n_s1 * ppv

        # which branches expand to 2 hops
        expand = v1
        if params.adaptive_skip_2hop:
            expand = expand & ~pass1v
        if strat == "navix" and params.navix_heuristic in ("directed",
                                                           "adaptive"):
            rank = torch.sort(torch.where(v1, d1, torch.full_like(d1, INF)),
                              dim=1, stable=True).indices
            topr = torch.zeros_like(v1).scatter(
                1, rank[:, :max(1, deg // 4)], True)
            expand = torch.where(do_twohop_all[:, None], expand,
                                 do_directed[:, None] & expand & topr)
            extra = torch.where(do_directed, (v1 & ~s1).sum(1), zero)
            dc, pah = dc + extra, pah + extra * ppv
        elif strat == "navix" and params.navix_heuristic == "onehop":
            expand = torch.zeros_like(expand)

        pai = pai + expand.sum(1)                      # branch pages
        if trace is not None:     # adjacency reads of the expanded branches
            _stamp(trace.index, nb1, expand & active[:, None], step)
        nb2 = graph.neighbors[0, nb1.clamp(min=0)].to(torch.int64)
        nb2 = torch.where(v1[:, :, None], nb2, torch.full_like(nb2, -1))
        v2 = nb2 >= 0
        pass2 = probe_batch(bitmaps, nb2)
        unv2 = v2 & ~_probe_visited(s.visited, nb2)
        m2 = v2 & expand[:, :, None]
        n2 = m2.sum((1, 2))
        fc = fc + n2                                   # 2-hop checks
        if tm_on:
            tm = tm + n2
        else:
            pai = pai + n2
        s2 = m2 & pass2 & unv2
        n_s2 = s2.sum((1, 2))
        dc, pah = dc + n_s2, pah + n_s2 * ppv

        # 1-hop insertion + marking first (neighbor lists hold no repeats),
        # with the pool pop folded in
        ins1 = s1 & active[:, None]
        in1_d = torch.where(ins1, d1, torch.full_like(d1, INF))
        in1_i = torch.where(ins1, nb1, torch.full_like(nb1, -1))
        pool_d, pool_id = _merge_smallest(s.pool_d, s.pool_id, in1_d, in1_i,
                                          active)
        w_d, w_id = _merge_smallest(s.w_d, s.w_id, in1_d, in1_i)
        visited = _mark(s.visited, nb1, ins1, trace, step)
        # lazy 2-hop: chunks dedup against visited marks as they go
        cid2 = torch.where(s2, nb2, torch.full_like(nb2, -1)).reshape(qn, -1)
        pool_d, pool_id, w_d, w_id, visited, _ = _score_insert_chunks(
            queries, bitmaps, store, cid2,
            s2.reshape(qn, -1) & active[:, None], params.frontier_chunk2,
            (pool_d, pool_id), (w_d, w_id), visited, dedup=True, quant=quant,
            trace=trace, step=step)

    st = _count(s.st, active, dc, fc, pai, pah, tm)
    return _Lanes(pool_d, pool_id, w_d, w_id, visited, st, s.done | stop)


def _iter_superstep(graph: HNSWGraph, store: VectorStore, queries, bitmaps,
                    params: SearchParams, s: _Lanes, eff, rnd, checked,
                    trace: _Trace | None = None, deadline=None):
    """One superstep of the iterative-scan engine: emit (post-filter the
    batch, maybe extend the scan) or expand."""
    quant = params.graph_quant
    ppv = _ppv(store, quant)
    efmax = params.batch_tuples * params.max_rounds
    tm_on = params.translation_map

    best_d, best_id = s.pool_d[:, 0], s.pool_id[:, 0]
    w_worst = torch.gather(s.w_d, 1, (eff.clamp(max=efmax) - 1)[:, None])[:, 0]
    over = _budget_over(s.st, params, store.dim, deadline)
    batch_done = (best_d > w_worst) | torch.isinf(best_d) | \
        (s.st.hops >= params.max_hops)
    if over is not None:
        batch_done = batch_done | over
    live = ~s.done
    active = live & ~batch_done

    # resume / emit: filter the batch, maybe extend the scan
    in_batch = torch.arange(efmax, device=eff.device)[None, :] < eff[:, None]
    n_pass = (probe_batch(bitmaps, s.w_id) & in_batch
              & (s.w_id >= 0)).sum(1)
    newly = (eff.clamp(max=efmax) - checked).clamp(min=0)
    fc_emit = torch.where(live & batch_done, newly, torch.zeros_like(newly))
    enough = n_pass >= params.k
    exhausted = torch.isinf(best_d) | (s.st.hops >= params.max_hops) | \
        (rnd + 1 >= params.max_rounds)
    if over is not None:
        exhausted = exhausted | over
    finish = batch_done & (enough | exhausted)
    extend = live & batch_done & ~finish
    eff2 = torch.where(extend, eff + params.batch_tuples, eff)
    rnd2 = torch.where(extend, rnd + 1, rnd)
    checked2 = torch.where(live & batch_done, eff.clamp(max=efmax), checked)

    # expansion, on the active lanes only
    node = best_id.clamp(min=0)
    step = s.st.hops + 1
    if trace is not None:
        _stamp(trace.index, node[:, None], active[:, None], step)
    nb1 = graph.neighbors[0, node].to(torch.int64)
    score_m = (nb1 >= 0) & ~_probe_visited(s.visited, nb1)
    n_s = score_m.sum(1)
    pool_d, pool_id, w_d, w_id, visited, _ = _score_insert_chunks(
        queries, bitmaps, store, nb1, score_m & active[:, None],
        params.frontier_chunk, (s.pool_d, s.pool_id), (s.w_d, s.w_id),
        s.visited, drop_head=active, quant=quant, trace=trace, step=step)

    zero = torch.zeros_like(fc_emit)
    st = s.st
    st = SearchStats(
        st.distance_comps + _masked(active, n_s),
        st.filter_checks + _i32(fc_emit),
        st.hops + _i32(active),
        st.page_accesses_index + _i32(active)
        + _i32(zero if tm_on else fc_emit),
        st.page_accesses_heap + _masked(active, n_s * ppv),
        st.tmap_lookups + _i32(fc_emit if tm_on else zero),
        st.reorder_rows)
    lanes = _Lanes(pool_d, pool_id, w_d, w_id, visited, st,
                   s.done | (live & finish))
    return lanes, eff2, rnd2, checked2


def _iter_finish(store: VectorStore, queries, bitmaps, params: SearchParams,
                 w_d, w_id, eff, st: SearchStats):
    """The iterative scan's final emit over the (Q, EFMAX) result buffer:
    post-filter the in-batch rows and keep the top k (on the SQ8 tier,
    rerank the top k * reorder_factor exactly).  Returns (dists, ids,
    stats, the reranked rows or None)."""
    efmax = w_d.shape[1]
    if params.graph_quant == "sq8" and params.sq8_rerank:
        r = min(params.k * params.reorder_factor, efmax)
        dk, ids, n_r, cand = _iter_emit_sq8(store, queries, w_d, w_id,
                                            bitmaps, eff, params.k, r)
        return dk, ids, _add_rerank(st, n_r, store.dim), cand
    in_batch = torch.arange(efmax, device=w_d.device)[None, :] < eff[:, None]
    dm = torch.where(in_batch, w_d, torch.full_like(w_d, INF))
    im = torch.where(in_batch, w_id, torch.full_like(w_id, -1))
    ok = probe_batch(bitmaps, im) & (im >= 0)
    dk, pos = topk_smallest(torch.where(ok, dm, torch.full_like(dm, INF)),
                            params.k)
    ids = torch.where(torch.isinf(dk), torch.full_like(pos, -1),
                      torch.gather(im, 1, pos))
    return dk, ids, st, None


def _add_rerank(st: SearchStats, n_r, dim: int) -> SearchStats:
    """Charge an exact rerank of n_r (Q,) rows: one distance, full-width
    heap pages and one reorder row each."""
    n_r = _i32(n_r)
    return SearchStats(st.distance_comps + n_r, st.filter_checks, st.hops,
                       st.page_accesses_index,
                       st.page_accesses_heap + n_r * heap_pages_per_vector(
                           dim),
                       st.tmap_lookups, st.reorder_rows + n_r)


def _rerank_beam(store: VectorStore, queries, w_id, st: SearchStats):
    """Exact full-precision rescore of the final result beam (the SQ8
    tier's recall bound): the beam's exact distances in the same slots,
    and the stats charged for it."""
    valid = w_id >= 0
    exact = torch.where(valid, _gather_vec_dist(store, queries, w_id),
                        torch.full(w_id.shape, INF, device=w_id.device))
    return exact, _add_rerank(st, valid.sum(1), store.dim)


def _iter_emit_sq8(store: VectorStore, queries, w_d, w_id, bitmaps, eff,
                   k: int, r: int):
    """Quantized iterative-scan emit: post-filter the in-batch candidates,
    take the top r by quantized distance and re-score them exactly.
    Returns (dists (Q, k), ids (Q, k), n_reranked (Q,), the reranked rows
    (Q, r), -1 padded)."""
    efmax = w_d.shape[1]
    in_batch = torch.arange(efmax, device=w_d.device)[None, :] < eff[:, None]
    d = torch.where(in_batch, w_d, torch.full_like(w_d, INF))
    ids = torch.where(in_batch, w_id, torch.full_like(w_id, -1))
    passing = probe_batch(bitmaps, ids) & (ids >= 0)
    rd, rpos = topk_smallest(torch.where(passing, d, torch.full_like(d, INF)),
                             r)
    cand = torch.where(torch.isfinite(rd), torch.gather(ids, 1, rpos),
                       torch.full_like(rpos, -1))
    exact = torch.where(cand >= 0, _gather_vec_dist(store, queries, cand),
                        torch.full(cand.shape, INF, device=cand.device))
    dk, pos = topk_smallest(exact, k)
    out = torch.where(torch.isinf(dk), torch.full_like(pos, -1),
                      torch.gather(cand, 1, pos))
    return dk, out, (cand >= 0).sum(1), cand


def _finalize(w_d, w_id, bitmaps, k: int, check_filter: bool):
    """Top-k filter-passing results out of the sorted W buffers."""
    ok = w_id >= 0
    if check_filter:
        ok = ok & probe_batch(bitmaps, w_id)
    d = torch.where(ok, w_d, torch.full_like(w_d, INF))
    dk, pos = topk_smallest(d, k)
    ids = torch.where(torch.isinf(dk), torch.full_like(pos, -1),
                      torch.gather(w_id, 1, pos))
    return dk, ids


# ---------------------------------------------------------------------------
# The frontier engine as init, superstep loop and harvest.  `search_batch`
# runs them back to back; the stepped driver below exposes them to a
# scheduler that steps a fixed-width pool of lanes in hop chunks, retires
# finished lanes and writes waiting queries into their slots.  A done lane
# is frozen by the superstep bodies (no pop, candidate ids -1, no counter
# increment) and each lane's trajectory reads only its own row of the
# state, so how the hops are chunked and which lanes share the pool is
# invisible in every lane's results.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrontierState:
    """The frontier engine's per-lane state, one row per slot.

    `hs` / `is_` are the storage-trace stamp rows, (W, n) int32 first-touch
    supersteps, or (W, 0) when tracing is off (the width is the tracing
    flag).  `deadline` is a per-lane anytime budget in modeled cycles
    (+inf for none), read by `step_supersteps(dynamic_deadline=True)`.
    `eff` / `rnd` / `checked` are iterative_scan's resume cursors (zeros
    for the base engine).  Done lanes are frozen and may be harvested or
    replaced between steps."""

    queries: torch.Tensor       # (W, d) f32
    bitmaps: torch.Tensor       # (W, words) int32
    pool_d: torch.Tensor        # (W, beam) f32, sorted ascending
    pool_id: torch.Tensor       # (W, beam) int64
    w_d: torch.Tensor           # (W, ef or EFMAX) f32, sorted ascending
    w_id: torch.Tensor          # (W, ef or EFMAX) int64
    visited: torch.Tensor       # (W, n + 1) bool, column n the sink
    hs: torch.Tensor            # (W, n) or (W, 0) int32 heap stamps
    is_: torch.Tensor           # (W, n) or (W, 0) int32 adjacency stamps
    stats: SearchStats          # (W,) int32 counters
    deadline: torch.Tensor      # (W,) f32
    eff: torch.Tensor           # (W,) int64
    rnd: torch.Tensor           # (W,) int64
    checked: torch.Tensor       # (W,) int64
    done: torch.Tensor          # (W,) bool

    @property
    def tracing(self) -> bool:
        return self.hs.shape[1] > 0


def _init_state(graph: HNSWGraph, store: VectorStore, queries, bitmaps,
                params: SearchParams, collect_trace: bool,
                deadline: torch.Tensor) -> FrontierState:
    """Zoom-in (stats seeded with its counters, stamps when tracing) and
    the engine state of `params.strategy`."""
    qn = queries.shape[0]
    dev = queries.device
    trace = _Trace.empty(qn, graph.n, dev) if collect_trace else None
    entry, entry_d, st = _zoom_in(graph, store, queries, params.graph_quant,
                                  trace)
    zeros = torch.zeros(qn, dtype=torch.int64, device=dev)
    if params.strategy == "iterative_scan":
        s = _init_lanes(graph, entry, entry_d, st, params,
                        params.batch_tuples * params.max_rounds,
                        torch.ones(qn, dtype=torch.bool, device=dev))
        eff = torch.full((qn,), params.batch_tuples, dtype=torch.int64,
                         device=dev)
    else:
        seed_ok = probe_batch(bitmaps, entry[:, None])[:, 0] \
            | (params.strategy == "unfiltered")
        s = _init_lanes(graph, entry, entry_d, st, params, params.ef_search,
                        seed_ok)
        eff = zeros
    if trace is None:
        trace = _Trace(*(torch.zeros((qn, 0), dtype=torch.int32, device=dev)
                         for _ in range(2)))
    return FrontierState(queries, bitmaps, s.pool_d, s.pool_id, s.w_d,
                         s.w_id, s.visited, trace.heap, trace.index, s.st,
                         deadline, eff, zeros.clone(), zeros.clone(), s.done)


def _advance(graph: HNSWGraph, store: VectorStore, state: FrontierState,
             params: SearchParams, n_hops: int | None = None, excl=None,
             deadline=None) -> FrontierState:
    """Up to `n_hops` supersteps (None: until every lane is done), one
    host sync each (`done.all()`).  The visited map and the trace stamps
    are updated in place (they are W x n, too large to copy each
    superstep); every other field of the returned state is new."""
    s = _Lanes(state.pool_d, state.pool_id, state.w_d, state.w_id,
               state.visited, state.stats, state.done)
    trace = _Trace(state.hs, state.is_) if state.tracing else None
    eff, rnd, checked = state.eff, state.rnd, state.checked
    hop = 0
    while (n_hops is None or hop < n_hops) and not bool(s.done.all()):
        if params.strategy == "iterative_scan":
            s, eff, rnd, checked = _iter_superstep(
                graph, store, state.queries, state.bitmaps, params, s, eff,
                rnd, checked, trace, deadline)
        else:
            s = _base_superstep(graph, store, state.queries, state.bitmaps,
                                params, params.ef_search, s, excl, trace,
                                deadline)
        hop += 1
    return dataclasses.replace(
        state, pool_d=s.pool_d, pool_id=s.pool_id, w_d=s.w_d, w_id=s.w_id,
        visited=s.visited, stats=s.st, eff=eff, rnd=rnd, checked=checked,
        done=s.done)


def _harvest(store: VectorStore, state: FrontierState, params: SearchParams):
    """The post-loop emit: the SQ8 tier's exact rerank, the top-k with the
    strategy's filter check.  Writes nothing into the state.  Returns
    (dists (W, k), ids (W, k) int32, stats, trace dict or None)."""
    quant = params.graph_quant
    rerank_rows = None
    if params.strategy == "iterative_scan":
        dk, ids, st, rerank_rows = _iter_finish(
            store, state.queries, state.bitmaps, params, state.w_d,
            state.w_id, state.eff, state.stats)
    else:
        w_d, st = state.w_d, state.stats
        if quant == "sq8" and params.sq8_rerank:
            w_d, st = _rerank_beam(store, state.queries, state.w_id, st)
            rerank_rows = state.w_id
        dk, ids = _finalize(w_d, state.w_id, state.bitmaps, params.k,
                            check_filter=params.strategy != "unfiltered")
    trace = None
    if state.tracing:
        trace = {"heap_steps": state.hs, "index_steps": state.is_}
        if quant == "sq8" and rerank_rows is not None:
            trace["rerank_rows"] = rerank_rows.to(torch.int32)
    return dk, ids.to(torch.int32), st, trace


def frontier_init(graph: HNSWGraph, store: VectorStore, queries: torch.Tensor,
                  bitmaps: torch.Tensor, params: SearchParams,
                  collect_trace: bool = False,
                  deadlines=None) -> FrontierState:
    """Zoom-in and state init of the stepped frontier driver, as
    `search_batch` starts.  `deadlines` is an optional per-query
    modeled-cycle budget ((Q,), +inf for none) that rides in the state as
    data.  Exclusion pruning is refused: its radii do not ride in the
    state."""
    if params.exclusion != "none":
        raise ValueError("exclusion pruning is not supported by the "
                         "stepped frontier driver (the excl radii do not "
                         "ride in FrontierState); use the one-shot "
                         "search_batch path")
    _check_tier(store, params)
    qn = queries.shape[0]
    deadline = torch.full((qn,), INF, device=queries.device) \
        if deadlines is None else torch.as_tensor(
            deadlines, dtype=torch.float32, device=queries.device)
    return _init_state(graph, store, queries, bitmaps, params, collect_trace,
                       deadline)


def step_supersteps(graph: HNSWGraph, store: VectorStore,
                    state: FrontierState, params: SearchParams, n_hops: int,
                    dynamic_deadline: bool = False) -> FrontierState:
    """Advance every lane that is not done by up to `n_hops` supersteps,
    stopping early once every lane is done, so a lane's superstep bodies
    apply exactly as often as in the one-shot loop.  `dynamic_deadline`
    also stops each lane at its own `state.deadline`.  The returned state
    shares its visited map and trace stamps with `state`, which were
    advanced in place: step the returned state, not the old one."""
    return _advance(graph, store, state, params, n_hops,
                    deadline=state.deadline if dynamic_deadline else None)


def frontier_finalize(graph: HNSWGraph, store: VectorStore,
                      state: FrontierState, params: SearchParams):
    """Harvest (dists, ids, stats, trace or None) from the current state:
    the emit `search_batch` ends with, on every lane, finished or not.  It
    writes nothing into the state, so lanes still running are undisturbed.
    The stats are copies; the trace dict's stamps are the state's own rows
    (and "rerank_rows" on the SQ8 tier), valid until the next step or
    slot write."""
    dk, ids, st, trace = _harvest(store, state, params)
    st = SearchStats(*(getattr(st, f.name).clone()
                       for f in dataclasses.fields(SearchStats)))
    return dk, ids, st, trace


def frontier_write_slot(state: FrontierState, lane: FrontierState,
                        slot: int) -> FrontierState:
    """Copy lane 0 of a width-1 state into row `slot` of a pool state, in
    place, and return the pool state.  Every per-lane tensor is copied
    (the stats' counters, the visited row and the trace rows included), so
    a freed slot keeps nothing of its previous occupant."""
    for f in dataclasses.fields(FrontierState):
        dst, src = getattr(state, f.name), getattr(lane, f.name)
        if isinstance(dst, SearchStats):
            for g in dataclasses.fields(SearchStats):
                getattr(dst, g.name)[slot] = getattr(src, g.name)[0]
        else:
            dst[slot] = src[0]
    return state


def frontier_idle(graph: HNSWGraph, store: VectorStore, params: SearchParams,
                  width: int, collect_trace: bool = False) -> FrontierState:
    """An all-done pool state of `width` lanes to start a scheduler from:
    `frontier_init` on zero queries and empty bitmaps, every lane marked
    done (never stepped, never harvested)."""
    dev = store.device
    state = frontier_init(
        graph, store, torch.zeros((width, store.dim), device=dev),
        torch.zeros((width, bitset_words(store.n)), dtype=torch.int32,
                    device=dev), params, collect_trace=collect_trace)
    state.done = torch.ones(width, dtype=torch.bool, device=dev)
    return state


# ---------------------------------------------------------------------------
# The legacy engine (graph_exec_mode="vmapped"): the reference's per-query
# beam loop under jax.vmap, with the batch written out.  Its pool is popped
# by argmin and re-sorted by every insertion, its visited map is dense, and
# every lane scores its whole 1-hop (and, filter-first, 2-hop) block each
# step.  A lane's step applies only while it is neither done nor stopping;
# otherwise its state is kept as it was, as vmap's batched while_loop does.
# ---------------------------------------------------------------------------

def _insert_sorted(w_d, w_id, cand_d, cand_id):
    """Merge candidates into each lane's ascending fixed-size buffer."""
    d = torch.cat([w_d, cand_d], 1)
    i = torch.cat([w_id, cand_id], 1)
    nd, pos = topk_smallest(d, w_d.shape[1])
    return nd, torch.gather(i, 1, pos)


def _pool_insert(pool_d, pool_id, cand_d, cand_id):
    nd, ni = _insert_sorted(pool_d, pool_id, cand_d, cand_id)
    return torch.where(ni >= 0, nd, torch.full_like(nd, INF)), ni


def _pop(pool_d, pool_id):
    """The argmin pop (first minimum): (best_d, best_id, the pool without
    it)."""
    j = torch.argmin(pool_d, 1, keepdim=True)
    best_d = torch.gather(pool_d, 1, j)[:, 0]
    best_id = torch.gather(pool_id, 1, j)[:, 0]
    return (best_d, best_id, pool_d.scatter(1, j, INF),
            pool_id.scatter(1, j, -1))


def _keep(frozen, old, new):
    """Per lane, the old value where `frozen`, else the new one."""
    return torch.where(frozen.reshape((-1,) + (1,) * (old.dim() - 1)),
                       old, new)


def _keep_stats(frozen, old: SearchStats, new: SearchStats) -> SearchStats:
    return SearchStats(*(_keep(frozen, getattr(old, f.name),
                               getattr(new, f.name))
                         for f in dataclasses.fields(SearchStats)))


def _expand(graph: HNSWGraph, store: VectorStore, queries, bitmaps, node,
            visited, two_hop: bool, quant: str):
    """Each lane's 1-hop (and with `two_hop` 2-hop) neighborhood of `node`:
    ids, validity, unvisited and filter masks and distances."""
    qn = queries.shape[0]
    inf = torch.tensor(INF, device=queries.device)
    nb1 = graph.neighbors[0, node].to(torch.int64)            # (Q, deg)
    v1 = nb1 >= 0
    e = dict(nb1=nb1, v1=v1, unv1=v1 & ~_probe_visited(visited, nb1),
             pass1=probe_batch(bitmaps, nb1),
             d1=torch.where(v1, _gather_vec_dist(store, queries, nb1, quant),
                            inf))
    if not two_hop:
        return e
    deg = nb1.shape[1]
    nb2 = graph.neighbors[0, nb1.clamp(min=0)].to(torch.int64)
    nb2 = torch.where(v1[:, :, None], nb2, torch.full_like(nb2, -1))
    v2 = nb2 >= 0
    d2 = _gather_vec_dist(store, queries, nb2.reshape(qn, -1), quant)
    e.update(nb2=nb2, v2=v2, unv2=v2 & ~_probe_visited(visited, nb2),
             pass2=probe_batch(bitmaps, nb2),
             d2=torch.where(v2, d2.reshape(qn, deg, deg), inf))
    return e


def _legacy_base(graph: HNSWGraph, store: VectorStore, queries, bitmaps,
                 params: SearchParams, entry, entry_d, st: SearchStats,
                 ef_result: int):
    """The legacy beam loop.  Returns (W_d, W_id) sorted ascending and the
    stats."""
    qn = queries.shape[0]
    dev = queries.device
    strat = params.strategy
    quant = params.graph_quant
    ppv = _ppv(store, quant)
    deg = graph.neighbors.shape[2]
    tm_on = params.translation_map
    seed_ok = probe_batch(bitmaps, entry[:, None])[:, 0] \
        | (strat in ("unfiltered", "iterative_scan"))
    s = _init_lanes(graph, entry, entry_d, st, params, ef_result, seed_ok)
    pool_d, pool_id, w_d, w_id, visited, st, done = (
        s.pool_d, s.pool_id, s.w_d, s.w_id, s.visited, s.st, s.done)
    we_idx = params.ef_search - 1 if ef_result >= params.ef_search \
        else ef_result - 1
    inf = torch.tensor(INF, device=dev)
    while not bool(done.all()):
        best_d, best_id, pd, pi = _pop(pool_d, pool_id)
        w_worst = w_d[:, we_idx]
        stop = (best_d > w_worst) | torch.isinf(best_d) | \
            (st.hops >= params.max_hops)
        over = _budget_over(st, params, store.dim)
        if over is not None:
            stop = stop | over
        run = ~done & ~stop
        e = _expand(graph, store, queries, bitmaps, best_id.clamp(min=0),
                    visited, two_hop=strat in ("acorn", "navix"), quant=quant)
        zero = torch.zeros(qn, dtype=torch.int64, device=dev)
        dc, fc, pai, pah, tm = zero, zero, zero + 1, zero, zero
        if strat in ("unfiltered", "iterative_scan", "sweeping"):
            score_m = e["unv1"]
            n_s = score_m.sum(1)
            dc, pah = dc + n_s, pah + n_s * ppv
            cd = torch.where(score_m, e["d1"], inf)
            cid = torch.where(score_m, e["nb1"], torch.full_like(e["nb1"], -1))
            pd, pi = _pool_insert(pd, pi, cd, cid)
            _mark(visited, e["nb1"], score_m & run[:, None])
            if strat == "sweeping":
                would = score_m & (cd < w_worst[:, None])
                n_w = would.sum(1)
                fc = fc + n_w
                if tm_on:
                    tm = tm + n_w
                else:
                    pai = pai + n_w
                enter = would & e["pass1"]
                wd = torch.where(enter, cd, inf)
                wid = torch.where(enter, cid, torch.full_like(cid, -1))
            else:
                wd, wid = cd, cid
            wd2, wi2 = _insert_sorted(w_d, w_id, wd, wid)
        else:
            v1, nb1 = e["v1"], e["nb1"]
            n1 = v1.sum(1)
            fc = fc + n1
            if tm_on:
                tm = tm + n1
            else:
                pai = pai + n1
            pass1 = e["pass1"] & v1
            local_sel = pass1.sum(1) / n1.clamp(min=1)
            false = torch.zeros(qn, dtype=torch.bool, device=dev)
            do_directed, do_twohop_all = false, ~false
            if strat == "navix":
                h = params.navix_heuristic
                if h == "directed":
                    do_directed, do_twohop_all = ~false, false
                elif h == "onehop":
                    do_twohop_all = false
                elif h != "blind":       # adaptive-local (paper §2.3.4)
                    sel32 = local_sel.to(torch.float32)
                    do_directed = (sel32 > 0.08) & (sel32 <= 0.35)
                    do_twohop_all = sel32 <= 0.08
            s1 = pass1 & e["unv1"]
            n_s1 = s1.sum(1)
            dc, pah = dc + n_s1, pah + n_s1 * ppv
            cd1 = torch.where(s1, e["d1"], inf)
            cid1 = torch.where(s1, nb1, torch.full_like(nb1, -1))
            expand = v1
            if params.adaptive_skip_2hop:
                expand = expand & ~pass1
            if strat == "navix" and params.navix_heuristic in ("directed",
                                                               "adaptive"):
                rank = torch.sort(torch.where(v1, e["d1"], inf), dim=1,
                                  stable=True).indices
                topr = torch.zeros_like(v1).scatter(
                    1, rank[:, :max(1, deg // 4)], True)
                expand = torch.where(do_twohop_all[:, None], expand,
                                     do_directed[:, None] & expand & topr)
                extra = torch.where(do_directed, (v1 & ~s1).sum(1), zero)
                dc, pah = dc + extra, pah + extra * ppv
            elif strat == "navix" and params.navix_heuristic == "onehop":
                expand = torch.zeros_like(expand)
            pai = pai + expand.sum(1)
            m2 = e["v2"] & expand[:, :, None]
            n2 = m2.sum((1, 2))
            fc = fc + n2
            if tm_on:
                tm = tm + n2
            else:
                pai = pai + n2
            s2 = m2 & e["pass2"] & e["unv2"]
            n_s2 = s2.sum((1, 2))
            dc, pah = dc + n_s2, pah + n_s2 * ppv
            cd = torch.cat([cd1, torch.where(s2, e["d2"], inf)
                            .reshape(qn, -1)], 1)
            cid = torch.cat([cid1, torch.where(s2, e["nb2"], torch.full_like(
                e["nb2"], -1)).reshape(qn, -1)], 1)
            uniq = _dedup_first(cid)
            cd = torch.where(uniq, cd, inf)
            cid = torch.where(uniq, cid, torch.full_like(cid, -1))
            pd, pi = _pool_insert(pd, pi, cd, cid)
            _mark(visited, cid, (cid >= 0) & run[:, None])
            wd2, wi2 = _insert_sorted(w_d, w_id, cd, cid)
        st2 = _count(st, torch.ones_like(run), dc, fc, pai, pah, tm)
        frozen = ~run
        pool_d, pool_id = _keep(frozen, pool_d, pd), _keep(frozen, pool_id, pi)
        w_d, w_id = _keep(frozen, w_d, wd2), _keep(frozen, w_id, wi2)
        st = _keep_stats(frozen, st, st2)
        done = done | stop
    return w_d, w_id, st


def _legacy_iterative(graph: HNSWGraph, store: VectorStore, queries,
                      bitmaps, params: SearchParams, entry, entry_d,
                      st: SearchStats):
    """The legacy iterative scan (pgvector 0.8.0 resumable post-filter):
    unfiltered traversal, the emitted batch post-filtered, the scan
    extended until k rows pass.  Returns (dists, ids, stats, reranked
    rows or None)."""
    qn = queries.shape[0]
    dev = queries.device
    quant = params.graph_quant
    ppv = _ppv(store, quant)
    efmax = params.batch_tuples * params.max_rounds
    tm_on = params.translation_map
    s = _init_lanes(graph, entry, entry_d, st, params, efmax,
                    torch.ones(qn, dtype=torch.bool, device=dev))
    pool_d, pool_id, w_d, w_id, visited, st, done = (
        s.pool_d, s.pool_id, s.w_d, s.w_id, s.visited, s.st, s.done)
    eff = torch.full((qn,), params.batch_tuples, dtype=torch.int64,
                     device=dev)
    rnd = torch.zeros(qn, dtype=torch.int64, device=dev)
    checked = torch.zeros(qn, dtype=torch.int64, device=dev)
    inf = torch.tensor(INF, device=dev)
    cols = torch.arange(efmax, device=dev)[None, :]
    while not bool(done.all()):
        live = ~done
        best_d, best_id, pd, pi = _pop(pool_d, pool_id)
        w_worst = torch.gather(w_d, 1, (eff.clamp(max=efmax) - 1)[:, None])[
            :, 0]
        over = _budget_over(st, params, store.dim)
        batch_done = (best_d > w_worst) | torch.isinf(best_d) | \
            (st.hops >= params.max_hops)
        if over is not None:
            batch_done = batch_done | over
        # resume / emit: filter the batch, maybe extend the scan
        n_pass = (probe_batch(bitmaps, w_id) & (cols < eff[:, None])
                  & (w_id >= 0)).sum(1)
        newly = (eff.clamp(max=efmax) - checked).clamp(min=0)
        fc_emit = torch.where(batch_done, newly, torch.zeros_like(newly))
        exhausted = torch.isinf(best_d) | (st.hops >= params.max_hops) | \
            (rnd + 1 >= params.max_rounds)
        if over is not None:
            exhausted = exhausted | over
        finish = batch_done & ((n_pass >= params.k) | exhausted)
        extend = batch_done & ~finish
        eff2 = torch.where(extend, eff + params.batch_tuples, eff)
        rnd2 = torch.where(extend, rnd + 1, rnd)
        checked2 = torch.where(batch_done, eff.clamp(max=efmax), checked)
        # expansion, applied only when the batch is not done
        e = _expand(graph, store, queries, bitmaps, best_id.clamp(min=0),
                    visited, two_hop=False, quant=quant)
        score_m = e["unv1"]
        n_s = score_m.sum(1)
        cd = torch.where(score_m, e["d1"], inf)
        cid = torch.where(score_m, e["nb1"], torch.full_like(e["nb1"], -1))
        pd, pi = _pool_insert(pd, pi, cd, cid)
        _mark(visited, e["nb1"], score_m & (live & ~batch_done)[:, None])
        wd2, wi2 = _insert_sorted(w_d, w_id, cd, cid)
        step = _i32(~batch_done)
        zero = torch.zeros_like(fc_emit)
        st2 = SearchStats(
            st.distance_comps + _masked(~batch_done, n_s),
            st.filter_checks + _i32(fc_emit),
            st.hops + step,
            st.page_accesses_index + step + _i32(zero if tm_on else fc_emit),
            st.page_accesses_heap + _masked(~batch_done, n_s * ppv),
            st.tmap_lookups + _i32(fc_emit if tm_on else zero),
            st.reorder_rows)
        frozen = done | batch_done
        pool_d, pool_id = _keep(frozen, pool_d, pd), _keep(frozen, pool_id, pi)
        w_d, w_id = _keep(frozen, w_d, wd2), _keep(frozen, w_id, wi2)
        st = _keep_stats(done, st, st2)
        eff, rnd = _keep(done, eff, eff2), _keep(done, rnd, rnd2)
        checked = _keep(done, checked, checked2)
        done = done | (live & finish)
    return _iter_finish(store, queries, bitmaps, params, w_d, w_id, eff, st)


def _search_batch(graph: HNSWGraph, store: VectorStore, queries,
                  bitmaps, params: SearchParams, excl=None,
                  collect_trace: bool = False):
    """Zoom-in, the chosen engine's loop, the SQ8 rerank and the final
    top-k; the trace dict comes fourth when `collect_trace`."""
    if params.graph_exec_mode == "frontier":
        state = _init_state(graph, store, queries, bitmaps, params,
                            collect_trace, None)
        state = _advance(graph, store, state, params, excl=excl)
        dk, ids, st, trace = _harvest(store, state, params)
        return (dk, ids, st) if trace is None else (dk, ids, st, trace)
    quant = params.graph_quant
    entry, entry_d, st = _zoom_in(graph, store, queries, quant)
    if params.strategy == "iterative_scan":
        dk, ids, st, _ = _legacy_iterative(graph, store, queries, bitmaps,
                                           params, entry, entry_d, st)
    else:
        w_d, w_id, st = _legacy_base(graph, store, queries, bitmaps, params,
                                     entry, entry_d, st, params.ef_search)
        if quant == "sq8" and params.sq8_rerank:
            w_d, st = _rerank_beam(store, queries, w_id, st)
        dk, ids = _finalize(w_d, w_id, bitmaps, params.k,
                            check_filter=params.strategy != "unfiltered")
    return dk, ids.to(torch.int32), st


def _check_tier(store: VectorStore, params: SearchParams) -> None:
    if params.graph_quant not in GRAPH_QUANT_MODES:
        raise ValueError(f"unknown graph_quant {params.graph_quant!r}; "
                         f"expected one of {GRAPH_QUANT_MODES}")
    if params.graph_quant == "sq8" and not store.has_sq8:
        raise ValueError("graph_quant='sq8' needs an SQ8 shadow store; "
                         "build it with core.types.quantize_store")
    if params.strategy not in ("unfiltered", "sweeping", "acorn", "navix",
                               "iterative_scan"):
        raise ValueError(f"unknown graph strategy {params.strategy!r}")


def search_batch(graph: HNSWGraph, store: VectorStore, queries: torch.Tensor,
                 bitmaps: torch.Tensor, params: SearchParams,
                 excl: QueryRadii | None = None,
                 collect_trace: bool = False):
    """Batched filtered graph search.  queries (Q, d), bitmaps (Q, W)
    int32.  Returns (dists (Q, k), ids (Q, k) int32, SearchStats with (Q,)
    counters).

    `params.graph_exec_mode` picks the engine: "frontier" (the superstep
    engine, through the frontier kernels) or "vmapped" (the legacy
    per-query loop, its equivalence oracle).
    `params.graph_quant="sq8"` navigates over the store's SQ8 shadow
    (`types.quantize_store`) and re-scores the final beam exactly.
    `params.exclusion` "prune" / "prune_exact" (sweeping, l2) needs
    `excl`, the batch's QueryRadii (`exclusion.select_radii`).
    `collect_trace=True` (frontier engine) adds a fourth element, the
    storage trace `{"heap_steps": (Q, n) int32, "index_steps": (Q, n)
    int32}` of first-touch superstep stamps (TRACE_UNTOUCHED where never
    touched), plus `"rerank_rows"` ((Q, r) int32, -1 padded, candidate
    order) on the SQ8 tier; ids, dists and stats are the same with the
    flag on or off."""
    _check_tier(store, params)
    if params.exclusion not in ("none", "prune", "prune_exact"):
        raise ValueError(f"unknown exclusion {params.exclusion!r}; "
                         "expected 'none', 'prune' or 'prune_exact'")
    if params.exclusion != "none":
        if excl is None:
            raise ValueError(f"exclusion={params.exclusion!r} needs "
                             "per-query radii (excl=QueryRadii; "
                             "core.exclusion.select_radii)")
        if params.strategy != "sweeping":
            raise ValueError("exclusion pruning is a sweeping-strategy "
                             f"tier (got strategy={params.strategy!r})")
        if store.metric != "l2":
            raise ValueError("exclusion pruning requires metric='l2' "
                             f"(got {store.metric!r})")
        if params.graph_exec_mode != "frontier":
            raise ValueError("exclusion pruning needs the frontier engine "
                             "(graph_exec_mode='frontier')")
        if not params.exclusion_margin > 0.0:
            raise ValueError("exclusion_margin must be > 0 (0 would prune "
                             "everything once W fills)")
    elif excl is not None:
        raise ValueError("excl radii passed but params.exclusion='none'")
    if params.graph_exec_mode == "vmapped":
        if collect_trace:
            raise ValueError("storage traces need the frontier engine "
                             "(graph_exec_mode='frontier')")
    elif params.graph_exec_mode != "frontier":
        raise ValueError(f"unknown graph_exec_mode {params.graph_exec_mode!r}"
                         "; expected 'frontier' or 'vmapped'")
    return _search_batch(graph, store, queries, bitmaps, params, excl,
                         collect_trace)
