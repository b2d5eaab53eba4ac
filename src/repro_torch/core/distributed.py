"""Mesh-sharded filtered vector search (DESIGN.md §4, §13).

Two tiers scale out over S shards:

* **ScaNN** shards *leaves*: shard s owns leaves [s * Lp, (s + 1) * Lp)
  of the leaf table padded to a multiple of S.  Each shard scores its own
  centroids, opens ceil(nl / S) of its leaves, scans them with the fused
  `leaf_scan` kernel, reranks its candidates against the full-precision
  rows and keeps a local top-k.  The only collective is an all-gather of
  the (S x k) (dist, id) pairs (and the (Q, 7) counters), then a
  replicated final top-k.  Index construction is data-parallel Lloyd's:
  local assignment, summed centroid sums and counts.
* **The graph** shards its row-indexed state (the adjacency of every
  level, the f32 heap, the SQ8 shadow and one buffer pool a shard) by
  contiguous row range, seen through the `ShardGraph` / `ShardStore`
  views (`core.shardtypes`), whose reads `core.graph_search` resolves by
  ownership and a shard collective:

  - beam_exchange_interval == 1 (lockstep): the lane state is held once
    and only the reads go shard by shard; the owner-masked `min` / `max`
    select the owner's untouched value, so ids, dists and all seven
    counters equal the one-device engine's bit for bit at any S, by
    construction;
  - beam_exchange_interval == E > 1 (drift): each shard traverses its own
    induced subgraph (remote adjacency -1, remote distances +inf) for E
    supersteps, then `graph_search.beam_exchange` gathers the beams and
    re-seeds every shard from the global top-ef: cheaper collectives,
    approximate results.

The shard body is written once against the shard collectives
(`core.collectives`) and runs two ways, as the reference's body runs under
`jax.vmap(..., axis_name=)` and under `shard_map`: stacked, every shard in
one process (`ShardedGraphExecutor`, `DistributedScannExecutor` on a mesh
with no process group; the one-card path), or one shard per rank of a
`torch.distributed` process group (`sharded_graph_search_fn`, and the
ScaNN executor on a mesh that carries a group).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core import graph_search as gs
from repro_torch.core.collectives import GroupShards, StackedShards
from repro_torch.core.hnsw import HNSWGraph
from repro_torch.core.scann import (ScannIndex, _quant_pages_per_leaf,
                                    build_scann, project_query)
from repro_torch.core.shardtypes import ShardGraph, ShardStore
from repro_torch.core.types import (SearchParams, SearchResult, SearchStats,
                                    VectorStore, check_store_device, distance,
                                    heap_pages_per_vector, topk_smallest)
from repro_torch.kernels import ops
from repro_torch.storage.bufferpool import BufferPoolState
from repro_torch.storage.engine import StorageStats, merge_storage_stats

INF = float("inf")


def _collectives(mesh, num_shards: int):
    """The shard collectives of a mesh: its process group's, or the
    stacked emulation of `num_shards` shards in this process."""
    group = getattr(mesh, "group", None) if mesh is not None else None
    if group is None:
        return StackedShards(num_shards)
    coll = GroupShards(group)
    if coll.num_shards != num_shards:
        raise ValueError(f"process group has {coll.num_shards} ranks for "
                         f"{num_shards} shards")
    return coll


def _stats_stack(stats: SearchStats) -> torch.Tensor:
    return torch.stack([getattr(stats, f.name)
                        for f in dataclasses.fields(SearchStats)], -1)


def _stats_of(block: torch.Tensor) -> SearchStats:
    return SearchStats(*(block[..., i] for i in range(7)))


# ===========================================================================
# The ScaNN tier: leaves sharded over the mesh axis
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class ShardedFVS:
    """A ScaNN index whose leaf table is padded to a multiple of the mesh
    axis: shard d owns leaves [d * Lp, (d + 1) * Lp).  The heap keeps
    global row ids."""

    index: ScannIndex
    store: VectorStore
    mesh: Any
    axis: str

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.axis])


def shard_index(index: ScannIndex, store: VectorStore, mesh,
                axis: str) -> ShardedFVS:
    """Pad the leaf count to a multiple of the axis size: padded leaves
    have rowids -1 and +inf centroids, so no query opens a row of them."""
    nd = int(mesh.shape[axis])
    pad = (-index.num_leaves) % nd
    if pad:
        def grow(t, value):
            fill = torch.full((pad,) + tuple(t.shape[1:]), value,
                              dtype=t.dtype, device=t.device)
            return torch.cat([t, fill])
        index = dataclasses.replace(
            index, leaf_tiles=grow(index.leaf_tiles, 0),
            leaf_rowids=grow(index.leaf_rowids, -1),
            leaf_centroids=grow(index.leaf_centroids, INF),
            row_norms_sq=grow(index.row_norms_sq, 0))
    return ShardedFVS(index=index, store=store, mesh=mesh, axis=axis)


def distributed_search_fn(sharded: ShardedFVS, params: SearchParams,
                          heap_layout: str = "replicated",
                          with_stats: bool = False):
    """The sharded filtered search bound to a store: (queries (Q, d),
    bitmaps (Q, W)) -> (dists (Q, k), ids (Q, k) int32[, stats (Q, 7)
    int32 in SearchStats field order]).

    Each shard held here (all of them on a mesh without a process group,
    this rank's on one with) scores its centroids with `distance`, opens
    ceil(nl / S) leaves and scans them with the `leaf_scan` kernel: one
    launch for every held shard's slots, leaf id s * Lp + local (the
    kernel's scores do not depend on the slots' order).  It reranks its
    top k * reorder_factor candidates exactly and keeps a local top-k; the
    (S x k) pairs are gathered and a final top-k is taken.

    heap_layout: "replicated" (every shard reads the whole f32 heap) or
    "leaf_ordered" (rows in leaf-major order, shard s holding rows [s * n
    / S, (s + 1) * n / S): a candidate outside them is dropped).
    with_stats adds the per-query Table-6 counters, each shard's local
    work summed over shards: distance comps = passing rows + finite
    centroids + reordered rows, filter checks = valid rows of the opened
    leaves, hops = leaves opened, index pages = leaves x pages a leaf,
    heap pages = reordered rows x pages a row."""
    if heap_layout not in ("replicated", "leaf_ordered"):
        raise ValueError(f"unknown heap_layout {heap_layout!r}; expected "
                         "'replicated' or 'leaf_ordered'")
    idx, store = sharded.index, sharded.store
    S = sharded.num_shards
    coll = _collectives(sharded.mesh, S)
    held = coll.local
    L, C, dp = idx.leaf_tiles.shape
    Lp = L // S
    k = params.k
    nsel = min(max(1, -(-params.num_leaves_to_search // S)), Lp)
    r = min(k * params.reorder_factor, nsel * C)
    qppl = _quant_pages_per_leaf(idx)
    ppv = heap_pages_per_vector(store.dim)
    n_total = store.n
    rows_per = n_total // S if heap_layout == "leaf_ordered" else n_total
    dev = idx.leaf_tiles.device
    held_t = torch.as_tensor(held, dtype=torch.int64, device=dev)
    cents = idx.leaf_centroids.reshape(S, Lp, dp)[held_t]     # (s, Lp, dp)
    cnorm = (cents * cents).sum(-1)
    cent_fin = torch.isfinite(cents[:, :, 0]).sum(1)           # (s,)

    def search(queries: torch.Tensor, bitmaps: torch.Tensor):
        qn = queries.shape[0]
        ns = len(held)
        qp = project_query(idx, queries)                        # (Q, dp)
        cd = distance(idx.metric, qp[:, None, None, :], cents[None],
                      cnorm[None])                              # (Q, s, Lp)
        cd = torch.where(torch.isfinite(cents[None, :, :, 0]), cd,
                         torch.full_like(cd, INF))
        _, local = topk_smallest(cd, nsel)                      # (Q, s, nsel)
        leaves = local + (held_t * Lp)[None, :, None]
        scores = ops.leaf_scan_ids(
            qp, leaves.reshape(qn, ns * nsel), idx.leaf_tiles,
            idx.leaf_rowids, idx.scale, idx.mean, bitmaps,
            idx.metric).reshape(qn, ns, nsel * C)
        rowids = idx.leaf_rowids[leaves].to(torch.int64).reshape(
            qn, ns, nsel * C)
        fs, fp = topk_smallest(scores, r)                       # (Q, s, r)
        rows = torch.gather(rowids, 2, fp)
        ok = torch.isfinite(fs) & (rows >= 0)
        if heap_layout == "leaf_ordered":
            offs = (held_t * rows_per)[None, :, None]
        else:
            offs = torch.zeros_like(held_t)[None, :, None]
        lrows = rows - offs
        ok = ok & (lrows >= 0) & (lrows < rows_per)
        safe = lrows.clamp(0, rows_per - 1) + offs
        exact = distance(store.metric, queries[:, None, None, :],
                         store.vectors[safe], store.norms_sq[safe])
        exact = torch.where(ok, exact, torch.full_like(exact, INF))
        ld, lp = topk_smallest(exact, k)                        # (Q, s, k)
        # ids cross the mesh as int32, as the reference's do
        lids = torch.where(torch.isinf(ld), torch.full_like(lp, -1),
                           torch.gather(rows, 2, lp)).to(torch.int32)
        gd = coll.all_gather(ld.permute(1, 0, 2).contiguous())  # (S, Q, k)
        gi = coll.all_gather(lids.permute(1, 0, 2).contiguous())
        gd = gd.permute(1, 0, 2).reshape(qn, -1)
        gi = gi.permute(1, 0, 2).reshape(qn, -1)
        fd, fpos = topk_smallest(gd, k)
        fids = torch.where(torch.isinf(fd), torch.full_like(fpos, -1,
                                                            dtype=gi.dtype),
                           torch.gather(gi, 1, fpos))
        if not with_stats:
            return fd, fids
        n_reorder = ok.sum(2)
        st = torch.stack([
            torch.isfinite(scores).sum(2) + cent_fin[None] + n_reorder,
            (rowids >= 0).sum(2),
            torch.full_like(n_reorder, nsel),
            torch.full_like(n_reorder, nsel * qppl),
            n_reorder * ppv,
            torch.zeros_like(n_reorder),
            n_reorder], -1).to(torch.int32)                    # (Q, s, 7)
        return fd, fids, coll.sum(st.permute(1, 0, 2).contiguous())

    return search


def distributed_kmeans_fn(mesh, axis: str, k: int, iters: int,
                          metric: str = "l2"):
    """(x (N, d), init_cent (k, d)) -> centroids: data-parallel Lloyd's.
    The rows split into S contiguous blocks of N / S; each shard held here
    assigns its block to the nearest centroid (squared l2, first minimum),
    sums its rows and counts per centroid (`index_add_`, not a one-hot
    product: at 1M x 2,000 that one-hot alone is 8 GB), and the sums and
    counts are summed over shards.  A centroid no row chose keeps its
    place.  The sums accumulate in float64: in float32 the order of the
    additions (the shard split, the card's atomics) moves a centroid by a
    few ulp, which flips near-tied assignments, and Lloyd's iterations
    grow those flips (1M rows, k = 256: 1.1e-3 between S = 1 and 4 after 5
    iterations on an H100); in float64 the rounded float32 centroids do
    not depend on the order."""
    S = int(mesh.shape[axis])
    coll = _collectives(mesh, S)

    def fn(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
        n, d = x.shape
        if n % S:
            raise ValueError(f"{n} rows do not split into {S} shards")
        blocks = [x[s * (n // S):(s + 1) * (n // S)] for s in coll.local]
        xn = [(b * b).sum(1) for b in blocks]
        wide = [b.to(torch.float64) for b in blocks]
        for _ in range(iters):
            sums, cnts = [], []
            cn = (cent * cent).sum(1)
            for b, bn, bw in zip(blocks, xn, wide):
                a = torch.argmin(bn[:, None] + cn[None] - 2.0 * (b @ cent.T),
                                 1)
                sums.append(torch.zeros(cent.shape, dtype=torch.float64,
                                        device=cent.device).index_add_(
                    0, a, bw))
                cnts.append(torch.bincount(a, minlength=k))
            tot = coll.sum(torch.stack(sums))
            cnt = coll.sum(torch.stack(cnts))
            newc = (tot / cnt.clamp(min=1)[:, None]).to(cent.dtype)
            cent = torch.where((cnt > 0)[:, None], newc, cent)
        return cent

    return fn


def build_sharded_scann(store: VectorStore, mesh, axis: str,
                        num_leaves: int, device="cuda", **kw) -> ShardedFVS:
    """`build_scann` on `device` (the store must live there), then its
    leaves sharded over the mesh axis."""
    idx = build_scann(store, num_leaves=num_leaves, device=device, **kw)
    return shard_index(idx, store, mesh, axis)


class DistributedScannExecutor:
    """Executor of the sharded ScaNN path (DESIGN.md §6): consumers
    (`serving/rag.py`) hold an executor and never touch the mesh.  The
    per-query counters ride the same gather as the (dist, id) pairs
    (`with_stats`)."""

    name = "scann_distributed"

    def __init__(self, sharded: ShardedFVS, heap_layout: str = "replicated",
                 with_stats: bool = True):
        self.sharded = sharded
        self.store = sharded.store
        self.heap_layout = heap_layout
        self.with_stats = with_stats
        self._fns: dict = {}

    def plan(self, queries, bitmaps, params: SearchParams):
        from repro_torch.core.executor import SearchPlan
        if params.strategy != "scann":
            params = dataclasses.replace(params, strategy="scann")
        return SearchPlan("scann", params, queries, bitmaps)

    def execute(self, plan) -> SearchResult:
        fn = self._fns.get(plan.params)
        if fn is None:
            fn = self._fns[plan.params] = distributed_search_fn(
                self.sharded, plan.params, heap_layout=self.heap_layout,
                with_stats=self.with_stats)
        out = fn(plan.queries, plan.bitmaps)
        stats = None
        if self.with_stats:
            d, ids, st = out
            stats = _stats_of(st)
        else:
            d, ids = out
        return SearchResult(dists=d, ids=ids, stats=stats, strategy="scann",
                            plan=plan)

    def search(self, queries, bitmaps, params: SearchParams) -> SearchResult:
        return self.execute(self.plan(queries, bitmaps, params))


# ===========================================================================
# The graph and storage tiers: row-indexed state sharded by row range
# ===========================================================================

def shard_graph_tiers(graph: HNSWGraph, store: VectorStore, num_shards: int,
                      f32: bool = True):
    """Partition the adjacency and heap tiers by contiguous row range.

    Returns (ShardGraph, ShardStore) views of every shard, held stacked in
    this process (`StackedShards(num_shards)`): shard
    s owns global rows [s * rps, (s + 1) * rps), rps = ceil(n / S), the
    last block zero / -1 padded.  When S divides n the blocks are reshape
    views of the graph's and store's tensors (no copy).  Adjacency values
    stay GLOBAL row ids.  `f32=False` leaves the full-precision tier out
    (SQ8-only traversal)."""
    n = graph.n
    if store.n != n:
        raise ValueError(f"graph ({n} rows) and store ({store.n} rows) "
                         "disagree")
    S = int(num_shards)
    if S < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    rps = -(-n // S)
    pad = S * rps - n
    coll = StackedShards(S)

    def block(t, fill, axis=0):
        if pad:
            shape = list(t.shape)
            shape[axis] = pad
            t = torch.cat([t, torch.full(shape, fill, dtype=t.dtype,
                                         device=t.device)], axis)
        shape = list(t.shape)
        return t.reshape(shape[:axis] + [S, rps] + shape[axis + 1:])

    levels = graph.node_level.cpu().numpy()
    local_entry = []
    for s in range(S):
        lo, hi = s * rps, min((s + 1) * rps, n)
        local_entry.append(lo + int(np.argmax(levels[lo:hi]))
                           if lo < hi else -1)
    gv = ShardGraph(neighbors=block(graph.neighbors, -1, axis=1),
                    entry_point=int(graph.entry_point),
                    local_entry=tuple(local_entry), shards=tuple(range(S)),
                    n_total=n, coll=coll, m=graph.m)
    has_f32 = f32 and store.vectors is not None
    has_q = store.q_vectors is not None
    sv = ShardStore(
        vectors=block(store.vectors, 0) if has_f32 else None,
        norms_sq=block(store.norms_sq, 0) if has_f32 else None,
        shards=tuple(range(S)), n_total=n, coll=coll, metric=store.metric,
        q_vectors=block(store.q_vectors, 0) if has_q else None,
        q_scale=store.q_scale if has_q else None,
        q_mean=store.q_mean if has_q else None,
        q_norms_sq=block(store.q_norms_sq, 0) if has_q else None)
    return gv, sv


def _sum_stats(coll, parts: list[SearchStats]) -> SearchStats:
    return _stats_of(coll.sum(torch.stack([_stats_stack(p)
                                           for p in parts])))


def _graph_shard_body(gv: ShardGraph, sv: ShardStore, queries, bitmaps,
                      params: SearchParams, collect_trace: bool):
    """The program of the shards held here, over their collective views.

    Lockstep (E <= 1): the frontier engine once, on one lane state; its
    counters are already the one-device ones (summing them over shards
    would multiply them by S).  Drift (E > 1): one lane state per held
    shard, each zoomed in from its shard's `local_entry` on a
    non-collective view; rounds of E supersteps and a `beam_exchange`,
    bounded by the gathered `done`; the finalize on the COLLECTIVE views
    (the beam now holds remote rows, whose true payloads the SQ8 rerank
    must read).  The stats are the per-shard traversal counters summed
    over shards plus the finalize's delta (the same on every shard),
    added once."""
    E = params.beam_exchange_interval
    if E <= 1:
        return gs._search_batch(gv, sv, queries, bitmaps, params, None,
                                collect_trace)
    coll = gv.coll
    views = [(gv.select(i, collective=False, local_entry=True),
              sv.select(i, collective=False))
             for i in range(len(gv.shards))]
    states = [gs.frontier_init(g, s, queries, bitmaps, params)
              for g, s in views]
    rounds = -(-params.max_hops // E)
    t = 0
    while t < rounds and not bool(coll.all_gather(
            torch.stack([st.done for st in states])).all()):
        states = [gs.step_supersteps(g, s, st, params, E)
                  for (g, s), st in zip(views, states)]
        states = gs.beam_exchange(sv, states, params, coll)
        t += 1
    d, ids, fstats, _ = gs.frontier_finalize(gv, sv, states[0], params)
    delta = _stats_of(_stats_stack(fstats) - _stats_stack(states[0].stats))
    return d, ids, _sum_stats(coll, [st.stats for st in states]) + delta


class ShardedStorageAccountant:
    """Per-shard buffer-pool replay (DESIGN.md §13).

    One `StorageEngine` (with its own pool) per shard, each over the
    GLOBAL page layout: shard s's pool only ever sees pages of its rows
    [lo, hi), so each is typically built with `capacity_frac / S`.
    `account_graph` replays each shard's slice of the lockstep trace (its
    row columns, read in place, no copy) through its shard's pool and
    merges the per-shard StorageStats; `last_per_shard` keeps the parts
    for per-shard hit rates."""

    def __init__(self, engines, n: int):
        if not engines:
            raise ValueError("need at least one per-shard engine")
        self.engines = list(engines)
        self.num_shards = len(self.engines)
        self.n = int(n)
        self.rows_per_shard = -(-self.n // self.num_shards)
        self.last_per_shard: list[StorageStats] | None = None

    @property
    def graph(self):
        return self.engines[0].graph

    @property
    def qheap(self):
        return self.engines[0].qheap

    def reset_cold(self) -> None:
        for e in self.engines:
            e.reset_cold()

    def state(self) -> BufferPoolState:
        """Aggregate residency: capacities, used and dirty pages sum; each
        segment's residency is the mean over shards (a row's pages live in
        one shard's pool only)."""
        states = [e.state() for e in self.engines]
        residency = {seg: float(np.mean([s.residency.get(seg, 0.0)
                                         for s in states]))
                     for seg in states[0].residency}
        dirty_by: dict[str, int] = {}
        for s in states:
            for seg, v in s.dirty_by_segment.items():
                dirty_by[seg] = dirty_by.get(seg, 0) + v
        return BufferPoolState(
            capacity=sum(s.capacity for s in states),
            used=sum(s.used for s in states),
            residency=residency,
            dirty=sum(s.dirty for s in states),
            dirty_by_segment=dirty_by)

    def account_graph(self, heap_steps, index_steps, rerank_rows=None,
                      quant: bool = False) -> StorageStats:
        parts = []
        for s, eng in enumerate(self.engines):
            lo = s * self.rows_per_shard
            hi = min(lo + self.rows_per_shard, self.n)
            rr = None
            if rerank_rows is not None:
                rr = torch.as_tensor(rerank_rows)
                rr = torch.where((rr >= lo) & (rr < hi), rr,
                                 torch.full_like(rr, -1))
            parts.append(eng.account_graph(heap_steps, index_steps,
                                           rerank_rows=rr, quant=quant,
                                           rows=(lo, hi)))
        self.last_per_shard = parts
        return merge_storage_stats(parts)


def make_sharded_storage(engines, n: int) -> ShardedStorageAccountant:
    """Wrap per-shard engines (one pool each, typically built with
    capacity_frac / num_shards) into the accounting facade."""
    return ShardedStorageAccountant(engines, n)


class ShardedGraphExecutor:
    """The five graph strategies over row-sharded tiers (DESIGN.md §13),
    every shard stacked in this process.

    GraphExecutor's surface (plan / execute / search and the stepped
    frontier delegates), so benchmarks and the continuous-batching server
    drive it unchanged.  In lockstep the lane state is held once (a
    one-device-shaped `FrontierState`) and only the reads go shard by
    shard: ids, dists and all seven counters equal `GraphExecutor`'s for
    any shard count.  The store must live on `device`."""

    def __init__(self, graph: HNSWGraph, store: VectorStore,
                 num_shards: int, strategy: str = "sweeping",
                 storage: ShardedStorageAccountant | None = None,
                 graph_quant: str = "none", f32: bool = True,
                 device="cuda"):
        check_store_device(store, device)
        if strategy not in costmodel.GRAPH_STRATEGIES:
            raise ValueError(f"unknown graph strategy {strategy!r}")
        if graph_quant not in ("none", "sq8"):
            raise ValueError(f"unknown graph_quant {graph_quant!r}")
        if graph_quant == "sq8" and store.q_vectors is None:
            raise ValueError("graph_quant='sq8' needs a quantize_store'd "
                             "VectorStore (SQ8 shadow missing)")
        if not f32:
            if graph_quant != "sq8":
                raise ValueError("f32=False (no full-precision tier) "
                                 "requires graph_quant='sq8'")
        if storage is not None:
            if storage.num_shards != num_shards:
                raise ValueError(
                    f"storage facade has {storage.num_shards} shards, "
                    f"executor has {num_shards}")
            if storage.graph is None:
                raise ValueError("storage engines lack a graph adjacency "
                                 "layout; build them with graph=")
            if graph_quant == "sq8" and storage.qheap is None:
                raise ValueError("storage engines lack the qheap (SQ8 "
                                 "shadow) segment")
        self.graph = graph
        self.store = store
        self.num_shards = int(num_shards)
        self.strategy = strategy
        self.storage = storage
        self.graph_quant = graph_quant
        self._f32 = f32
        self._gv, self._sv = shard_graph_tiers(graph, store, num_shards,
                                               f32=f32)
        base = strategy if graph_quant == "none" \
            else f"{strategy}_{graph_quant}"
        self.name = f"sharded{self.num_shards}_{base}"

    def resolve_params(self, params: SearchParams) -> SearchParams:
        """The executor's strategy and tier on the caller's params, plus
        the sharded mode's validations."""
        if params.strategy != self.strategy or \
                params.graph_quant != self.graph_quant:
            params = dataclasses.replace(params, strategy=self.strategy,
                                         graph_quant=self.graph_quant)
        if params.graph_exec_mode != "frontier":
            raise ValueError("the sharded executor runs the frontier "
                             "engine only (graph_exec_mode='frontier')")
        E = params.beam_exchange_interval
        if E < 1:
            raise ValueError(f"beam_exchange_interval must be >= 1, "
                             f"got {E}")
        if E > 1:
            if self.strategy == "iterative_scan":
                raise ValueError(
                    "drift mode (beam_exchange_interval > 1) drives the "
                    "base beam engine; iterative_scan's W is an emission "
                    "buffer, not a beam — run it lockstep "
                    "(beam_exchange_interval=1)")
            if self.storage is not None:
                raise ValueError(
                    "storage accounting needs the lockstep replicated "
                    "trace; set beam_exchange_interval=1")
        if not self._f32 and params.sq8_rerank:
            raise ValueError("no f32 tier to rerank from (f32=False); "
                             "set sq8_rerank=False")
        return params

    def _lockstep(self, params: SearchParams) -> SearchParams:
        params = self.resolve_params(params)
        if params.beam_exchange_interval > 1:
            raise ValueError("stepped serving runs lockstep only; drift "
                             "mode (beam_exchange_interval > 1) is "
                             "batch-path only")
        return params

    def plan(self, queries, bitmaps, params: SearchParams):
        from repro_torch.core.executor import SearchPlan
        return SearchPlan(self.strategy, self.resolve_params(params),
                          queries, bitmaps)

    def execute(self, plan) -> SearchResult:
        p = plan.params
        sstats = None
        if self.storage is None:
            d, ids, stats = _graph_shard_body(self._gv, self._sv,
                                              plan.queries, plan.bitmaps, p,
                                              False)
        else:
            d, ids, stats, trace = _graph_shard_body(
                self._gv, self._sv, plan.queries, plan.bitmaps, p, True)
            sstats = self.storage.account_graph(
                trace["heap_steps"], trace["index_steps"],
                rerank_rows=trace.get("rerank_rows"),
                quant=self.graph_quant == "sq8")
        return SearchResult(dists=d, ids=ids, stats=stats,
                            strategy=self.strategy, plan=plan,
                            storage=sstats,
                            anytime=costmodel.evaluate_anytime(
                                stats, p, self.store.dim, ids,
                                hop_cap=p.max_hops))

    def search(self, queries, bitmaps, params: SearchParams) -> SearchResult:
        return self.execute(self.plan(queries, bitmaps, params))

    # ---- the stepped frontier delegates (serving/continuous.py) --------

    def idle_frontier(self, params: SearchParams, width: int):
        return gs.frontier_idle(self._gv, self._sv, self._lockstep(params),
                                width, collect_trace=self.storage is not None)

    def init_frontier(self, queries, bitmaps, params: SearchParams,
                      deadlines=None):
        return gs.frontier_init(self._gv, self._sv, queries, bitmaps,
                                self._lockstep(params),
                                collect_trace=self.storage is not None,
                                deadlines=deadlines)

    def write_frontier_slot(self, state, lane, slot):
        return gs.frontier_write_slot(state, lane, slot)

    def step_frontier(self, state, params: SearchParams, n_hops: int,
                      dynamic_deadline: bool = False):
        return gs.step_supersteps(self._gv, self._sv, state,
                                  self._lockstep(params), n_hops,
                                  dynamic_deadline=dynamic_deadline)

    def finalize_frontier(self, state, params: SearchParams):
        return gs.frontier_finalize(self._gv, self._sv, state,
                                    self._lockstep(params))


def sharded_graph_search_fn(graph: HNSWGraph, store: VectorStore,
                            num_shards: int, params: SearchParams,
                            group=None):
    """The several-process path: the same shard body, one shard per rank
    of an initialized `torch.distributed` process group (`group`, the
    default one if None), each rank holding its own row block and reading
    the others' through all_reduce / all_gather.  Returns (queries,
    bitmaps) -> (dists, ids, SearchStats), the same on every rank and, in
    lockstep, equal to the stacked `ShardedGraphExecutor` bit for bit."""
    coll = GroupShards(group)
    if coll.num_shards != num_shards:
        raise ValueError(f"need {num_shards} ranks for {num_shards} "
                         f"shards, the group has {coll.num_shards}")
    gv, sv = shard_graph_tiers(graph, store, num_shards)
    gv = dataclasses.replace(gv.select(coll.rank, collective=True),
                             coll=coll)
    sv = dataclasses.replace(sv.select(coll.rank, collective=True),
                             coll=coll)

    def search(queries, bitmaps):
        return _graph_shard_body(gv, sv, queries, bitmaps, params, False)

    return search
