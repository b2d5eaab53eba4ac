"""Paged storage engine: layouts + buffer pool + per-batch accounting.

`StorageEngine` owns the page segments of the paged object model

    heap   full-precision vector rows        (pages.HeapLayout)
    scann  quantized ScaNN posting lists     (pages.ScannLeafLayout)
    graph  HNSW adjacency entries            (pages.GraphAdjacencyLayout)
    qheap  SQ8 shadow vector rows            (pages.HeapLayout, 1 B/dim)
    delta  mutable delta rows + tombstones   (pages.HeapLayout)
    wal    a ring of write-ahead-log pages

in one global page-id space behind one `BufferPool`.  Executors run their
searches with trace collection on (ids, dists and counters unchanged) and
hand the traces here; the engine turns object touches into page streams
through the layouts, runs them through the pool and returns a
`StorageStats`: measured logical accesses per query and the pool's
hit / miss / eviction split.

Accounting (the semantics the Table-6 counters are checked against):
  * scann "per_query": every query's opened leaves go through the pool, so
    measured logical index pages per query == nl x pages_per_leaf.
  * scann "batch": a leaf opened by several queries of a query tile is
    charged once, to the first; measured == the analytic batch counter.
  * heap (reorder, seqscan, graph fetches): per query, `pages_per_row`
    logical pages per fetched row; repeats across queries are hits.
  * graph traces are per-query first-touch superstep stamps (the hop count
    of the step that first fetched the object, TRACE_UNTOUCHED where
    never); within a query pages replay in (first-touch step, id) order.
    An object touched twice (zoom-in re-scores) is charged once, so graph
    measured <= analytic.
  * the SQ8 tier's traversal replays through "qheap" and its exact rerank
    through "heap", in candidate order.

The pool and the replay are host-side numpy, as in the reference.  Graph
traces may be (Q, n) CUDA tensors: `ordered_touches` orders each query's
touches on the tensor's device and moves only the ordered id lists to the
host (the raw stamps are gigabytes at a million rows).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.storage.bufferpool import BufferPool, BufferPoolState
from repro_torch.storage.faults import FaultInjector, FaultPlan
from repro_torch.storage.pages import (PAGE_BYTES, GraphAdjacencyLayout,
                                       HeapLayout, ScannLeafLayout)

SEGMENTS = ("heap", "scann", "graph", "qheap", "delta", "wal")

# first-touch sentinel of untouched objects: int32 max, as the search
# engines stamp it
TRACE_UNTOUCHED = int(np.iinfo(np.int32).max)


def ordered_touches(steps, block: int = 64) -> list[np.ndarray]:
    """Each query's touched object ids in replay order, sorted by
    (first-touch step, id).  steps (Q, n) int32 stamps, a tensor on any
    device or an array; the ordering runs on the tensor's device, `block`
    queries at a time."""
    t = torch.as_tensor(steps)
    out: list[np.ndarray] = []
    for s in range(0, t.shape[0], block):
        blk = t[s:s + block]
        row, col = torch.nonzero(blk < TRACE_UNTOUCHED, as_tuple=True)
        # nonzero is row-major, so ids ascend within a row; a stable sort
        # on (row, step) leaves them in (step, id) order
        key = row.to(torch.int64) * (1 << 32) + blk[row, col].to(torch.int64)
        ids = col[torch.sort(key, stable=True).indices].cpu().numpy()
        counts = torch.bincount(row, minlength=blk.shape[0]).cpu().numpy()
        out.extend(np.split(ids, np.cumsum(counts)[:-1]))
    return out


def passing_rows(bitmaps, n: int, block: int = 64) -> list[np.ndarray]:
    """Each query's passing row ids, ascending (the seqscan's fetch
    order), from (Q, W) packed int32 or uint32 words, a tensor on any
    device or an array."""
    if isinstance(bitmaps, np.ndarray):
        bitmaps = torch.as_tensor(np.ascontiguousarray(bitmaps).view(
            np.int32))
    out: list[np.ndarray] = []
    shifts = torch.arange(32, dtype=torch.int32, device=bitmaps.device)
    for s in range(0, bitmaps.shape[0], block):
        w = bitmaps[s:s + block].to(torch.int32)
        bits = (torch.bitwise_right_shift(w[:, :, None], shifts) & 1)
        bits = bits.reshape(w.shape[0], -1)[:, :n].to(torch.bool)
        row, col = torch.nonzero(bits, as_tuple=True)
        counts = torch.bincount(row, minlength=w.shape[0]).cpu().numpy()
        out.extend(np.split(col.cpu().numpy(), np.cumsum(counts)[:-1]))
    return out


@dataclasses.dataclass
class StorageStats:
    """Measured storage telemetry of one executor call."""

    logical: dict            # segment -> logical page accesses (batch sum)
    hits: dict               # segment -> pool hits
    misses: dict             # segment -> pool misses (physical reads)
    evictions: int
    index_pages: np.ndarray  # (Q,) scann-or-graph index pages charged
    heap_pages: np.ndarray   # (Q,) heap pages charged
    # segment -> distinct pages touched this batch (pool-independent);
    # unique / logical is the batch's page-sharing fraction
    unique: dict = dataclasses.field(default_factory=dict)
    retries: int = 0
    failed_reads: int = 0
    spikes: int = 0
    faulted: Optional[np.ndarray] = None      # (Q,) bool: saw a failed read

    @property
    def logical_total(self) -> int:
        return int(sum(self.logical.values()))

    @property
    def miss_total(self) -> int:
        return int(sum(self.misses.values()))

    @property
    def hit_rate(self) -> float:
        t = self.logical_total
        return float(sum(self.hits.values())) / t if t else 0.0

    def unique_fraction(self, segments=None) -> float:
        """Distinct / logical page fraction over `segments` (default all);
        1.0 means no page sharing inside the batch."""
        segs = segments if segments is not None else self.logical.keys()
        log = sum(self.logical.get(s, 0) for s in segs)
        unq = sum(self.unique.get(s, 0) for s in segs)
        return unq / log if log else 1.0

    def as_dict(self) -> dict:
        return dict(logical=dict(self.logical), hits=dict(self.hits),
                    misses=dict(self.misses), evictions=self.evictions,
                    hit_rate=round(self.hit_rate, 4),
                    unique=dict(self.unique),
                    retries=self.retries, failed_reads=self.failed_reads,
                    spikes=self.spikes,
                    faulted=(self.faulted.tolist()
                             if self.faulted is not None else None),
                    index_pages=self.index_pages.tolist(),
                    heap_pages=self.heap_pages.tolist())


def merge_storage_stats(parts: list[StorageStats]) -> StorageStats:
    """Sum per-part StorageStats into one batch total: counter dicts and
    per-query arrays add, fault flags OR."""
    if not parts:
        raise ValueError("merge_storage_stats needs at least one part")

    def dsum(key):
        out: dict = {}
        for p in parts:
            for seg, v in getattr(p, key).items():
                out[seg] = out.get(seg, 0) + v
        return out

    faulted = None
    if any(p.faulted is not None for p in parts):
        faulted = np.zeros_like(
            next(p.faulted for p in parts if p.faulted is not None))
        for p in parts:
            if p.faulted is not None:
                faulted |= p.faulted
    return StorageStats(
        logical=dsum("logical"), hits=dsum("hits"), misses=dsum("misses"),
        evictions=sum(p.evictions for p in parts),
        index_pages=sum(p.index_pages for p in parts),
        heap_pages=sum(p.heap_pages for p in parts),
        unique=dsum("unique"),
        retries=sum(p.retries for p in parts),
        failed_reads=sum(p.failed_reads for p in parts),
        spikes=sum(p.spikes for p in parts), faulted=faulted)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class StorageEngine:
    """Layouts + pool + accounting for one dataset's page space."""

    def __init__(self, heap: HeapLayout,
                 scann: Optional[ScannLeafLayout] = None,
                 graph: Optional[GraphAdjacencyLayout] = None,
                 capacity_pages: Optional[int] = None,
                 capacity_frac: float = 0.5, policy: str = "lru",
                 qheap: Optional[HeapLayout] = None,
                 faults: Optional[FaultPlan] = None,
                 delta: Optional[HeapLayout] = None,
                 wal_pages: int = 0):
        self.heap = heap
        self.scann = scann
        self.graph = graph
        self.qheap = qheap
        # the delta tier's rows, then the tombstone bitmap over the whole
        # id space (base + delta), in one segment; the WAL is a ring of
        # `wal_pages` pages
        self.delta = delta
        self.wal_pages = int(wal_pages)
        self._tomb_pages = 0
        if delta is not None:
            tomb_bytes = 4 * ((heap.n + delta.n + 31) // 32)
            self._tomb_pages = -(-tomb_bytes // PAGE_BYTES)
        # global page-id space: [heap | scann | graph | qheap | delta | wal]
        self._sizes = {"heap": heap.num_pages}
        if scann is not None:
            self._sizes["scann"] = scann.num_pages
        if graph is not None:
            self._sizes["graph"] = graph.num_pages
        if qheap is not None:
            self._sizes["qheap"] = qheap.num_pages
        if delta is not None:
            self._sizes["delta"] = delta.num_pages + self._tomb_pages
        if self.wal_pages > 0:
            self._sizes["wal"] = self.wal_pages
        self._base = {}
        off = 0
        for name, size in self._sizes.items():
            self._base[name] = off
            off += size
        self.total_pages = off
        if capacity_pages is None:
            capacity_pages = max(1, int(round(capacity_frac * off)))
        self.faults = faults
        injector = FaultInjector(faults) if (faults is not None
                                            and faults.active) else None
        self.pool = BufferPool(capacity_pages, policy=policy,
                               segments=self.segment_ranges(),
                               faults=injector)

    def segment_ranges(self) -> dict[str, tuple[int, int]]:
        return {name: (lo, lo + self._sizes[name])
                for name, lo in self._base.items()}

    def state(self) -> BufferPoolState:
        return self.pool.state(self.segment_ranges())

    def reset_cold(self) -> None:
        self.pool.reset()

    def _replay(self, streams) -> StorageStats:
        """Run per-query page streams through the pool: `streams` holds,
        per query, a list of (segment, page ids) in access order.  Heap-like
        segments accrue to the per-query heap counter, the others to the
        index counter."""
        q = len(streams)
        segs = sorted({s for per_q in streams for s, _ in per_q})
        log = dict.fromkeys(segs, 0)
        hit = dict.fromkeys(segs, 0)
        mis = dict.fromkeys(segs, 0)
        uniq: dict[str, set] = {s: set() for s in segs}
        ev = ret = fail = spk = 0
        idx_pages = np.zeros(q, np.int64)
        heap_pages = np.zeros(q, np.int64)
        faulted = np.zeros(q, bool)
        for i, per_q in enumerate(streams):
            for seg, pages in per_q:
                pages = np.asarray(pages)
                d = self.pool.access(self._base[seg] + pages)
                log[seg] += d.logical
                hit[seg] += d.hits
                mis[seg] += d.misses
                uniq[seg].update(pages.tolist())
                ev += d.evictions
                ret += d.retries
                fail += d.failed_reads
                spk += d.spikes
                if d.failed_reads:
                    faulted[i] = True
                if seg in ("heap", "qheap", "delta"):
                    heap_pages[i] += d.logical
                else:
                    idx_pages[i] += d.logical
        return StorageStats(log, hit, mis, ev, idx_pages, heap_pages,
                            unique={s: len(v) for s, v in uniq.items()},
                            retries=ret, failed_reads=fail, spikes=spk,
                            faulted=faulted)

    def account_scann(self, leaves, cand_rows, cand_ok,
                      accounting: str = "per_query",
                      query_block: int = 0) -> StorageStats:
        """leaves (Q, nl) opened per query, in rank order; cand_rows /
        cand_ok (Q, r) the reorder fetch.  `accounting` and `query_block`
        mirror SearchParams.scann_page_accounting / scann_query_block:
        under "batch" a leaf is charged once per query tile, to its first
        opener (the dedup window restarts at every tile boundary)."""
        if self.scann is None:
            raise ValueError("engine built without a scann layout")
        if accounting not in ("per_query", "batch"):
            raise ValueError(f"unknown accounting {accounting!r}")
        leaves = _np(leaves)
        cand_rows = _np(cand_rows)
        cand_ok = _np(cand_ok).astype(bool)
        streams = []
        seen: set[int] = set()
        for i in range(leaves.shape[0]):
            lv = leaves[i]
            if accounting == "batch":
                if query_block > 0 and i % query_block == 0:
                    seen.clear()              # new tile: fresh dedup window
                first = []
                for leaf in lv.tolist():
                    if leaf not in seen:
                        seen.add(leaf)
                        first.append(leaf)
                lv = np.array(first, np.int64)
            streams.append([
                ("scann", self.scann.pages_for_leaves(lv)),
                ("heap", self.heap.pages_for_rows(cand_rows[i][cand_ok[i]])),
            ])
        return self._replay(streams)

    def account_graph(self, heap_steps, index_steps, rerank_rows=None,
                      quant: bool = False) -> StorageStats:
        """The frontier engine's first-touch stamps: heap_steps (rows
        fetched during traversal) and index_steps (adjacency entries read),
        each (Q, n) int32, TRACE_UNTOUCHED where never touched.  `quant`
        (the SQ8 tier) replays the traversal's rows through "qheap", and
        `rerank_rows` ((Q, r), -1 padded, candidate order) charges the
        exact rerank's full-width fetches to "heap"."""
        if self.graph is None:
            raise ValueError("engine built without a graph layout")
        if quant and self.qheap is None:
            raise ValueError("engine built without a qheap (SQ8 shadow) "
                             "layout; build it from a quantize_store'd "
                             "store")
        row_seg = "qheap" if quant else "heap"
        row_layout = self.qheap if quant else self.heap
        itouch = ordered_touches(index_steps)
        htouch = ordered_touches(heap_steps)
        rr = None if rerank_rows is None else _np(rerank_rows)
        streams = []
        for i in range(len(htouch)):
            per_q = [("graph", self.graph.pages_for_nodes(itouch[i])),
                     (row_seg, row_layout.pages_for_rows(htouch[i]))]
            if rr is not None:
                per_q.append(("heap", self.heap.pages_for_rows(
                    rr[i][rr[i] >= 0])))
            streams.append(per_q)
        return self._replay(streams)

    def account_seqscan(self, bitmaps) -> StorageStats:
        """Bruteforce: every passing row fetched from the heap in row-id
        order.  bitmaps (Q, W) packed filter words."""
        streams = [[("heap", self.heap.pages_for_rows(rows))]
                   for rows in passing_rows(bitmaps, self.heap.n)]
        return self._replay(streams)

    # -- the write path: mutations go through the same pool as searches --

    def _require(self, seg: str):
        if seg not in self._base:
            raise ValueError(f"engine built without a {seg!r} segment "
                             f"(pass delta=/wal_pages= at construction)")

    def account_delta_scan(self, count: int,
                           num_queries: int) -> StorageStats:
        """Every query seq-scans the first `count` delta rows."""
        self._require("delta")
        rows = np.arange(int(count), dtype=np.int64)
        pages = self.delta.pages_for_rows(rows)
        streams = [[("delta", pages)] for _ in range(int(num_queries))]
        return self._replay(streams)

    def account_delta_write(self, local_rows: np.ndarray):
        """An insert batch: the touched delta row pages are dirtied."""
        self._require("delta")
        pages = self.delta.pages_for_rows(np.asarray(local_rows,
                                                     np.int64))
        return self.pool.access(self._base["delta"] + pages, dedup=True,
                                dirty=True)

    def account_tombstone_write(self, global_ids: np.ndarray):
        """A delete batch: the tombstone pages holding the ids' words are
        dirtied."""
        self._require("delta")
        ids = np.asarray(global_ids, np.int64)
        words = ids >> 5
        tomb_lo = self._base["delta"] + self.delta.num_pages
        pages = np.unique(tomb_lo + (words * 4) // PAGE_BYTES)
        return self.pool.access(pages, dedup=True, dirty=True)

    def _wal_range(self, offset: int, nbytes: int) -> np.ndarray:
        first = offset // PAGE_BYTES
        last = (offset + max(1, nbytes) - 1) // PAGE_BYTES
        ring = np.arange(first, last + 1) % self.wal_pages
        return self._base["wal"] + np.unique(ring)

    def account_wal_append(self, offset: int, nbytes: int):
        """One WAL record: its byte range's pages (on the ring) are
        dirtied."""
        self._require("wal")
        return self.pool.access(self._wal_range(offset, nbytes),
                                dedup=True, dirty=True)

    def account_wal_sync(self) -> int:
        """fsync: every dirty WAL page is written; returns the writes."""
        self._require("wal")
        lo, hi = self.segment_ranges()["wal"]
        return self.pool.flush(lo, hi)

    def account_checkpoint(self, count: int) -> dict:
        """Read the live delta state (first `count` rows + the tombstone
        bitmap) and flush the delta segment's dirty pages."""
        self._require("delta")
        lo, hi = self.segment_ranges()["delta"]
        rows = np.arange(int(count), dtype=np.int64)
        d = self.pool.access(lo + self.delta.pages_for_rows(rows),
                             dedup=True)
        t = self.pool.access(np.arange(lo + self.delta.num_pages, hi),
                             dedup=True)
        written = self.pool.flush(lo, hi)
        return dict(logical=d.logical + t.logical, page_writes=written)

    def account_compaction_read(self, count: int) -> dict:
        """Compaction's read half, on the pre-compaction engine: every
        base heap row and live delta row is read, then the rebuilt
        segments are invalidated."""
        self._require("delta")
        heap_rows = np.arange(self.heap.n, dtype=np.int64)
        d = self.pool.access(self._base["heap"]
                             + self.heap.pages_for_rows(heap_rows),
                             dedup=True)
        rows = np.arange(int(count), dtype=np.int64)
        d2 = self.pool.access(self._base["delta"]
                              + self.delta.pages_for_rows(rows), dedup=True)
        inv = 0
        ranges = self.segment_ranges()
        for seg in ("scann", "graph", "qheap", "delta"):
            if seg in ranges:
                inv += self.pool.invalidate(*ranges[seg])
        return dict(logical=d.logical + d2.logical, invalidated=inv)

    def account_compaction_write(self) -> dict:
        """Compaction's write half, on the successor engine: the rebuilt
        segments are written page by page, then flushed."""
        writes = dirtied = 0
        ranges = self.segment_ranges()
        for seg in ("heap", "scann", "graph", "qheap"):
            if seg in ranges:
                lo, hi = ranges[seg]
                d = self.pool.access(np.arange(lo, hi), dedup=True,
                                     dirty=True)
                writes += d.page_writes       # dirty evictions mid-write
                dirtied += d.dirtied
        writes += self.pool.flush()
        return dict(page_writes=writes, dirtied=dirtied)


def make_storage_engine(store, index=None, graph=None,
                        capacity_pages: Optional[int] = None,
                        capacity_frac: float = 0.5,
                        policy: str = "lru",
                        faults: Optional[FaultPlan] = None,
                        delta_capacity: int = 0,
                        wal_pages: int = 0) -> StorageEngine:
    """An engine for a VectorStore, with an optional ScannIndex and
    HNSWGraph (read by shape only).  The "qheap" SQ8-shadow segment is
    always laid out; `delta_capacity > 0` adds the delta tier and
    `wal_pages > 0` a WAL ring."""
    n, dim = int(store.vectors.shape[0]), int(store.vectors.shape[1])
    heap = HeapLayout(n=n, dim=dim)
    qheap = HeapLayout(n=n, dim=dim, value_bytes=1)
    scann = None
    if index is not None:
        L, C, dp = index.leaf_tiles.shape
        scann = ScannLeafLayout(num_leaves=int(L), cap=int(C), dp=int(dp))
    gl = None
    if graph is not None:
        gl = GraphAdjacencyLayout(n=int(graph.neighbors.shape[1]),
                                  degree=int(graph.neighbors.shape[2]))
    delta = None
    if delta_capacity > 0:
        delta = HeapLayout(n=int(delta_capacity), dim=dim)
    return StorageEngine(heap, scann, gl, capacity_pages=capacity_pages,
                         capacity_frac=capacity_frac, policy=policy,
                         qheap=qheap, faults=faults, delta=delta,
                         wal_pages=wal_pages)
