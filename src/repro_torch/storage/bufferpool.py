"""Buffer pool: a fixed-capacity page cache with LRU or clock replacement
and hit / miss / eviction telemetry.

It models PostgreSQL's shared buffers over the global page-id space the
layouts (`pages.py`) define: executors feed it the page accesses their
searches made, and it answers which were physical reads (misses) and which
were served from the pool (hits).  Vector values always come from the dense
tensors; the pool only tracks which 8 KB pages those reads would have
pinned.  Host-side Python, run on the traces after a search.

Modes: cold (`reset()` empties the pool) and warm (the pool persists across
`access` calls and whole batches).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np

POLICIES = ("lru", "clock")


@dataclasses.dataclass
class PoolCounters:
    """Cumulative telemetry since construction / the last
    `reset_counters`."""

    logical: int = 0       # page accesses fed to the pool
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    retries: int = 0       # transient read failures that were retried
    failed_reads: int = 0  # reads whose every attempt failed
    spikes: int = 0        # slow (latency-spiked) physical reads
    dirtied: int = 0       # clean -> dirty page transitions
    page_writes: int = 0   # physical write-backs (dirty eviction or flush)
    invalidated: int = 0   # pages dropped without write-back

    @property
    def hit_rate(self) -> float:
        return self.hits / self.logical if self.logical else 0.0

    def as_dict(self) -> dict:
        return dict(logical=self.logical, hits=self.hits,
                    misses=self.misses, evictions=self.evictions,
                    retries=self.retries, failed_reads=self.failed_reads,
                    spikes=self.spikes, dirtied=self.dirtied,
                    page_writes=self.page_writes,
                    invalidated=self.invalidated,
                    hit_rate=round(self.hit_rate, 4))


@dataclasses.dataclass(frozen=True)
class BufferPoolState:
    """Residency snapshot the AdaptivePlanner reads on every plan: the
    fraction of each segment's pages currently resident, and the dirty
    pages (write-back debt)."""

    capacity: int
    used: int
    residency: Mapping[str, float]     # segment name -> resident fraction
    dirty: int = 0
    dirty_by_segment: Mapping[str, int] = dataclasses.field(
        default_factory=dict)

    def miss_fraction(self, segment: str) -> float:
        return 1.0 - self.residency.get(segment, 0.0)


class BufferPool:
    """Fixed-capacity page cache; `capacity_pages <= 0` is unbounded.

    `segments` (name -> (lo, hi) page-id range, non-overlapping) keeps
    per-segment residency and dirty counts up to date on every change, so
    `state()` never scans the resident set."""

    def __init__(self, capacity_pages: int, policy: str = "lru",
                 segments: Optional[Mapping[str, tuple[int, int]]] = None,
                 faults=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.capacity = int(capacity_pages)
        self.policy = policy
        # a FaultInjector consulted on the access path (None or an
        # inactive plan keeps the path fault-free)
        self.faults = faults
        # page id -> clock reference bit; the dict's order is the recency
        # order (lru) or the insertion ring (clock)
        self._pages: OrderedDict[int, bool] = OrderedDict()
        # resident pages modified since they were read: each costs one
        # physical write when it leaves by eviction or flush()
        self._dirty: set[int] = set()
        self.counters = PoolCounters()
        self._segments = dict(segments) if segments else {}
        self._seg_los = sorted((lo, hi, name)
                               for name, (lo, hi) in self._segments.items())
        self._seg_count = dict.fromkeys(self._segments, 0)
        self._seg_dirty = dict.fromkeys(self._segments, 0)

    def _segment_of(self, page: int) -> Optional[str]:
        i = bisect.bisect_right(self._seg_los, (page, float("inf"), "")) - 1
        if i >= 0:
            lo, hi, name = self._seg_los[i]
            if lo <= page < hi:
                return name
        return None

    def _count(self, page: int, delta: int) -> None:
        if self._segments:
            seg = self._segment_of(page)
            if seg is not None:
                self._seg_count[seg] += delta

    def _mark_dirty(self, page: int, counters: PoolCounters) -> None:
        if page in self._dirty:
            return
        self._dirty.add(page)
        counters.dirtied += 1
        if self._segments:
            seg = self._segment_of(page)
            if seg is not None:
                self._seg_dirty[seg] += 1

    def _clear_dirty(self, page: int) -> bool:
        """Drop `page`'s dirty bit; True iff it was dirty."""
        if page not in self._dirty:
            return False
        self._dirty.discard(page)
        if self._segments:
            seg = self._segment_of(page)
            if seg is not None:
                self._seg_dirty[seg] -= 1
        return True

    def __len__(self) -> int:
        return len(self._pages)

    def __contains__(self, page: int) -> bool:
        return int(page) in self._pages

    def resident(self) -> list[tuple[int, bool]]:
        """The resident pages in the pool's order, with their clock bits."""
        return list(self._pages.items())

    def resident_in(self, lo: int, hi: int) -> int:
        """Resident pages with lo <= id < hi."""
        return sum(1 for p in self._pages if lo <= p < hi)

    def reset(self) -> None:
        """Cold restart: drop every resident page.  Dirty pages are lost
        without write-back (durability comes from the WAL); telemetry
        survives."""
        self._pages.clear()
        self._dirty.clear()
        self._seg_count = dict.fromkeys(self._segments, 0)
        self._seg_dirty = dict.fromkeys(self._segments, 0)

    def flush(self, lo: int = 0, hi: Optional[int] = None) -> int:
        """Write back every dirty page with lo <= id < hi (default all);
        they stay resident, now clean.  Returns the writes, counted as
        `page_writes`."""
        if hi is None:
            victims = list(self._dirty)
        else:
            victims = [p for p in self._dirty if lo <= p < hi]
        for p in victims:
            self._clear_dirty(p)
        self.counters.page_writes += len(victims)
        return len(victims)

    def invalidate(self, lo: int, hi: int) -> int:
        """Drop every resident page with lo <= id < hi without write-back
        (the objects behind them no longer exist).  Returns the count,
        kept as `invalidated`."""
        victims = [p for p in self._pages if lo <= p < hi]
        for p in victims:
            del self._pages[p]
            self._count(p, -1)
            self._clear_dirty(p)
        self.counters.invalidated += len(victims)
        return len(victims)

    def restore(self, pages, dirty=()) -> None:
        """Load a resident set (page, clock bit) in pool order, and its
        dirty pages, into an empty pool: a warm pool carried across from
        another process."""
        if self._pages:
            raise ValueError("restore needs an empty pool")
        for p, ref in pages:
            self._pages[int(p)] = bool(ref)
            self._count(int(p), +1)
        scratch = PoolCounters()
        for p in dirty:
            self._mark_dirty(int(p), scratch)

    def reset_counters(self) -> None:
        self.counters = PoolCounters()

    def access(self, pages: np.ndarray, dedup: bool = False,
               dirty: bool = False) -> PoolCounters:
        """Run a page-access trace through the pool, in order.

        `dedup=True` charges a page repeated within this call once (its
        first occurrence decides hit or miss).  `dirty=True` is the write
        path: each touched page is marked modified.  Returns this call's
        counters (the cumulative ones accrue on `self.counters`)."""
        pages = np.asarray(pages).reshape(-1)
        if dedup and len(pages):
            _, first = np.unique(pages, return_index=True)
            pages = pages[np.sort(first)]        # first-touch order kept
        inj = self.faults if (self.faults is not None
                              and self.faults.plan.active) else None
        delta = PoolCounters()
        resident = self._pages
        lru = self.policy == "lru"
        hits = 0
        for p in pages.tolist():
            if inj is not None:
                inj.tick()
            if p in resident:
                hits += 1
                if lru:
                    resident.move_to_end(p)
                else:
                    resident[p] = True           # clock reference bit
                if dirty:
                    self._mark_dirty(p, delta)
                continue
            delta.misses += 1
            if inj is not None:
                retries, failed, spike = inj.on_miss()
                delta.retries += retries
                delta.spikes += int(spike)
                if failed:
                    # the read never completed: the page stays out
                    delta.failed_reads += 1
                    continue
            cap = self.capacity
            if cap > 0 and inj is not None:
                cap = max(1, int(cap * inj.capacity_frac()))
            if cap > 0:
                while len(resident) >= cap:      # pressure may shrink cap
                    self._evict(delta)           # below current residency
                    delta.evictions += 1
            resident[p] = False
            self._count(p, +1)
            if dirty:
                self._mark_dirty(p, delta)
        delta.logical = len(pages)
        delta.hits = hits
        self._merge(delta)
        return delta

    def _merge(self, delta: PoolCounters) -> None:
        c = self.counters
        for f in dataclasses.fields(PoolCounters):
            setattr(c, f.name, getattr(c, f.name) + getattr(delta, f.name))

    def _evict(self, delta: Optional[PoolCounters] = None) -> None:
        if self.policy == "lru":
            page, _ = self._pages.popitem(last=False)   # least recently used
            self._count(page, -1)
            if self._clear_dirty(page) and delta is not None:
                delta.page_writes += 1          # dirty eviction writes back
            return
        # clock (second chance) as a FIFO ring: referenced pages rotate to
        # the back with their bit cleared
        while True:
            k, ref = next(iter(self._pages.items()))
            if ref:
                self._pages[k] = False
                self._pages.move_to_end(k)
            else:
                del self._pages[k]
                self._count(k, -1)
                if self._clear_dirty(k) and delta is not None:
                    delta.page_writes += 1
                return

    def state(self, segments: Optional[Mapping[str, tuple[int, int]]] = None
              ) -> BufferPoolState:
        """Residency snapshot: resident / segment size per segment, so
        `1 - residency` is the expected miss fraction of a uniform access
        over the segment.  Configured segments read the maintained counts;
        other ranges scan the resident set."""
        res = {}
        for name, (lo, hi) in (segments or self._segments).items():
            size = max(1, hi - lo)
            if name in self._segments and self._segments[name] == (lo, hi):
                n_res = self._seg_count[name]
            else:
                n_res = self.resident_in(lo, hi)
            res[name] = min(1.0, n_res / size)
        dirty_by_seg = {name: self._seg_dirty.get(name, 0)
                        for name in (segments or self._segments)}
        return BufferPoolState(capacity=self.capacity, used=len(self._pages),
                               residency=res, dirty=len(self._dirty),
                               dirty_by_segment=dirty_by_seg)
