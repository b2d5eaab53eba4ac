"""Continuous-batching frontier serving.

`serve_queue` (rag.py) is batch-synchronous: a dispatch batch enters the
frontier engine together and leaves together, so one straggler holds every
co-batched request.  This module steps the frontier engine from outside
(`GraphExecutor.step_frontier`, fixed-hop chunks) over a fixed-width
`SlotPool`, so finished lanes retire mid-flight and waiting requests take
the freed slots.

  Request             one arrival: query row, filter bitmap, tenant id,
                      arrival tick, optional deadline (modeled cycles)
  FairQueue           arrival queue with per-tenant weighted deficit
                      round-robin (weights=None: plain FIFO) and an
                      optional centroid-affinity preference
  SlotPool            admit / step / harvest over one FrontierState of
                      fixed width, storage-trace replay per retired lane,
                      per-request AnytimeInfo flags
  ContinuousServer    the event loop in virtual time (1 tick = 1 hop
                      chunk): open-loop arrivals, queue-aware admission,
                      fairness, the degradation ladder for faulted or
                      over-budget retires, and a batch-synchronous
                      comparator mode on the same pool

With fairness off and all arrivals at t=0 the harvested ids and dists equal
`serve_queue(policy="fifo")` bit for bit, and per-request SearchStats do
not depend on arrival order: each lane reads only its own row of the pool
state.  The pool's host work is one sync per superstep and the per-request
admit and harvest.  Live ingestion (`index=`, `ingest=`) needs the mutable
index of ROADMAP 1.11 and is refused.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.executor import GraphExecutor
from repro_torch.core.types import SearchParams, SearchStats
from repro_torch.serving.rag import (LadderRung, admission_floor,
                                     bucket_deadline, find_scann_index,
                                     nearest_centroid)

INGEST_ITEM = ("live ingestion during serving needs MutableIndex, which is "
               "not ported yet: ROADMAP 1.11 (mutability)")


@dataclasses.dataclass
class Request:
    """One serving arrival.  `deadline_cycles` <= 0 means no deadline;
    positive deadlines are bucketed (`bucket_deadline`) at admission, as
    the batch-synchronous path does."""
    rid: int
    query: torch.Tensor         # (dim,) float32
    bitmap: torch.Tensor        # (words,) int32 packed filter
    tenant: int = 0
    arrival: int = 0            # tick the request becomes visible
    deadline_cycles: float = 0.0


@dataclasses.dataclass
class IngestEvent:
    """One live mutation interleaved with serving: at the first tick >=
    `tick`, kind="insert" appends `rows`, kind="delete" tombstones `ids`.
    Needs ROADMAP 1.11's MutableIndex; `ContinuousServer` refuses it."""
    tick: int
    kind: str                              # "insert" | "delete"
    rows: Optional[np.ndarray] = None      # insert: (m, dim) float32
    ids: Optional[np.ndarray] = None       # delete: (m,) int64 global ids


class FairQueue:
    """Arrival queue with per-tenant weighted fair service.

    Deficit round-robin over tenant ids: each visit to a tenant adds
    `weight * quantum` to its deficit and serving one request costs 1, so
    a tenant of weight 2 drains twice as fast as one of weight 1 under
    contention; an idle tenant's deficit is cleared.  `weights=None` is
    plain FIFO across tenants.

    `pop(prefer_key, keys)` serves the first request of the chosen tenant
    whose centroid key is `prefer_key`, if any (fairness picks who,
    affinity picks which of theirs)."""

    def __init__(self, weights: Optional[dict] = None,
                 quantum: float = 1.0):
        if weights is not None:
            for t, w in weights.items():
                if w <= 0:
                    raise ValueError(
                        f"tenant {t!r} weight must be > 0, got {w}")
        self.weights = weights
        self.quantum = quantum
        self._fifo: deque[Request] = deque()
        self._tenants: "OrderedDict[int, deque[Request]]" = OrderedDict()
        self._deficit: dict[int, float] = {}

    def __len__(self) -> int:
        if self.weights is None:
            return len(self._fifo)
        return sum(len(d) for d in self._tenants.values())

    def push(self, req: Request) -> None:
        if self.weights is None:
            self._fifo.append(req)
            return
        if req.tenant not in self._tenants:
            self._tenants[req.tenant] = deque()
            self._deficit[req.tenant] = 0.0
        self._tenants[req.tenant].append(req)

    @staticmethod
    def _take(dq: deque, prefer_key, keys) -> Request:
        if prefer_key is not None and keys is not None:
            for i, r in enumerate(dq):
                if keys.get(r.rid) == prefer_key:
                    del dq[i]
                    return r
        return dq.popleft()

    def pop(self, prefer_key=None, keys: Optional[dict] = None
            ) -> Optional[Request]:
        if self.weights is None:
            if not self._fifo:
                return None
            return self._take(self._fifo, prefer_key, keys)
        if not len(self):
            return None
        # DRR: cycle tenants in arrival order; every full round adds at
        # least min weight * quantum to some non-empty tenant's deficit
        while True:
            for t in list(self._tenants):
                dq = self._tenants[t]
                if not dq:
                    self._deficit[t] = 0.0      # no banked credit
                    continue
                self._deficit[t] += \
                    self.weights.get(t, 1.0) * self.quantum
                if self._deficit[t] >= 1.0:
                    self._deficit[t] -= 1.0
                    req = self._take(dq, prefer_key, keys)
                    # the next pop resumes after this tenant
                    self._tenants.move_to_end(t)
                    return req


class SlotPool:
    """A fixed-width pool of frontier lanes, stepped in hop chunks.

    The pool state is one `FrontierState` of width `width`.  `compiles`
    counts the distinct (entry point, resolved params, width, hop_chunk,
    flags) shapes the pool used, the reference's compile-cache keys;
    nothing is compiled here.  Trace collection follows the executor's
    storage engine, as `GraphExecutor.execute` does; a retired lane
    replays only its own trace rows through the buffer pool."""

    def __init__(self, executor: GraphExecutor, params: SearchParams,
                 width: int, hop_chunk: int = 8,
                 dynamic_deadline: bool = False):
        if width <= 0:
            raise ValueError(f"slot pool width must be > 0, got {width}")
        if hop_chunk <= 0:
            raise ValueError(f"hop_chunk must be > 0, got {hop_chunk}")
        self.executor = executor
        self.params = executor.resolve_params(params)
        self.width = width
        self.hop_chunk = hop_chunk
        self.dynamic_deadline = dynamic_deadline
        self.state = executor.idle_frontier(self.params, width)
        self.device = executor.store.device
        self.occupied = np.zeros(width, bool)
        self.slot_rid = np.full(width, -1, np.int64)
        self.slot_bucket = np.zeros(width, np.float64)
        self.slot_key = np.full(width, -1, np.int64)   # centroid affinity
        self._keys: set = {("idle", self.params, width)}

    @property
    def compiles(self) -> int:
        return len(self._keys)

    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(~self.occupied)

    def _done(self) -> np.ndarray:
        return self.state.done.cpu().numpy()

    def done_slots(self) -> np.ndarray:
        return np.flatnonzero(self.occupied & self._done())

    def all_done(self) -> bool:
        return bool((~self.occupied | self._done()).all())

    def admit(self, req: Request, slot: int, key: int = -1) -> None:
        """Write one request into a free slot: a fresh lane from
        `init_frontier` copied over the previous occupant's rows, trace
        stamps included."""
        if self.occupied[slot]:
            raise ValueError(f"slot {slot} is occupied")
        bucket = bucket_deadline(req.deadline_cycles) \
            if req.deadline_cycles > 0 else 0.0
        dl = np.asarray([bucket if bucket > 0 else np.inf], np.float32)
        lane = self.executor.init_frontier(
            req.query.to(self.device)[None], req.bitmap.to(self.device)[None],
            self.params, deadlines=dl)
        self._keys.add(("init", self.params, 1))
        self.state = self.executor.write_frontier_slot(self.state, lane,
                                                       slot)
        self._keys.add(("write", self.width))
        self.occupied[slot] = True
        self.slot_rid[slot] = req.rid
        self.slot_bucket[slot] = bucket
        self.slot_key[slot] = key

    def step(self) -> None:
        self.state = self.executor.step_frontier(
            self.state, self.params, self.hop_chunk,
            dynamic_deadline=self.dynamic_deadline)
        self._keys.add(("step", self.params, self.width, self.hop_chunk,
                        self.dynamic_deadline))

    def harvest(self, slots: np.ndarray) -> list[dict]:
        """Finalize the pool and retire `slots`: one record a slot with
        ids, dists, stats, AnytimeInfo (flags against the request's own
        deadline bucket) and, with a storage engine, the lane's
        StorageStats.  Lanes not in `slots` keep running."""
        if not len(slots):
            return []
        d, ids, stats, trace = self.executor.finalize_frontier(
            self.state, self.params)
        self._keys.add(("final", self.params, self.width))
        d = d.cpu().numpy()
        ids = ids.cpu().numpy()
        stats_host = {f.name: getattr(stats, f.name).cpu()
                      for f in dataclasses.fields(SearchStats)}
        storage = self.executor.storage
        out = []
        for s in np.asarray(slots):
            st_row = SearchStats(**{f: v[s:s + 1]
                                    for f, v in stats_host.items()})
            sstats = None
            if trace is not None and storage is not None:
                rr = trace.get("rerank_rows")
                sstats = storage.account_graph(
                    trace["heap_steps"][s:s + 1],
                    trace["index_steps"][s:s + 1],
                    rerank_rows=None if rr is None else rr[s:s + 1],
                    quant=self.executor.graph_quant == "sq8")
            bucket = float(self.slot_bucket[s])
            p = self.params if bucket <= 0 else dataclasses.replace(
                self.params, deadline_cycles=bucket)
            dim = self.executor.store.dim
            anytime = costmodel.evaluate_anytime(st_row, p, dim, ids[s],
                                                 hop_cap=p.max_hops)
            out.append(dict(
                rid=int(self.slot_rid[s]), slot=int(s),
                ids=ids[s].copy(), dists=d[s].copy(), stats=st_row,
                anytime=anytime, storage=sstats,
                cycles=float(costmodel.linear_cycles(st_row, dim)[0])))
            self.occupied[s] = False
            self.slot_rid[s] = -1
            self.slot_bucket[s] = 0.0
            self.slot_key[s] = -1
        return out


def _faulted(res_storage) -> bool:
    return res_storage is not None and res_storage.faulted is not None \
        and bool(np.asarray(res_storage.faulted).any())


class ContinuousServer:
    """Open-loop serving event loop over a `SlotPool`.

    Virtual time advances one tick per stepped hop chunk (an idle tick when
    the pool is empty and no arrival is due).  mode="continuous" admits
    into any freed slot every tick; mode="batch" is the batch-synchronous
    comparator: it admits only into an empty pool and harvests only when
    every occupied lane is done, so co-batched requests share the last
    finisher's retire tick.  Per-lane results are the same in both modes;
    only the clock differs.

    Admission composes the static `admission_floor`, the queue-aware floor
    (`costmodel.queue_aware_floor`, priced with the mean modeled cycles of
    completed requests) and per-tenant fairness (`FairQueue`).  A faulted
    retire is retried once on the primary executor; one still faulted or
    over budget walks the `ladder` rung by rung as a single-query dispatch
    (+1 tick a rung)."""

    def __init__(self, executor: GraphExecutor, params: SearchParams,
                 width: int = 8, hop_chunk: int = 8,
                 fairness: Optional[dict] = None, assign: str = "fifo",
                 ladder: Optional[list[LadderRung]] = None,
                 admit: bool = True, slo_ticks: Optional[int] = None,
                 index=None, ingest: Optional[list[IngestEvent]] = None):
        if assign not in ("fifo", "centroid"):
            raise ValueError(f"unknown assign policy {assign!r}; "
                             "expected 'fifo' or 'centroid'")
        if index is not None or ingest:
            raise NotImplementedError(INGEST_ITEM)
        self.executor = executor
        self.params = executor.resolve_params(params)
        self.width = width
        self.hop_chunk = hop_chunk
        self.fairness = fairness
        self.assign = assign
        self.ladder = ladder
        self.admit = admit
        self.slo_ticks = slo_ticks

    def _centroid_keys(self, requests: list[Request]) -> Optional[dict]:
        if self.assign != "centroid":
            return None
        index = find_scann_index(self.executor)
        if index is None:
            return None
        dev = self.executor.store.device
        q = torch.stack([r.query.to(dev) for r in requests])
        keys = nearest_centroid(index, q).cpu().numpy()
        return {r.rid: int(k) for r, k in zip(requests, keys)}

    def _prefer_key(self, pool: SlotPool) -> Optional[int]:
        """The most common centroid key among active slots: admit requests
        that walk the neighborhoods the pool already has warm."""
        act = pool.slot_key[pool.occupied & (pool.slot_key >= 0)]
        if not len(act):
            return None
        vals, counts = np.unique(act, return_counts=True)
        return int(vals[np.argmax(counts)])

    def _ladder_walk(self, req: Request, rec: dict, bucket: float,
                     pool: SlotPool) -> int:
        """Retry, then descend, for a faulted or over-budget retire.
        Returns the extra ticks spent (1 a dispatch); updates `rec` in
        place with the serving rung's results and flags."""
        p = self.params if bucket <= 0 else dataclasses.replace(
            self.params, deadline_cycles=bucket)
        dev = self.executor.store.device
        q1, b1 = req.query.to(dev)[None], req.bitmap.to(dev)[None]
        extra = 0
        faulted = _faulted(rec["storage"])

        def take(res, **kw):
            rec.update(ids=res.ids[0].cpu().numpy(),
                       dists=res.dists[0].cpu().numpy(),
                       anytime=res.anytime, storage=res.storage, **kw)

        if faulted:
            # transient faults: one retry on the primary before degrading
            res = self.executor.search(q1, b1, p)
            pool._keys.add(("rung", "primary", p, 1))
            extra += 1
            take(res, retried=True)
            faulted = _faulted(res.storage)
        exhausted = rec["anytime"] is not None and \
            bool(np.asarray(rec["anytime"].budget_exhausted).any())
        rec["rung"], rec["rung_level"] = "primary", 0
        if self.ladder is None or not (faulted or exhausted):
            return extra
        for level, rung in enumerate(self.ladder[1:], start=1):
            rp = rung.resolve(p)
            res = rung.executor.search(q1, b1, rp)
            pool._keys.add(("rung", rung.name, rp, 1))
            extra += 1
            take(res, rung=rung.name, rung_level=level)
            exhausted = res.anytime is not None and \
                bool(np.asarray(res.anytime.budget_exhausted).any())
            if not (_faulted(res.storage) or exhausted):
                break
        return extra

    def serve(self, requests: list[Request], mode: str = "continuous"
              ) -> tuple[dict, dict]:
        """Run the event loop over `requests` (any order; sorted by arrival
        tick here).  Returns (records, info): `records` maps rid -> its
        record (ids, dists, stats, anytime, rung, arrival / admit / retire
        ticks, latency_ticks); `info` the run's telemetry (compiles,
        ticks, slot utilization, admission rejects, queue depth)."""
        if mode not in ("continuous", "batch"):
            raise ValueError(f"unknown mode {mode!r}; expected "
                             "'continuous' or 'batch'")
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        n = len(pending)
        any_deadline = any(r.deadline_cycles > 0 for r in pending)
        pool = SlotPool(self.executor, self.params, self.width,
                        self.hop_chunk, dynamic_deadline=any_deadline)
        queue = FairQueue(self.fairness)
        keys = self._centroid_keys(requests)
        floor = admission_floor(self.executor.store, self.params) \
            if (self.admit and any_deadline) else 0.0
        records: dict[int, dict] = {}
        rejected: list[int] = []
        by_rid: dict[int, Request] = {}
        t = 0
        ai = 0                       # arrival cursor into `pending`
        step_ticks = 0
        occupied_ticks = 0
        queue_depth: list[int] = []
        done_cycles: list[float] = []    # completed service, modeled cycles

        def _enqueue_arrivals() -> None:
            nonlocal ai
            while ai < n and pending[ai].arrival <= t:
                req = pending[ai]
                ai += 1
                if self.admit and req.deadline_cycles > 0:
                    est = float(np.mean(done_cycles)) if done_cycles \
                        else 0.0
                    gate = costmodel.queue_aware_floor(
                        floor, len(queue), self.width, est)
                    if bucket_deadline(req.deadline_cycles) < gate:
                        rejected.append(req.rid)
                        records[req.rid] = dict(
                            rid=req.rid, admitted=False, tenant=req.tenant,
                            arrival_tick=req.arrival, retire_tick=-1,
                            latency_ticks=-1,
                            ids=np.full(self.params.k, -1, np.int32),
                            dists=np.full(self.params.k, np.inf,
                                          np.float32),
                            stats=None, anytime=None, storage=None,
                            rung="rejected", rung_level=-1, retried=False)
                        continue
                queue.push(req)

        def _admit_free() -> None:
            for s in pool.free_slots():
                if not len(queue):
                    break
                prefer = self._prefer_key(pool) if keys is not None \
                    else None
                req = queue.pop(prefer_key=prefer, keys=keys)
                key = keys.get(req.rid, -1) if keys is not None else -1
                pool.admit(req, int(s), key=key)
                by_rid[req.rid] = req
                records[req.rid] = dict(
                    rid=req.rid, admitted=True, tenant=req.tenant,
                    arrival_tick=req.arrival, admit_tick=t,
                    retried=False)

        def _retire(slots: np.ndarray) -> None:
            for rec in pool.harvest(slots):
                req = by_rid[rec["rid"]]
                bucket = bucket_deadline(req.deadline_cycles) \
                    if req.deadline_cycles > 0 else 0.0
                done_cycles.append(rec["cycles"])
                extra = self._ladder_walk(req, rec, bucket, pool)
                rec.setdefault("retried", False)
                rec["retire_tick"] = t + extra
                records[req.rid].update(rec)
                records[req.rid]["latency_ticks"] = \
                    rec["retire_tick"] - req.arrival

        served = 0
        while served < n - len(rejected) or ai < n:
            _enqueue_arrivals()
            if mode == "continuous":
                _admit_free()
            elif not pool.occupied.any():
                _admit_free()        # batch: refill only an empty pool
            queue_depth.append(len(queue))
            if pool.occupied.any():
                pool.step()
                step_ticks += 1
                occupied_ticks += int(pool.occupied.sum())
                t += 1
                if mode == "continuous":
                    done = pool.done_slots()
                elif pool.all_done():
                    done = np.flatnonzero(pool.occupied)
                else:
                    done = np.empty(0, np.int64)
                if len(done):
                    _retire(done)
                    served = sum(1 for r in records.values()
                                 if r.get("retire_tick", -1) >= 0)
            else:
                t += 1               # idle tick: waiting on arrivals
        info = dict(
            mode=mode, ticks=t, step_ticks=step_ticks,
            hop_chunk=self.hop_chunk, width=self.width,
            compiles=pool.compiles,
            slot_utilization=(occupied_ticks
                              / max(step_ticks * self.width, 1)),
            rejected=np.asarray(sorted(rejected), np.int64),
            rejected_frac=len(rejected) / max(n, 1),
            mean_queue_depth=float(np.mean(queue_depth))
            if queue_depth else 0.0,
            fairness="drr" if self.fairness is not None else "fifo",
            assign=self.assign if keys is not None else "fifo")
        return records, info


def results_in_order(records: dict, nreq: int, k: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Harvested ids and dists stacked back into arrival (rid) order, the
    shape `serve_queue` returns."""
    ids = np.full((nreq, k), -1, np.int32)
    dists = np.full((nreq, k), np.inf, np.float32)
    for rid, rec in records.items():
        ids[rid] = rec["ids"]
        dists[rid] = rec["dists"]
    return ids, dists
