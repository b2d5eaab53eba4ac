"""Retrieval-augmented serving: filtered vector search in front of an LM.

At request time the server embeds the prompt (the mean of its token
embeddings, projected into store space), runs filtered top-k retrieval
through any executor (the request's predicate is its bitmap) and splices
the retrieved rows' tokens into the context.  Any executor works: a fixed
`GraphExecutor`, `ScannExecutor` or `BruteForceExecutor`, or the
`AdaptivePlanner`, which then picks the strategy per batch.

`serve_queue` serves a request queue in dispatch batches, FIFO or routed by
nearest ScaNN centroid, with deadline buckets, admission control and the
degradation ladder (primary -> sq8_norerank -> scann_lite -> partial_scan)
for requests that come back faulted or over budget.  The port runs the
executors eagerly and compiles nothing; `info["compiles"]` counts the
distinct (rung, resolved params, batch width) dispatch shapes, the
reference's compile-cache key set, which deadline bucketing keeps small.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.executor import (AdaptivePlanner, BruteForceExecutor,
                                       Executor, GraphExecutor, ScannExecutor,
                                       index_shape)
from repro_torch.core.scann import project_query
from repro_torch.core.types import (SearchParams, SearchResult, distance,
                                    heap_pages_per_vector)

BATCH_POLICIES = ("fifo", "centroid")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass
class RetrievalResult:
    ids: np.ndarray        # (B, k) retrieved row ids
    dists: np.ndarray      # (B, k)
    tokens: np.ndarray     # (B, k * chunk + P) augmented prompts
    strategy: str          # strategy that served the batch (planner-aware)


def find_scann_index(executor: Executor):
    """The ScaNN index an executor routes with, if it has one: a
    ScannExecutor's, or an AdaptivePlanner's scann candidate's."""
    idx = getattr(executor, "index", None)
    if idx is not None:
        return idx
    scann_ex = getattr(executor, "_scann", None)       # AdaptivePlanner
    if scann_ex is not None:
        return scann_ex.index
    return None


def nearest_centroid(index, queries: torch.Tensor) -> torch.Tensor:
    """The leaf centroid nearest to each (embedded) query, (Q,) int32: the
    routing key of the centroid batch policy.  Metric-aware, the ranking
    ScaNN's leaf selection uses, so the key is the leaf the query opens."""
    qp = project_query(index, queries)
    cents = index.leaf_centroids
    d = distance(index.metric, qp[:, None, :], cents[None, :, :],
                 (cents * cents).sum(-1)[None, :])
    return torch.argmin(d, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Graceful degradation: deadline buckets, admission control and the rung
# ladder serve_queue walks under budget or fault pressure.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LadderRung:
    """One rung of the degradation ladder: the executor that serves it and
    how a request's SearchParams degrade on it.  Rung 0 is the primary
    executor with the params untouched."""

    name: str
    executor: Executor
    adjust: Optional[Callable[[SearchParams], SearchParams]] = None

    def resolve(self, params: SearchParams) -> SearchParams:
        return self.adjust(params) if self.adjust is not None else params


def _find_graph_executor(executor: Executor) -> Optional[GraphExecutor]:
    if isinstance(executor, GraphExecutor):
        return executor
    if isinstance(executor, AdaptivePlanner):
        gs = [ex for ex in executor.candidates.values()
              if isinstance(ex, GraphExecutor)]
        for g in gs:
            if g.graph_quant == "sq8":
                return g
        return gs[0] if gs else None
    return None


def _find_scann_executor(executor: Executor) -> Optional[ScannExecutor]:
    if isinstance(executor, ScannExecutor):
        return executor
    if isinstance(executor, AdaptivePlanner):
        return executor._scann
    return None


def default_ladder(executor: Executor) -> list[LadderRung]:
    """The ladder for whatever the primary executor supports:

        primary -> sq8_norerank -> scann_lite -> partial_scan

    sq8_norerank reruns the graph traversal on the SQ8 shadow with the
    exact rerank off; scann_lite halves the opened leaves; partial_scan is
    BruteForceExecutor's budgeted prefix seqscan, always there.  Rungs
    whose components the executor lacks are skipped."""
    rungs = [LadderRung("primary", executor)]
    g = _find_graph_executor(executor)
    if g is not None and (g.graph_quant == "sq8" or g.store.has_sq8):
        sq8 = g if g.graph_quant == "sq8" else GraphExecutor(
            g.graph, g.store, strategy=g.strategy, storage=g.storage,
            graph_quant="sq8")
        rungs.append(LadderRung(
            "sq8_norerank", sq8,
            lambda p: dataclasses.replace(p, sq8_rerank=False)))
    sc = _find_scann_executor(executor)
    if sc is not None:
        rungs.append(LadderRung(
            "scann_lite", sc,
            lambda p: dataclasses.replace(
                p, num_leaves_to_search=max(
                    1, p.num_leaves_to_search // 2))))
    store = executor.store
    bf = BruteForceExecutor(store,
                            storage=getattr(executor, "storage", None))
    ppv = heap_pages_per_vector(store.dim)

    def _partial(p: SearchParams) -> SearchParams:
        # a budgetless request still gets a partial scan on the last rung
        # (~10 % of the heap, never below k rows), not a full exact scan
        if p.page_budget > 0 or p.deadline_cycles > 0:
            return p
        return dataclasses.replace(
            p, page_budget=max(p.k, store.n // 10) * ppv)

    rungs.append(LadderRung("partial_scan", bf, _partial))
    return rungs


def bucket_deadline(deadline: float) -> float:
    """Floor a per-request deadline (modeled cycles) to 2 significant
    figures: few distinct deadlines keep the dispatch shapes few, and
    flooring never serves with more budget than the request asked for."""
    if not math.isfinite(deadline) or deadline <= 0:
        return 0.0
    exp = math.floor(math.log10(deadline))
    scale = 10.0 ** (exp - 1)
    return float(math.floor(deadline / scale + 1e-9) * scale)


@functools.lru_cache(maxsize=256)
def _admission_floor_cached(n: int, dim: int, k: int,
                            constants) -> float:
    w = costmodel.budget_cycle_weights(dim, constants)
    ppv = heap_pages_per_vector(dim)
    return (n * w["filter_checks"]
            + k * (w["distance_comps"] + ppv * w["page_accesses_heap"]))


def admission_floor(store, params: SearchParams,
                    constants=costmodel.SYSTEM) -> float:
    """The cheapest possible service in modeled cycles: the last rung's
    minimal partial scan (probe every filter bit, fetch and score k rows).
    A request whose deadline is below it cannot be served at any rung and
    is rejected at admission.  Memoised on (store.n, store.dim, params.k,
    constants), since continuous admission asks at every arrival."""
    return _admission_floor_cached(store.n, store.dim, params.k, constants)


def price_ladder(rungs: list[LadderRung], params: SearchParams,
                 selectivity: float, batch_q: int = 16,
                 constants=costmodel.SYSTEM) -> dict[str, float]:
    """Modeled per-query cycles of each priceable rung
    (`costmodel.predict_cycles`; a partial scan on the rows its budget
    affords).  Planner rungs are skipped.  Telemetry, not a decision."""
    sc = next((r.executor for r in rungs
               if isinstance(r.executor, ScannExecutor)), None)
    prices: dict[str, float] = {}
    for r in rungs:
        ex = r.executor
        if isinstance(ex, AdaptivePlanner):
            continue
        if isinstance(ex, ScannExecutor):
            kind = "scann"
        elif isinstance(ex, BruteForceExecutor):
            p = r.resolve(params)
            n = ex.store.n
            ppv = heap_pages_per_vector(ex.store.dim)
            w = costmodel.budget_cycle_weights(ex.store.dim, constants)
            rows = selectivity * n
            if p.page_budget > 0:
                rows = min(rows, p.page_budget // ppv)
            if p.deadline_cycles > 0:
                per = w["distance_comps"] + ppv * w["page_accesses_heap"]
                rows = min(rows, max(p.deadline_cycles
                                     - n * w["filter_checks"], 0.0) / per)
            rows = max(min(rows, n), p.k)
            prices[r.name] = (n * w["filter_checks"]
                              + rows * (w["distance_comps"]
                                        + ppv * w["page_accesses_heap"]))
            continue
        elif isinstance(ex, GraphExecutor):
            kind = ex.strategy
        else:
            continue
        p = r.resolve(params)
        gm = 16
        if isinstance(ex, GraphExecutor):
            gm = int(ex.graph.neighbors.shape[2])
            p = dataclasses.replace(p, strategy=ex.strategy,
                                    graph_quant=ex.graph_quant)
        shape = index_shape(ex.store,
                            sc.index if sc is not None else None,
                            graph_m=gm)
        try:
            prices[r.name] = costmodel.predict_cycles(
                kind, shape, p, selectivity, constants=constants,
                batch_q=batch_q)
        except ValueError:
            continue
    return prices


class RetrievalAugmentedServer:
    def __init__(self, bundle, params, executor: Executor,
                 search_params: SearchParams, doc_tokens: np.ndarray,
                 chunk_len: int = 32, embed_fn: Optional[Callable] = None):
        """doc_tokens: (N, chunk_len) token rows aligned with store rows.
        `embed_fn(params, tokens (B, P) int64)` gives the (B, dim) queries;
        the default is the mean token embedding times a (d_model, dim)
        projection drawn from a torch.Generator seeded 7 on the store's
        device (not the reference's jax.random draw)."""
        self.bundle = bundle
        self.params = params
        self.executor = executor
        self.search_params = search_params
        self.k = search_params.k
        self.doc_tokens = doc_tokens
        self.chunk_len = chunk_len
        self.device = executor.store.device
        if embed_fn is None:
            d_model = bundle.cfg.d_model
            gen = torch.Generator(device=self.device).manual_seed(7)
            proj = torch.randn((d_model, executor.store.dim), generator=gen,
                               device=self.device) / math.sqrt(d_model)

            def embed_fn(p, tokens):
                emb = p["embed"]["tok"].to(torch.float32)[tokens]
                return emb.mean(1) @ proj

        self._embed = embed_fn

    def _embed_prompts(self, prompts: np.ndarray) -> torch.Tensor:
        return self._embed(self.params, torch.as_tensor(
            prompts, dtype=torch.int64, device=self.device))

    def _augment(self, idn: np.ndarray, prompts: np.ndarray) -> np.ndarray:
        chunks = self.doc_tokens[np.maximum(idn, 0)]       # (B, k, chunk)
        chunks = np.where((idn >= 0)[..., None], chunks, 0)
        aug = np.concatenate(
            [chunks.reshape(idn.shape[0], -1), prompts], axis=1)
        return aug.astype(np.int32)

    @staticmethod
    def _validate_queue(prompts: np.ndarray, bitmaps) -> None:
        if prompts.ndim != 2:
            raise ValueError(
                f"prompts must be (B, P) token rows, got shape "
                f"{prompts.shape}")
        if prompts.shape[0] == 0:
            raise ValueError("empty request queue (B=0): nothing to "
                             "serve — submit at least one prompt")
        if bitmaps.ndim != 2 or bitmaps.shape[0] != prompts.shape[0]:
            raise ValueError(
                f"prompts/bitmaps length mismatch: {prompts.shape[0]} "
                f"prompts vs {bitmaps.shape[0] if bitmaps.ndim else 0} "
                f"bitmaps — every request needs exactly one filter bitmap "
                f"row")

    def retrieve(self, prompts: np.ndarray,
                 bitmaps: torch.Tensor) -> RetrievalResult:
        """prompts (B, P) int; bitmaps (B, words) int32 on the store's
        device, the evaluated filter."""
        prompts = np.asarray(prompts)
        self._validate_queue(prompts, bitmaps)
        q = self._embed_prompts(prompts)
        res: SearchResult = self.executor.search(q, bitmaps,
                                                 self.search_params)
        idn = _np(res.ids)
        return RetrievalResult(ids=idn, dists=_np(res.dists),
                               tokens=self._augment(idn, prompts),
                               strategy=res.strategy)

    def serve_queue(self, prompts: np.ndarray, bitmaps: torch.Tensor,
                    batch_size: int = 16, policy: str = "centroid",
                    deadlines: Optional[np.ndarray] = None,
                    ladder: Optional[list[LadderRung]] = None,
                    admit: bool = True) -> tuple[RetrievalResult, dict]:
        """Serve a whole request queue in dispatch batches.

        policy "fifo" batches requests in arrival order; "centroid" sorts
        the queue by each embedded query's nearest ScaNN leaf centroid
        first, so requests that open the same leaves share a batch.  With
        no ScaNN index to route with, "centroid" falls back to "fifo"
        loudly: a RuntimeWarning, and info's policy_effective="fifo" with
        policy_fallback_reason.  Results come back in arrival order.

        `deadlines` gives each request a budget in modeled cycles (0 or inf
        for none), floored to 2-significant-figure buckets
        (`bucket_deadline`); requests dispatch bucket by bucket.  A
        deadline below `admission_floor` is rejected at admission (unless
        `admit=False`): ids stay -1 and it never reaches an executor.  Each
        dispatch batch walks the degradation `ladder` (default
        `default_ladder(executor)`): requests that come back faulted are
        retried once on the primary rung; those still faulted or over
        budget descend rung by rung until one serves them cleanly or the
        ladder ends.  With no deadlines, no faults and no budgets the
        ladder never engages.

        Returns (RetrievalResult in arrival order, info): the dispatch
        order, per-batch strategies, per-request rung and flags, the
        dispatch-shape count `compiles`, and the pool's telemetry delta
        when a storage engine is attached (the pool persists across
        batches)."""
        if policy not in BATCH_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; one of {BATCH_POLICIES}")
        prompts = np.asarray(prompts)
        self._validate_queue(prompts, bitmaps)
        q = self._embed_prompts(prompts)
        nreq = q.shape[0]
        order = np.arange(nreq)
        policy_effective = policy
        fallback_reason = None
        if policy == "centroid":
            index = find_scann_index(self.executor)
            if index is None:
                fallback_reason = ("centroid batching needs an executor "
                                   "with a ScaNN index; serving FIFO "
                                   "instead")
                warnings.warn(fallback_reason, RuntimeWarning,
                              stacklevel=2)
                policy_effective = "fifo"
            else:
                keys = _np(nearest_centroid(index, q))
                order = np.argsort(keys, kind="stable")
        if ladder is None:
            ladder = default_ladder(self.executor)
        # -- admission + deadline buckets -------------------------------
        buckets = np.zeros(nreq)
        admitted = np.ones(nreq, bool)
        if deadlines is not None:
            deadlines = np.asarray(deadlines, np.float64).reshape(-1)
            if deadlines.shape[0] != nreq:
                raise ValueError(
                    f"deadlines length mismatch: {deadlines.shape[0]} "
                    f"deadlines vs {nreq} requests")
            buckets = np.array([bucket_deadline(d) for d in deadlines])
            if admit:
                floor = admission_floor(self.executor.store,
                                        self.search_params)
                admitted = (buckets <= 0) | (buckets >= floor)
        k = self.k
        out = dict(ids=np.full((nreq, k), -1, np.int32),
                   dists=np.full((nreq, k), np.inf, np.float32),
                   rung=np.full(nreq, "rejected", object),
                   level=np.full(nreq, -1, np.int32),
                   truncated=np.zeros(nreq, bool),
                   exhausted=np.zeros(nreq, bool),
                   faulted=np.zeros(nreq, bool),
                   retried=np.zeros(nreq, bool))
        strategies = []
        # `is not None`, not truthiness: an empty BufferPool is falsy
        pool = getattr(getattr(self.executor, "storage", None), "pool",
                       None)
        h0, m0 = (pool.counters.hits, pool.counters.misses) \
            if pool is not None else (0, 0)
        compile_keys: set = set()
        order_adm = order[admitted[order]]
        for b in sorted(set(buckets[order_adm].tolist())):
            idxs = order_adm[buckets[order_adm] == b]
            params = self.search_params
            if b > 0:
                params = dataclasses.replace(params,
                                             deadline_cycles=float(b))
            for s in range(0, len(idxs), batch_size):
                sel = idxs[s:s + batch_size]
                strategies.append(self._ladder_dispatch(
                    q, bitmaps, sel, params, ladder, out, compile_keys))
        degraded = (out["level"] > 0) | out["truncated"] \
            | out["exhausted"] | out["faulted"]
        info = {"order": order, "strategies": strategies, "policy": policy,
                "policy_effective": policy_effective,
                "ladder": [r.name for r in ladder],
                "rung": out["rung"], "rung_level": out["level"],
                "admitted": admitted, "deadline_bucket": buckets,
                "truncated": out["truncated"],
                "budget_exhausted": out["exhausted"],
                "faulted": out["faulted"], "retried": out["retried"],
                "degraded": degraded, "compiles": len(compile_keys)}
        if fallback_reason is not None:
            info["policy_fallback_reason"] = fallback_reason
        if pool is not None:
            dh = pool.counters.hits - h0
            dm = pool.counters.misses - m0
            info["pool_hits"] = dh
            info["pool_misses"] = dm
            info["pool_hit_rate"] = dh / max(dh + dm, 1)
            info["pool_retries"] = pool.counters.retries
            info["pool_failed_reads"] = pool.counters.failed_reads
            info["pool_spikes"] = pool.counters.spikes
        strategy = strategies[0] if len(set(strategies)) == 1 else "mixed"
        if not strategies:
            strategy = "rejected"
        return RetrievalResult(ids=out["ids"], dists=out["dists"],
                               tokens=self._augment(out["ids"], prompts),
                               strategy=strategy), info

    def _ladder_dispatch(self, q, bitmaps, sel, params, ladder, out: dict,
                         compile_keys: set) -> str:
        """Serve one dispatch batch, walking the ladder for requests that
        come back faulted or over budget; scatters results and flags into
        the queue-level arrays of `out` and returns the primary rung's
        strategy.  `compile_keys` collects the distinct (rung, resolved
        params, batch width) dispatches."""
        pend = np.asarray(sel)
        batch_strategy = None
        for level, rung in enumerate(ladder):
            if not len(pend):
                break
            rp = rung.resolve(params)
            compile_keys.add((rung.name, rp, len(pend)))
            res = self._run_rung(rung, q, bitmaps, pend, rp)
            if level == 0:
                batch_strategy = res.strategy
                f, _ = self._flags(res, len(pend))
                if f.any():
                    # transient faults: one retry on the primary rung
                    # before any degradation (the injector's counter has
                    # advanced, so the retry draws a fresh schedule)
                    bad = pend[f]
                    compile_keys.add((rung.name, rp, len(bad)))
                    res2 = self._run_rung(rung, q, bitmaps, bad, rp)
                    self._scatter(res2, bad, level, rung.name, out)
                    out["retried"][bad] = True
                    ok = pend[~f]
                    if len(ok):
                        self._scatter(self._subset(res, ~f), ok, level,
                                      rung.name, out)
                    pend = pend[out["faulted"][pend] | out["exhausted"][pend]]
                    continue
            self._scatter(res, pend, level, rung.name, out)
            pend = pend[out["faulted"][pend] | out["exhausted"][pend]]
        return batch_strategy

    @staticmethod
    def _run_rung(rung: LadderRung, q, bitmaps, sel,
                  params: SearchParams) -> SearchResult:
        gather = torch.as_tensor(sel, dtype=torch.int64, device=q.device)
        return rung.executor.search(q[gather], bitmaps[gather], params)

    @staticmethod
    def _flags(res: SearchResult, m: int) -> tuple[np.ndarray, np.ndarray]:
        """(faulted, budget_exhausted) bool masks of one rung's result."""
        f = np.zeros(m, bool)
        st = res.storage
        if st is not None and getattr(st, "faulted", None) is not None:
            f = np.asarray(st.faulted, bool).copy()
        b = np.zeros(m, bool)
        if res.anytime is not None:
            b = np.asarray(res.anytime.budget_exhausted, bool).copy()
        return f, b

    @staticmethod
    def _subset(res: SearchResult, mask: np.ndarray) -> SearchResult:
        """Row-select a SearchResult's per-query fields (enough for
        `_scatter`: ids, dists, anytime, storage.faulted), on the host."""
        anytime = res.anytime
        if anytime is not None:
            anytime = dataclasses.replace(
                anytime,
                truncated=np.asarray(anytime.truncated)[mask],
                budget_exhausted=np.asarray(
                    anytime.budget_exhausted)[mask],
                completion=np.asarray(anytime.completion)[mask])
        storage = res.storage
        if storage is not None and getattr(storage, "faulted",
                                           None) is not None:
            storage = dataclasses.replace(
                storage, faulted=np.asarray(storage.faulted)[mask])
        return dataclasses.replace(
            res, ids=_np(res.ids)[mask], dists=_np(res.dists)[mask],
            anytime=anytime, storage=storage)

    def _scatter(self, res: SearchResult, sel: np.ndarray, level: int,
                 name: str, out: dict) -> None:
        out["ids"][sel] = _np(res.ids)
        out["dists"][sel] = _np(res.dists)
        out["rung"][sel] = name
        out["level"][sel] = level
        f, b = self._flags(res, len(sel))
        out["faulted"][sel] = f
        out["exhausted"][sel] = b
        out["truncated"][sel] = np.asarray(res.anytime.truncated, bool) \
            if res.anytime is not None else False
