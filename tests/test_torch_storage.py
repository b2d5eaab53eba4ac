"""The port's paged storage engine against the reference: page layouts,
fault draws, the buffer pool op for op on the same page streams, every
`account_*` entry point on the same traces, the frontier engine's traces
bit for bit, every executor with storage attached, and the warm-cache-aware
planner.

Tolerances: the storage layer is the same integer arithmetic on the same
streams, so every counter, residency and page order is equal; the search
results and traces are bit-equal on the integer and SQ8-exact fixtures.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.storage as RS
import repro_torch.core as T
import repro_torch.storage as TS
from repro.core.graph_search import search_batch as j_search
from repro.storage.engine import _ordered_touches
from repro_torch import interop
from repro_torch.core.graph_search import search_batch as t_search
from torch_parity import (COUNTERS, assert_same, exact_fixture, run_both,
                          sq8_exact_fixture, tiers, torch_params)

P = R.SearchParams(k=10, ef_search=32, beam_width=64, max_hops=256,
                   num_leaves_to_search=6, reorder_factor=4,
                   exclusion_margin=0.3)
STRATEGIES = ("unfiltered", "sweeping", "acorn", "navix", "iterative_scan")
PLANS = [RS.FaultPlan(),
         RS.FaultPlan(seed=3, read_fail_prob=0.3, max_retries=2,
                      latency_spike_prob=0.2),
         RS.FaultPlan(seed=7, pressure_prob=0.05, pressure_len=9,
                      pressure_frac=0.4, read_fail_prob=0.6),
         RS.FaultPlan(seed=11, wal_torn_prob=0.5, fsync_fail_prob=0.5)]


def _plan(p) -> TS.FaultPlan:
    return TS.FaultPlan(**dataclasses.asdict(p))


# ---------------- layouts and fault draws ----------------

@pytest.mark.parametrize("n,dim,vb", [(1000, 128, 4), (1000, 128, 1),
                                      (37, 3000, 4), (5, 2048, 4)])
def test_layouts_equal_reference(n, dim, vb):
    rows = np.array([0, 3, n - 1, 17 % n, 3])
    a, b = RS.HeapLayout(n, dim, vb), TS.HeapLayout(n, dim, vb)
    assert (a.row_bytes, a.pages_per_row, a.rows_per_page, a.num_pages) == \
        (b.row_bytes, b.pages_per_row, b.rows_per_page, b.num_pages)
    np.testing.assert_array_equal(a.pages_for_rows(rows),
                                  b.pages_for_rows(rows))
    a, b = RS.ScannLeafLayout(n, 53, dim), TS.ScannLeafLayout(n, 53, dim)
    assert (a.pages_per_leaf, a.num_pages) == (b.pages_per_leaf, b.num_pages)
    np.testing.assert_array_equal(a.pages_for_leaves(rows),
                                  b.pages_for_leaves(rows))
    a = RS.GraphAdjacencyLayout(n, dim // 4)
    b = TS.GraphAdjacencyLayout(n, dim // 4)
    assert (a.entry_bytes, a.nodes_per_page, a.num_pages) == \
        (b.entry_bytes, b.nodes_per_page, b.num_pages)
    np.testing.assert_array_equal(a.pages_for_nodes(rows),
                                  b.pages_for_nodes(rows))


@pytest.mark.parametrize("plan", PLANS)
def test_fault_draws_equal_reference(plan):
    a, b = RS.FaultInjector(plan), TS.FaultInjector(_plan(plan))
    assert a.plan.active == b.plan.active
    assert a.plan.write_active == b.plan.write_active
    for i in range(400):
        a.tick()
        b.tick()
        assert a.capacity_frac() == b.capacity_frac()
        if i % 3 == 0:
            assert a.on_miss() == b.on_miss()
        if i % 5 == 0:
            assert a.on_wal_append(100 + i) == b.on_wal_append(100 + i)
            assert a.on_fsync() == b.on_fsync()
    a.reset()
    b.reset()
    assert (a.counter, a.wal_appends) == (b.counter, b.wal_appends) == (0, 0)


# ---------------- the buffer pool, op for op ----------------

def _pools(cap, policy, plan=None, segments=None):
    ja = RS.BufferPool(cap, policy, segments=segments,
                       faults=None if plan is None else
                       RS.FaultInjector(plan))
    tb = TS.BufferPool(cap, policy, segments=segments,
                       faults=None if plan is None else
                       TS.FaultInjector(_plan(plan)))
    return ja, tb


def _state(s) -> dict:
    """A BufferPoolState of either package as a plain dict."""
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


def _same_pool(ja, tb):
    assert list(ja._pages.items()) == tb.resident()
    assert ja._dirty == tb._dirty
    assert ja.counters.as_dict() == tb.counters.as_dict()
    assert _state(ja.state()) == _state(tb.state())


OPS = st.lists(st.tuples(
    st.sampled_from(["access", "access", "dedup", "dirty", "flush",
                     "invalidate", "reset"]),
    st.lists(st.integers(0, 40), min_size=0, max_size=25)),
    min_size=1, max_size=12)


@settings(max_examples=25, deadline=None)
@given(ops=OPS, cap=st.integers(0, 12), policy=st.sampled_from(["lru",
                                                                 "clock"]))
def test_pool_op_for_op_property(ops, cap, policy):
    """Random streams of accesses (plain, deduplicated, dirtying), flushes,
    invalidations and cold resets: the same deltas, resident order, dirty
    set, cumulative counters and per-segment state after every op."""
    segs = {"a": (0, 20), "b": (20, 41)}
    ja, tb = _pools(cap, policy, segments=segs)
    for op, pages in ops:
        pages = np.array(pages, np.int64)
        if op in ("access", "dedup", "dirty"):
            kw = {"dedup": op == "dedup", "dirty": op == "dirty"}
            assert ja.access(pages, **kw).as_dict() == \
                tb.access(pages, **kw).as_dict()
            assert len(tb) <= cap or cap <= 0
        elif op == "flush":
            lo = int(pages[0]) if len(pages) else 0
            assert ja.flush(lo, lo + 10) == tb.flush(lo, lo + 10)
        elif op == "invalidate":
            assert ja.invalidate(5, 25) == tb.invalidate(5, 25)
        else:
            ja.reset()
            tb.reset()
        _same_pool(ja, tb)


@pytest.mark.parametrize("plan", PLANS[1:3])
@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_pool_with_faults_equal_reference(plan, policy):
    rng = np.random.RandomState(5)
    ja, tb = _pools(10, policy, plan, segments={"x": (0, 60)})
    for _ in range(30):
        pages = rng.randint(0, 60, size=rng.randint(1, 20))
        dirty = bool(rng.rand() < 0.3)
        assert ja.access(pages, dirty=dirty).as_dict() == \
            tb.access(pages, dirty=dirty).as_dict()
    _same_pool(ja, tb)
    assert tb.counters.retries + tb.counters.failed_reads > 0


def test_lru_order_and_clock_second_chance():
    tb = TS.BufferPool(3, "lru")
    tb.access(np.array([1, 2, 3, 1, 4]))
    assert [p for p, _ in tb.resident()] == [3, 1, 4]     # 2 was LRU
    tc = TS.BufferPool(3, "clock")
    tc.access(np.array([1, 2, 3, 1, 4]))
    # 1 was referenced: it rotates with its bit cleared, 2 goes
    assert [p for p, _ in tc.resident()] == [3, 1, 4]
    assert tc.counters.evictions == 1


# ---------------- the engine's entry points ----------------

def _engines(**kw):
    store, idx, graph = (np.zeros((300, 24), np.float32),
                         np.zeros((7, 50, 24), np.int8),
                         np.zeros((1, 300, 8), np.int32))
    mk = lambda m, **k: m.make_storage_engine(  # noqa: E731
        _Shape(store), _Shape(tiles=idx), _Shape(neighbors=graph), **k)
    return mk(RS, **kw), mk(TS, **{k: _plan(v) if k == "faults" else v
                                    for k, v in kw.items()})


class _Shape:
    """Just the array shapes an engine is built from."""

    def __init__(self, vectors=None, tiles=None, neighbors=None):
        self.vectors, self.leaf_tiles, self.neighbors = (vectors, tiles,
                                                        neighbors)


def _same_stats(a, b):
    assert a.as_dict() == b.as_dict()
    assert a.unique_fraction() == b.unique_fraction()
    assert (a.logical_total, a.miss_total, a.hit_rate) == \
        (b.logical_total, b.miss_total, b.hit_rate)


@pytest.mark.parametrize("plan", [None, PLANS[1]])
@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_engine_accounting_equal_reference(plan, policy):
    rng = np.random.RandomState(1)
    kw = dict(capacity_frac=0.3, policy=policy)
    if plan is not None:
        kw["faults"] = plan
    je, te = _engines(**kw)
    assert je.segment_ranges() == te.segment_ranges()
    assert je.total_pages == te.total_pages
    leaves = rng.randint(0, 7, (9, 3))
    rows = rng.randint(-1, 300, (9, 5))
    ok = rows >= 0
    for acc, blk in (("per_query", 0), ("batch", 0), ("batch", 4)):
        _same_stats(je.account_scann(leaves, rows, ok, acc, blk),
                    te.account_scann(torch.as_tensor(leaves),
                                     torch.as_tensor(rows),
                                     torch.as_tensor(ok), acc, blk))
    steps = np.full((9, 300), TS.TRACE_UNTOUCHED, np.int32)
    idx = rng.randint(0, 300, (9, 40))
    np.put_along_axis(steps, idx, rng.randint(0, 6, (9, 40)), 1)
    isteps = np.where(rng.rand(9, 300) < 0.05, rng.randint(0, 4, (9, 300)),
                      TS.TRACE_UNTOUCHED).astype(np.int32)
    for quant in (False, True):
        _same_stats(je.account_graph(steps, isteps, rows, quant=quant),
                    te.account_graph(torch.as_tensor(steps),
                                     torch.as_tensor(isteps),
                                     torch.as_tensor(rows), quant=quant))
    bm = rng.randint(0, 2 ** 32, (9, 10), dtype=np.uint64).astype(np.uint32)
    _same_stats(je.account_seqscan(bm),
                te.account_seqscan(interop.bitmaps(bm, "cpu")))
    assert _state(je.state()) == _state(te.state())
    _same_pool(je.pool, te.pool)
    je.reset_cold()
    te.reset_cold()
    assert _state(je.state()) == _state(te.state())


def test_ordered_touches_equal_reference():
    rng = np.random.RandomState(2)
    steps = np.where(rng.rand(70, 500) < 0.1, rng.randint(0, 9, (70, 500)),
                     TS.TRACE_UNTOUCHED).astype(np.int32)
    got = TS.ordered_touches(torch.as_tensor(steps), block=16)
    for i in range(70):
        np.testing.assert_array_equal(got[i], _ordered_touches(steps[i]))


def test_write_path_equal_reference():
    je, te = _engines(capacity_frac=0.2, delta_capacity=64, wal_pages=4,
                      faults=PLANS[3])
    assert je.segment_ranges() == te.segment_ranges()
    for e in (je, te):
        e.account_delta_write(np.arange(10))
    _same_stats(je.account_delta_scan(12, 3), te.account_delta_scan(12, 3))
    assert je.account_tombstone_write(np.array([3, 40, 350])).as_dict() == \
        te.account_tombstone_write(np.array([3, 40, 350])).as_dict()
    for off in (0, 5000, 40000):
        assert je.account_wal_append(off, 9000).as_dict() == \
            te.account_wal_append(off, 9000).as_dict()
    assert je.account_wal_sync() == te.account_wal_sync()
    assert je.account_checkpoint(12) == te.account_checkpoint(12)
    _same_pool(je.pool, te.pool)
    assert je.account_compaction_read(12) == te.account_compaction_read(12)
    assert je.account_compaction_write() == te.account_compaction_write()
    _same_pool(je.pool, te.pool)


def test_merge_storage_stats_equal_reference():
    je, te = _engines(capacity_frac=0.5)
    rng = np.random.RandomState(4)
    parts_j, parts_t = [], []
    for _ in range(3):
        lv, rows = rng.randint(0, 7, (4, 2)), rng.randint(0, 300, (4, 3))
        parts_j.append(je.account_scann(lv, rows, rows >= 0))
        parts_t.append(te.account_scann(lv, rows, rows >= 0))
    _same_stats(RS.merge_storage_stats(parts_j),
                TS.merge_storage_stats(parts_t))


def test_interop_carries_a_warm_pool():
    fx = exact_fixture()
    je = RS.make_storage_engine(fx["jstore"], fx["jscann"], fx["jgraph"],
                                capacity_frac=0.1, policy="clock")
    je.pool.access(np.arange(0, 300, 3))
    je.pool.access(np.arange(0, 90, 9))
    je.pool.access(np.array([1, 2, 3]), dirty=True)
    te = interop.storage_engine(je)
    assert list(je.pool._pages.items()) == te.pool.resident()
    assert _state(je.state()) == _state(te.state())
    pages = np.arange(50, 400, 7)
    assert je.pool.access(pages).as_dict() == te.pool.access(pages).as_dict()


# ---------------- the frontier engine's traces ----------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ["exact", "sq8_exact"])
def test_frontier_trace_equal_reference(kind, strategy):
    fx = exact_fixture() if kind == "exact" else sq8_exact_fixture()
    p = dataclasses.replace(P, strategy=strategy,
                            graph_quant="sq8" if kind == "sq8_exact"
                            else "none")
    bm = "med_pos_0.1" if strategy != "navix" else "none_0.02"
    jd, ji, js, jt = j_search(fx["jgraph"], fx["jstore"], fx["jq"],
                              fx["jbitmaps"][bm], p, collect_trace=True)
    td, ti, ts, tt = t_search(fx["graph"], fx["store"], fx["q"],
                              fx["bitmaps"][bm], torch_params(p),
                              collect_trace=True)
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy(),
                                      err_msg=k)
    # the trace is write-only bookkeeping: results as with the flag off
    od, oi, os_ = t_search(fx["graph"], fx["store"], fx["q"],
                           fx["bitmaps"][bm], torch_params(p))
    assert torch.equal(oi, ti) and torch.equal(od, td)
    for f in COUNTERS:
        assert torch.equal(getattr(os_, f), getattr(ts, f))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


# ---------------- executors with storage ----------------

METHODS = [(m, "med_pos_0.1") for m in (
    "sweeping", "acorn", "navix", "iterative_scan", "sweeping_sq8",
    "acorn_sq8", "iterative_scan_sq8", "scann", "bruteforce",
    "adaptive")] + [(m, "family") for m in (
        "sweeping_excl", "sweeping_excl_sq8", "partitioned",
        "partitioned_sq8")]


# methods also run a second time on the warm pool
WARM = ("sweeping_sq8", "iterative_scan", "scann", "adaptive", "partitioned")


@pytest.mark.parametrize("method,workload", METHODS)
def test_executors_with_storage_equal_reference(method, workload):
    """Cold (and for WARM, then warm on the same batch): equal
    StorageStats, pool state and results; and results equal to a run
    without storage."""
    fx = tiers("sq8_exact")
    je = RS.make_storage_engine(fx["jstore"], fx["jscann"], fx["jgraph"],
                                capacity_frac=0.3)
    te = interop.storage_engine(je)
    for _ in ("cold", "warm") if method in WARM else ("cold",):
        jres, tres = run_both(fx, method, P, workload, storage=(je, te))
        assert_same(jres, tres)
        _same_stats(jres.storage, tres.storage)
        assert _state(je.state()) == _state(te.state())
    plain = T.make_executor(
        method, fx["store"], graph=fx["graph"], index=fx["scann"],
        exclusion=fx["excl"], partitions=fx["parts"], device="cpu").search(
            fx["q"], fx["bitmaps"][workload], torch_params(P))
    assert plain.storage is None
    assert torch.equal(plain.ids, tres.ids)
    assert torch.equal(plain.dists, tres.dists)


@pytest.mark.parametrize("accounting,block", [("per_query", 0),
                                              ("batch", 0), ("batch", 5)])
def test_scann_storage_accounting_equal_reference(accounting, block):
    fx = tiers("exact")
    p = dataclasses.replace(P, scann_page_accounting=accounting,
                            scann_query_block=block)
    je = RS.make_storage_engine(fx["jstore"], fx["jscann"], None)
    te = interop.storage_engine(je)
    jres, tres = run_both(fx, "scann", p, storage=(je, te))
    assert_same(jres, tres)
    _same_stats(jres.storage, tres.storage)
    # measured == analytic, as the reference asserts
    np.testing.assert_array_equal(tres.storage.index_pages,
                                  tres.stats.page_accesses_index.numpy())
    np.testing.assert_array_equal(tres.storage.heap_pages,
                                  tres.stats.page_accesses_heap.numpy())


def test_measured_pages_against_analytic():
    """Bruteforce measured == analytic; graph measured <= analytic per
    query (zoom-in re-scores are charged once), a whole number of rows."""
    fx = tiers("exact")
    te = TS.make_storage_engine(fx["store"], fx["scann"], fx["graph"],
                                capacity_frac=1.0)
    kw = dict(graph=fx["graph"], index=fx["scann"], storage=te,
              device="cpu")
    res = T.make_executor("bruteforce", fx["store"], **kw).search(
        fx["q"], fx["bitmaps"]["none_0.02"], torch_params(P))
    np.testing.assert_array_equal(res.storage.heap_pages,
                                  res.stats.page_accesses_heap.numpy())
    ppv = T.heap_pages_per_vector(fx["store"].dim)
    for m in ("sweeping", "acorn", "navix", "iterative_scan"):
        res = T.make_executor(m, fx["store"], **kw).search(
            fx["q"], fx["bitmaps"]["med_pos_0.1"], torch_params(P))
        heap, idx = res.storage.heap_pages, res.storage.index_pages
        assert (heap > 0).all() and (idx > 0).all()
        assert (heap <= res.stats.page_accesses_heap.numpy()).all(), m
        assert (idx <= res.stats.page_accesses_index.numpy()).all(), m
        assert (heap % ppv == 0).all()


def test_planner_is_warm_cache_aware_as_reference():
    """With the scann segment warmed, scann's predicted cycles drop the
    most; both packages predict and choose the same, cold and warm."""
    fx = tiers("exact")
    je = RS.make_storage_engine(fx["jstore"], fx["jscann"], fx["jgraph"],
                                capacity_frac=1.0)
    te = interop.storage_engine(je)
    jp = R.make_executor("adaptive", fx["jstore"], graph=fx["jgraph"],
                         index=fx["jscann"], graph_m=fx["jgraph"].m,
                         storage=je)
    tp = T.make_executor("adaptive", fx["store"], graph=fx["graph"],
                         index=fx["scann"], graph_m=fx["graph"].m,
                         storage=te, device="cpu")
    bm_j, bm_t = fx["jbitmaps"]["none_0.02"], fx["bitmaps"]["none_0.02"]
    plans = []
    for warm in (False, True):
        if warm:
            lo, hi = je.segment_ranges()["scann"]
            je.pool.access(np.arange(lo, hi))
            te.pool.access(np.arange(lo, hi))
        a = jp.plan(fx["jq"], bm_j, P)
        b = tp.plan(fx["q"], bm_t, torch_params(P))
        assert a.strategy == b.strategy
        assert set(a.predicted_cycles) == set(b.predicted_cycles)
        for m, v in a.predicted_cycles.items():
            assert b.predicted_cycles[m] == pytest.approx(v, rel=1e-6), m
        plans.append(b)
    drop = {m: plans[0].predicted_cycles[m] - plans[1].predicted_cycles[m]
            for m in plans[0].predicted_cycles}
    assert drop["scann"] > 0 and drop["scann"] == max(drop.values())


def test_planner_measures_page_sharing_on_f32_graph_batches():
    fx = tiers("exact")
    te = TS.make_storage_engine(fx["store"], fx["scann"], fx["graph"])
    tp = T.make_executor("adaptive", fx["store"], graph=fx["graph"],
                         index=fx["scann"], storage=te, device="cpu",
                         planner_candidates=("sweeping",))
    assert tp._measured_unique is None
    res = tp.search(fx["q"], fx["bitmaps"]["med_pos_0.1"], torch_params(P))
    assert tp._measured_unique == res.storage.unique_fraction()


def test_storage_needs_the_frontier_engine_and_batched_scann():
    fx = exact_fixture()
    te = TS.make_storage_engine(fx["store"], fx["scann"], fx["graph"])
    with pytest.raises(ValueError, match="batched"):
        T.make_executor("scann_vmapped", fx["store"], index=fx["scann"],
                        storage=te, device="cpu")
    ex = T.make_executor("sweeping", fx["store"], graph=fx["graph"],
                         storage=te, device="cpu")
    p = dataclasses.replace(torch_params(P), graph_exec_mode="vmapped")
    with pytest.raises(ValueError, match="frontier"):
        ex.search(fx["q"], fx["bitmaps"]["med_pos_0.1"], p)
    no_graph = TS.make_storage_engine(fx["store"], fx["scann"])
    with pytest.raises(ValueError, match="graph adjacency"):
        T.make_executor("sweeping", fx["store"], graph=fx["graph"],
                        storage=no_graph, device="cpu")
