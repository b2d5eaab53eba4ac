"""The port's stepped frontier driver and continuous batching
(`repro_torch.core.graph_search` frontier_* / step_supersteps,
`repro_torch.serving.continuous`) against the port's one-shot search and
against the reference, on the CPU.

* Stepped == one-shot in the port, bit for bit, for the five graph
  strategies x both quant tiers on the exact and float fixtures, with the
  hop chunks cycling 1, 3, 8 and the storage trace on.
* Port stepped == reference stepped on the exact fixtures: ids, dists and
  the seven counters.
* Per-lane dynamic deadlines == the static `deadline_cycles`.
* `ContinuousServer` == `serve_queue(policy="fifo")` in the port, and its
  records and info equal the reference's on the exact fixture.
* Per-request results do not depend on arrival order (hypothesis, few
  examples, and two fixed orders).
* `FairQueue` pops as the reference's does; the costmodel's queueing terms
  equal the reference's on a grid; the refusals (live ingestion, stepped
  exclusion).
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as R
import repro.core.costmodel as RC
import repro.core.graph_search as RG
import repro.serving.continuous as RS
import repro.serving.rag as RRAG
import repro_torch.core as T
import repro_torch.core.costmodel as TC
import repro_torch.core.graph_search as TG
import repro_torch.serving.continuous as TS
import repro_torch.serving.rag as TRAG
from torch_parity import (COUNTERS, exact_fixture, float_fixture,
                          sq8_exact_fixture, torch_params)

torch.set_num_threads(1)

STRATS = ("unfiltered", "sweeping", "acorn", "navix", "iterative_scan")
WORKLOAD = "med_pos_0.1"


def _params(strategy, quant="none", **kw):
    base = dict(k=5, ef_search=32, beam_width=32, max_hops=150,
                strategy=strategy, graph_exec_mode="frontier",
                graph_quant=quant)
    base.update(kw)
    return R.SearchParams(**base)


def _fixture(kind: str, quant: str) -> dict:
    """The exact fixture (its SQ8-exact twin for quant "sq8") or the float
    fixture (its port store quantized for "sq8"; port-only tests)."""
    if kind == "exact":
        return sq8_exact_fixture() if quant == "sq8" else exact_fixture()
    fx = float_fixture()
    if quant == "sq8":
        fx = dict(fx, store=T.quantize_store(fx["store"]))
    return fx


def _port_stepped(fx, p, bm, chunks, collect_trace=False, deadlines=None,
                  dynamic=False):
    graph, store = fx["graph"], fx["store"]
    state = TG.frontier_init(graph, store, fx["q"], bm, p,
                             collect_trace=collect_trace,
                             deadlines=deadlines)
    ci = 0
    while not bool(state.done.all()):
        state = TG.step_supersteps(graph, store, state, p,
                                   chunks[ci % len(chunks)],
                                   dynamic_deadline=dynamic)
        ci += 1
    return TG.frontier_finalize(graph, store, state, p)


def _assert_same(ref, got, ctx=""):
    """ids, dists bit for bit and the seven counters; numpy or tensors."""
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    np.testing.assert_array_equal(arr(ref[1]), arr(got[1]), err_msg=ctx)
    np.testing.assert_array_equal(arr(ref[0]).view(np.int32),
                                  arr(got[0]).view(np.int32), err_msg=ctx)
    for f in COUNTERS:
        np.testing.assert_array_equal(arr(getattr(ref[2], f)),
                                      arr(getattr(got[2], f)),
                                      err_msg=f"{ctx} {f}")


@pytest.mark.parametrize("kind", ("exact", "float"))
@pytest.mark.parametrize("quant", ("none", "sq8"))
@pytest.mark.parametrize("strategy", STRATS)
def test_stepped_equals_one_shot(kind, quant, strategy):
    """Chunked stepping is the one-shot loop, bit for bit, traces too."""
    fx = _fixture(kind, quant)
    p = torch_params(_params(strategy, quant))
    bm = fx["bitmaps"][WORKLOAD]
    ref = T.search_batch(fx["graph"], fx["store"], fx["q"], bm, p,
                         collect_trace=True)
    got = _port_stepped(fx, p, bm, (1, 3, 8), collect_trace=True)
    _assert_same(ref, got, f"{kind}/{strategy}/{quant}")
    assert set(ref[3]) == set(got[3])
    for key in ref[3]:
        assert torch.equal(ref[3][key], got[3][key]), key


@pytest.mark.parametrize("quant", ("none", "sq8"))
@pytest.mark.parametrize("strategy", STRATS)
def test_stepped_equals_reference_stepped(quant, strategy):
    fx = _fixture("exact", quant)
    p = _params(strategy, quant)
    jg, js = fx["jgraph"], fx["jstore"]
    state = RG.frontier_init(jg, js, fx["jq"], fx["jbitmaps"][WORKLOAD], p)
    while not bool(np.asarray(state.done).all()):
        state = RG.step_supersteps(jg, js, state, p, 8)
    ref = RG.frontier_finalize(jg, js, state, p)
    got = _port_stepped(fx, torch_params(p), fx["bitmaps"][WORKLOAD], (8,))
    _assert_same(ref, got, f"{strategy}/{quant}")


@pytest.mark.parametrize("strategy", ("sweeping", "iterative_scan"))
def test_dynamic_deadline_matches_static(strategy):
    """A per-lane deadline (data) stops each lane where the static
    `deadline_cycles` does, bit for bit; the deadlines bind."""
    fx = exact_fixture()
    bm = fx["bitmaps"]["none_0.02"]
    base = torch_params(_params(strategy, max_hops=300))
    free = T.search_batch(fx["graph"], fx["store"], fx["q"], bm, base)
    cyc = TC.linear_cycles(free[2], fx["store"].dim)
    for frac in (0.25, 0.75):
        dl = float(np.float32(np.quantile(cyc, frac)))
        pstat = dataclasses.replace(base, deadline_cycles=dl)
        ref = T.search_batch(fx["graph"], fx["store"], fx["q"], bm, pstat)
        got = _port_stepped(fx, base, bm, (8,),
                            deadlines=np.full(fx["q"].shape[0], dl,
                                              np.float32), dynamic=True)
        _assert_same(ref, got, f"{strategy}/{frac}")
        stopped = TC.evaluate_anytime(ref[2], pstat, fx["store"].dim,
                                      ref[1]).budget_exhausted
        assert stopped.any() and not stopped.all(), (frac, stopped)


def _requests(mod, queries, bitmaps, nreq, arrivals=None, tenants=None,
              deadlines=None):
    nq = queries.shape[0]
    return [mod.Request(rid=i, query=queries[i % nq],
                        bitmap=bitmaps[i % nq],
                        tenant=0 if tenants is None else tenants[i],
                        arrival=0 if arrivals is None else int(arrivals[i]),
                        deadline_cycles=0.0 if deadlines is None
                        else float(deadlines[i]))
            for i in range(nreq)]


def _port_requests(fx, nreq, **kw):
    return _requests(TS, fx["q"], fx["bitmaps"][WORKLOAD], nreq, **kw)


def _ref_requests(fx, nreq, **kw):
    return _requests(RS, np.asarray(fx["jq"]),
                     np.asarray(fx["jbitmaps"][WORKLOAD]), nreq, **kw)


def _query_server(mod, executor, params, queries, n):
    """A server whose prompt i embeds to query i (token row [i])."""
    return mod.RetrievalAugmentedServer(
        bundle=None, params=None, executor=executor, search_params=params,
        doc_tokens=np.zeros((n, 4), np.int32), chunk_len=4,
        embed_fn=lambda pr, tok: queries[tok[:, 0]])


@pytest.fixture(scope="module")
def serving():
    fx = exact_fixture()
    p = _params("sweeping")
    tp = torch_params(p)
    tex = T.GraphExecutor(fx["graph"], fx["store"], strategy="sweeping")
    rex = R.GraphExecutor(fx["jgraph"], fx["jstore"], strategy="sweeping")
    ref = T.search_batch(fx["graph"], fx["store"], fx["q"],
                         fx["bitmaps"][WORKLOAD], tp)
    return fx, p, tp, tex, rex, ref


def test_continuous_matches_serve_queue(serving):
    """All arrivals at t=0, fairness off: both modes equal serve_queue's
    FIFO dispatch bit for bit."""
    fx, _, tp, tex, _, _ = serving
    n = fx["q"].shape[0]
    srv = _query_server(TRAG, tex, tp, fx["q"], fx["store"].n)
    res, info = srv.serve_queue(np.arange(n, dtype=np.int32)[:, None],
                                fx["bitmaps"][WORKLOAD], batch_size=4,
                                policy="fifo")
    assert info["compiles"] >= 1
    cs = TS.ContinuousServer(tex, tp, width=4, hop_chunk=8)
    for mode in ("continuous", "batch"):
        recs, _ = cs.serve(_port_requests(fx, n), mode=mode)
        ids, dists = TS.results_in_order(recs, n, tp.k)
        np.testing.assert_array_equal(res.ids, ids, err_msg=mode)
        np.testing.assert_array_equal(res.dists.view(np.int32),
                                      dists.view(np.int32), err_msg=mode)


@pytest.mark.parametrize("mode", ("continuous", "batch"))
def test_continuous_records_equal_reference(serving, mode):
    """On the exact fixture the port's records and run telemetry are the
    reference's: ids, dists, stats, retire ticks; ticks, step_ticks,
    slot_utilization, compiles.  serve_queue's compiles too."""
    fx, p, tp, tex, rex, _ = serving
    n = fx["q"].shape[0]
    arrivals = np.sort(np.random.RandomState(3).randint(0, 5, n))
    rrecs, rinfo = RS.ContinuousServer(rex, p, width=4, hop_chunk=8).serve(
        _ref_requests(fx, n, arrivals=arrivals), mode=mode)
    trecs, tinfo = TS.ContinuousServer(tex, tp, width=4, hop_chunk=8).serve(
        _port_requests(fx, n, arrivals=arrivals), mode=mode)
    for rid in range(n):
        r, t = rrecs[rid], trecs[rid]
        np.testing.assert_array_equal(np.asarray(r["ids"]), t["ids"])
        np.testing.assert_array_equal(
            np.asarray(r["dists"]).view(np.int32), t["dists"].view(np.int32))
        for f in COUNTERS:
            assert int(np.asarray(getattr(r["stats"], f))[0]) == \
                int(getattr(t["stats"], f)[0]), (rid, f)
        for key in ("admit_tick", "retire_tick", "latency_ticks", "rung",
                    "rung_level", "retried"):
            assert r[key] == t[key], (rid, key)
    for key in ("ticks", "step_ticks", "slot_utilization", "compiles",
                "mean_queue_depth", "rejected_frac"):
        assert rinfo[key] == tinfo[key], key
    rsrv = _query_server(RRAG, rex, p, fx["jq"], fx["store"].n)
    tsrv = _query_server(TRAG, tex, tp, fx["q"], fx["store"].n)
    prompts = np.arange(n, dtype=np.int32)[:, None]
    _, ri = rsrv.serve_queue(prompts, fx["jbitmaps"][WORKLOAD],
                             batch_size=4, policy="fifo")
    _, ti = tsrv.serve_queue(prompts, fx["bitmaps"][WORKLOAD],
                             batch_size=4, policy="fifo")
    assert ri["compiles"] == ti["compiles"]


def _order_invariance_check(serving, perm, arrivals):
    fx, _, tp, tex, _, (d_ref, i_ref, s_ref) = serving
    n = fx["q"].shape[0]
    reqs = _port_requests(fx, n)
    reqs = [dataclasses.replace(reqs[j], arrival=int(arrivals[pos]))
            for pos, j in enumerate(perm)]
    recs, _ = TS.ContinuousServer(tex, tp, width=3, hop_chunk=8).serve(
        reqs, mode="continuous")
    ids, dists = TS.results_in_order(recs, n, tp.k)
    np.testing.assert_array_equal(i_ref.numpy(), ids)
    np.testing.assert_array_equal(d_ref.numpy().view(np.int32),
                                  dists.view(np.int32))
    for rid in range(n):
        for f in COUNTERS:
            assert int(getattr(s_ref, f)[rid]) == \
                int(getattr(recs[rid]["stats"], f)[0]), (rid, f)


def test_retire_admit_deterministic_orders(serving):
    n = serving[0]["q"].shape[0]
    rng = np.random.RandomState(0)
    for _ in range(2):
        _order_invariance_check(serving, rng.permutation(n),
                                np.sort(rng.randint(0, 6, n)))


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_retire_admit_property(serving, seed):
    """Any arrival order and spacing harvests the same bits a request."""
    n = serving[0]["q"].shape[0]
    rng = np.random.RandomState(seed)
    _order_invariance_check(serving, rng.permutation(n),
                            np.sort(rng.randint(0, 10, n)))


def test_tenant_fairness_no_starvation(serving):
    """A heavy tenant flooding the queue at t=0 cannot starve a light one
    under DRR, and fairness changes no request's results."""
    fx, _, tp, tex, _, (_, i_ref, _) = serving
    n_heavy, n_light = 16, 4
    n = n_heavy + n_light
    reqs = _port_requests(fx, n, tenants=[0] * n_heavy + [1] * n_light)
    lat = {}
    for name, fairness in (("fifo", None), ("drr", {0: 1.0, 1: 1.0})):
        recs, _ = TS.ContinuousServer(tex, tp, width=2, hop_chunk=8,
                                      fairness=fairness).serve(list(reqs))
        lat[name] = max(recs[r]["latency_ticks"] for r in range(n_heavy, n))
        nq = fx["q"].shape[0]
        for r in range(n):
            np.testing.assert_array_equal(recs[r]["ids"],
                                          i_ref[r % nq].numpy())
    assert lat["drr"] < lat["fifo"], lat


def test_compiles_bounded_across_deadline_buckets(serving):
    """One pool serves every deadline bucket: n distinct buckets keep the
    dispatch-shape count at the reference's bound and equal to it."""
    fx, p, tp, tex, rex, _ = serving
    n = fx["q"].shape[0]
    floor = TRAG.admission_floor(fx["store"], tp)
    assert floor == RRAG.admission_floor(fx["jstore"], p)
    deadlines = [floor * (2.0 + i) for i in range(n)]
    recs, info = TS.ContinuousServer(tex, tp, width=4, hop_chunk=8).serve(
        _port_requests(fx, n, deadlines=deadlines))
    assert info["compiles"] <= 6
    assert all(recs[r]["anytime"] is not None for r in range(n))
    _, rinfo = RS.ContinuousServer(rex, p, width=4, hop_chunk=8).serve(
        _ref_requests(fx, n, deadlines=deadlines))
    assert info["compiles"] == rinfo["compiles"]


def test_admission_rejects_subfloor_deadline(serving):
    fx, _, tp, tex, _, _ = serving
    floor = TRAG.admission_floor(fx["store"], tp)
    reqs = _port_requests(fx, 2, deadlines=[0.5 * floor, 10 * floor])
    recs, info = TS.ContinuousServer(tex, tp, width=2, hop_chunk=8).serve(
        reqs)
    assert not recs[0]["admitted"] and recs[0]["rung"] == "rejected"
    assert (recs[0]["ids"] == -1).all()
    assert recs[1]["admitted"] and recs[1]["retire_tick"] >= 0
    assert info["rejected_frac"] == 0.5


@pytest.mark.parametrize("weights", (None, {0: 1.0, 1: 2.0, 2: 0.5}))
def test_fair_queue_pops_like_reference(weights):
    rng = np.random.RandomState(5)
    tenants = rng.randint(0, 3, 40)
    keys = {i: int(k) for i, k in enumerate(rng.randint(0, 4, 40))}
    queues = (TS.FairQueue(weights), RS.FairQueue(weights))
    for q, mod in zip(queues, (TS, RS)):
        for i, t in enumerate(tenants):
            q.push(mod.Request(rid=i, query=None, bitmap=None,
                               tenant=int(t)))
    orders = [[], []]
    for j in range(41):
        prefer = j % 5 if j % 2 else None
        for q, out in zip(queues, orders):
            r = q.pop(prefer_key=prefer, keys=keys)
            out.append(None if r is None else r.rid)
    assert orders[0] == orders[1]
    assert orders[0][-1] is None and len(queues[0]) == 0


def test_fair_queue_and_slot_pool_validation(serving):
    fx, _, tp, tex, _, _ = serving
    with pytest.raises(ValueError, match="weight must be > 0"):
        TS.FairQueue({0: 0.0})
    with pytest.raises(ValueError, match="width"):
        TS.SlotPool(tex, tp, width=0)
    with pytest.raises(ValueError, match="hop_chunk"):
        TS.SlotPool(tex, tp, width=2, hop_chunk=0)
    pool = TS.SlotPool(tex, tp, width=2)
    req = _port_requests(fx, 1)[0]
    pool.admit(req, 0)
    with pytest.raises(ValueError, match="occupied"):
        pool.admit(req, 0)
    with pytest.raises(ValueError, match="assign"):
        TS.ContinuousServer(tex, tp, assign="random")
    with pytest.raises(ValueError, match="mode"):
        TS.ContinuousServer(tex, tp).serve([], mode="stream")


def test_refusals(serving):
    """Live ingestion names ROADMAP 1.11; the stepped driver refuses
    exclusion pruning, as the reference does."""
    fx, p, tp, tex, _, _ = serving
    with pytest.raises(NotImplementedError, match="1.11"):
        TS.ContinuousServer(tex, tp, index=object())
    with pytest.raises(NotImplementedError, match="1.11"):
        TS.ContinuousServer(tex, tp, ingest=[TS.IngestEvent(
            tick=0, kind="delete", ids=np.zeros(1, np.int64))])
    with pytest.raises(ValueError, match="stepped frontier driver"):
        TG.frontier_init(fx["graph"], fx["store"], fx["q"],
                         fx["bitmaps"][WORKLOAD],
                         dataclasses.replace(tp, exclusion="prune"))
    from torch_parity import tiers
    tx = tiers("exact")
    ex = T.GraphExecutor(tx["graph"], tx["store"], strategy="sweeping",
                         exclusion=tx["excl"])
    for call in (lambda: ex.idle_frontier(tp, 2),
                 lambda: ex.init_frontier(tx["q"], tx["bitmaps"][WORKLOAD],
                                          tp)):
        with pytest.raises(ValueError, match="stepped frontier driver"):
            call()


def test_frontier_write_slot_copies_and_finalize_is_pure(serving):
    """A slot write copies every per-lane row (the lane's tensors stay
    unaliased) and a mid-flight harvest writes nothing into the state."""
    fx, _, tp, tex, _, _ = serving
    pool = tex.idle_frontier(tp, 3)
    lane = tex.init_frontier(fx["q"][:1], fx["bitmaps"][WORKLOAD][:1], tp)
    pool = tex.write_frontier_slot(pool, lane, 1)
    assert torch.equal(pool.visited[1], lane.visited[0])
    assert pool.visited.data_ptr() != lane.visited.data_ptr()
    pool.done[0] = pool.done[2] = True
    pool = tex.step_frontier(pool, tp, 2)
    snap = {f.name: getattr(pool, f.name) for f in
            dataclasses.fields(pool) if f.name != "stats"}
    snap = {k: v.clone() for k, v in snap.items()}
    stats = [getattr(pool.stats, f).clone() for f in COUNTERS]
    _, _, st_out, _ = tex.finalize_frontier(pool, tp)
    for k, v in snap.items():
        assert torch.equal(getattr(pool, k), v), k
    for f, v in zip(COUNTERS, stats):
        assert torch.equal(getattr(pool.stats, f), v), f
        assert getattr(st_out, f).data_ptr() != \
            getattr(pool.stats, f).data_ptr()
    # idle lanes moved no counter
    for f in COUNTERS:
        assert int(getattr(pool.stats, f)[0]) == \
            int(getattr(tex.idle_frontier(tp, 3).stats, f)[0])


def test_costmodel_queueing_terms_equal_reference():
    for lam in (0.0, 1e-5, 1e-4, 3e-4, 9e-4, 2e-3):
        for s in (0.0, 500.0, 1000.0, 4000.0):
            for c in (0, 1, 4, 64):
                a = TC.queueing_delay_cycles(lam, s, c)
                b = RC.queueing_delay_cycles(lam, s, c)
                assert a == b or (np.isinf(a) and np.isinf(b)), (lam, s, c)
    for floor in (0.0, 5.0, 1e6):
        for queued in (0, 1, 8, 100):
            for c in (0, 1, 4):
                for s in (0.0, 1000.0):
                    assert TC.queue_aware_floor(floor, queued, c, s) == \
                        RC.queue_aware_floor(floor, queued, c, s)

    @dataclasses.dataclass
    class Faults:
        retries: int
        spikes: int

    for ev in ((0, 0), (3, 1), (120, 17)):
        for q in (0, 1, 64):
            for const in (TC.SYSTEM, TC.LIBRARY):
                rconst = RC.SYSTEM if const is TC.SYSTEM else RC.LIBRARY
                assert TC.fault_penalty(Faults(*ev), q, const) == \
                    RC.fault_penalty(Faults(*ev), q, rconst)
    assert T.fault_penalty is TC.fault_penalty
    s, c = 1000.0, 4
    waits = [TC.queueing_delay_cycles(f * c / s, s, c)
             for f in (0.5, 0.8, 0.95)]
    assert waits[0] < waits[1] < waits[2]
    assert np.isinf(TC.queueing_delay_cycles(1.2 * c / s, s, c))
