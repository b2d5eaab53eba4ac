"""`ContinuousServer` under seeded storage faults, port against reference,
on the CPU: the SQ8-exact fixture, sweeping on a pool of a quarter of the
pages, `default_ladder` with a `scann_lite` rung, 40 requests with random
arrivals, tenants and deadlines, both modes, DRR fairness on and off.
Every record (ids, dists, the seven counters, StorageStats, anytime flags,
rung, retries, ticks) and every info key must equal the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.serving.continuous as RS
import repro.serving.rag as RR
import repro.storage as RST
import repro_torch.core as T
import repro_torch.serving.continuous as TS
import repro_torch.serving.rag as TR
import repro_torch.storage as TST
from torch_parity import sq8_exact_fixture, torch_params

torch.set_num_threads(1)

WORKLOAD = "med_pos_0.1"
NREQ = 40
PLANS = [(13, 0.12, 0.05), (3, 0.3, 0.1), (21, 0.05, 0.0)]


def _params():
    return R.SearchParams(k=5, ef_search=32, beam_width=32, max_hops=150,
                          strategy="sweeping", graph_exec_mode="frontier",
                          num_leaves_to_search=8,
                          scann_page_accounting="per_query")


def _server(side, fx, plan, fairness):
    mod, srv_mod, ST, C, store, graph, index = (
        (TR, TS, TST, T, fx["store"], fx["graph"], fx["scann"])
        if side == "port" else
        (RR, RS, RST, R, fx["jstore"], fx["jgraph"], fx["jscann"]))
    seed, fail, spike = plan
    faults = ST.FaultPlan(seed=seed, read_fail_prob=fail, max_retries=1,
                          latency_spike_prob=spike)
    eng = ST.make_storage_engine(store, index=index, graph=graph,
                                 capacity_frac=0.25, faults=faults)
    gex = C.GraphExecutor(graph, store, strategy="sweeping", storage=eng)
    ladder = mod.default_ladder(gex)
    ladder.insert(2, mod.LadderRung(
        "scann_lite", C.ScannExecutor(index, store, storage=eng),
        lambda r: dataclasses.replace(
            r, num_leaves_to_search=max(1, r.num_leaves_to_search // 2))))
    p = _params() if side == "ref" else torch_params(_params())
    return srv_mod.ContinuousServer(gex, p, width=4, hop_chunk=8,
                                    fairness=fairness, ladder=ladder)


def _requests(side, fx, seed):
    rng = np.random.RandomState(seed)
    arrivals = rng.randint(0, 30, NREQ)
    tenants = rng.randint(0, 3, NREQ)
    floor = RR.admission_floor(fx["jstore"], _params())
    deadlines = np.where(rng.rand(NREQ) < 0.5, 0.0,
                         floor * rng.uniform(0.3, 40.0, NREQ))
    nq = fx["q"].shape[0]
    if side == "port":
        q, bm, mod = fx["q"], fx["bitmaps"][WORKLOAD], TS
    else:
        q, bm, mod = (np.asarray(fx["jq"]),
                      np.asarray(fx["jbitmaps"][WORKLOAD]), RS)
    return [mod.Request(rid=i, query=q[i % nq], bitmap=bm[i % nq],
                        tenant=int(tenants[i]), arrival=int(arrivals[i]),
                        deadline_cycles=float(deadlines[i]))
            for i in range(NREQ)]


def _same(a, b, ctx):
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), ctx
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{ctx}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), ctx
        for k in a:
            _same(a[k], b[k], f"{ctx}[{k}]")
    elif a is None or b is None:
        assert a is None and b is None, ctx
    elif isinstance(a, (str, bool, int, float)) and \
            isinstance(b, (str, bool, int, float)):
        assert a == b, (ctx, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, ctx
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a.view(np.int32 if a.itemsize == 4
                                                 else np.int64),
                                          b.astype(a.dtype).view(
                                              np.int32 if a.itemsize == 4
                                              else np.int64), err_msg=ctx)
        else:
            np.testing.assert_array_equal(a, b, err_msg=ctx)


@pytest.mark.parametrize("fairness", [None, {0: 1.0, 1: 2.0, 2: 1.0}],
                         ids=["fifo", "drr"])
@pytest.mark.parametrize("mode", ["continuous", "batch"])
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: f"seed{p[0]}")
def test_faulted_ladder_records_equal_reference(plan, mode, fairness):
    fx = sq8_exact_fixture()
    rrecs, rinfo = _server("ref", fx, plan, fairness).serve(
        _requests("ref", fx, plan[0]), mode=mode)
    trecs, tinfo = _server("port", fx, plan, fairness).serve(
        _requests("port", fx, plan[0]), mode=mode)
    assert set(tinfo) == set(rinfo)
    _same(rinfo, tinfo, "info")
    assert set(trecs) == set(rrecs) == set(range(NREQ))
    for rid in rrecs:
        assert set(trecs[rid]) == set(rrecs[rid]), rid
        _same(rrecs[rid], trecs[rid], f"record {rid}")
    rungs = [r["rung"] for r in trecs.values()]
    assert any(r not in ("primary", "rejected") for r in rungs) \
        or plan[1] < 0.1, rungs
