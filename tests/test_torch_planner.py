"""The port's adaptive planner and the cost model's predictive half against
the reference: predicted counters and cycles for every predictable
strategy, the index shape, the planner's choice at selectivity 0.01, 0.1
and 0.8 and on a family batch (both menus), and its results.

Tolerances: predictions are the same Python arithmetic, so equal; the
planner's predicted cycles within 1e-6 relative on the integer fixture
(its correlation proxy is a float32 mean); its results bit-equal there.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import costmodel as rc
from repro_torch import interop
from torch_parity import assert_close, assert_same, run_both, tiers

P = R.SearchParams(k=10, ef_search=48, beam_width=128, max_hops=512,
                   num_leaves_to_search=12, reorder_factor=4,
                   exclusion_margin=0.3)
MENU8 = ("bruteforce", "scann", "sweeping", "sweeping_sq8", "navix",
         "iterative_scan", "sweeping_excl", "partitioned")
SHAPES = [dict(n=1_000_000, dim=128, graph_m=16, scann_leaves=2000,
               scann_rows_per_leaf=500, scann_cent_scored=300,
               scann_pages_per_leaf=8),
          dict(n=4000, dim=48)]


@pytest.mark.parametrize("strategy", rc.PREDICTABLE_STRATEGIES)
@pytest.mark.parametrize("quant", ["none", "sq8"])
def test_predictions_equal_reference(strategy, quant):
    assert T.PREDICTABLE_STRATEGIES == rc.PREDICTABLE_STRATEGIES
    for shape in SHAPES:
        if strategy == "scann" and "scann_leaves" not in shape:
            continue
        for sel, corr, bq in ((0.01, 1.0, 1), (0.1, 3.0, 64),
                              (0.8, 0.4, 1000), (0.02, 20.0, 200)):
            p = dataclasses.replace(P, graph_quant=quant,
                                    scann_page_accounting="batch")
            want = R.predict_counters(strategy, R.IndexShape(**shape), p,
                                      sel, corr, bq)
            got = T.predict_counters(strategy, T.IndexShape(**shape),
                                     T.SearchParams(**dataclasses.asdict(p)),
                                     sel, corr, bq)
            assert got == want
            for consts in ("SYSTEM", "LIBRARY"):
                want_c = R.predict_cycles(
                    strategy, R.IndexShape(**shape), p, sel, corr,
                    getattr(R, consts), batch_q=bq)
                got_c = T.predict_cycles(
                    strategy, T.IndexShape(**shape),
                    T.SearchParams(**dataclasses.asdict(p)), sel, corr,
                    getattr(T, consts), batch_q=bq)
                assert got_c == want_c


def test_engine_scale_and_beam_bytes_equal_reference():
    from repro_torch.core import costmodel as tc
    for strat in ("sweeping", "scann", "bruteforce"):
        for bq in (1, 64):
            for u in (None, 0.3, 0.95):
                assert tc.engine_scale(strat, T.SearchParams(), bq, u) == \
                    rc.engine_scale(strat, R.SearchParams(), bq, u)
    c = {"distance_comps": 900.0, "hops": 130.0}
    for e in (1, 4):
        for s in (1, 2, 4):
            assert tc.beam_exchange_bytes(
                c, T.SearchParams(beam_exchange_interval=e), s) == \
                rc.beam_exchange_bytes(
                    c, R.SearchParams(beam_exchange_interval=e), s)
    assert tc.cache_miss_penalty(c, "sweeping", None) == 0.0


@pytest.mark.parametrize("kind", ["sq8_exact", "float"])
def test_index_shape_matches_reference(kind):
    fx = tiers(kind)
    assert dataclasses.asdict(T.index_shape(fx["store"], fx["scann"])) == \
        dataclasses.asdict(R.index_shape(fx["jstore"], fx["jscann"]))


def _with_selectivity_workloads(fx: dict) -> dict:
    jb, tb = dict(fx["jbitmaps"]), dict(fx["bitmaps"])
    for i, sel in enumerate((0.01, 0.1, 0.8)):
        bm = np.asarray(R.generate_bitmaps(fx["jstore"], fx["jq"],
                                           R.WorkloadSpec(sel, "none"),
                                           seed=20 + i))
        jb[f"sel_{sel}"] = jnp.asarray(bm)
        tb[f"sel_{sel}"] = interop.bitmaps(bm, "cpu")
    return dict(fx, jbitmaps=jb, bitmaps=tb)


@pytest.fixture(scope="module")
def exact_fx():
    return _with_selectivity_workloads(tiers("sq8_exact"))


@pytest.mark.parametrize("menu", ["default", "menu8"])
@pytest.mark.parametrize("workload", ["sel_0.01", "sel_0.1", "sel_0.8",
                                      "family"])
def test_planner_choice_and_result_match_reference(exact_fx, menu,
                                                   workload):
    kw = {} if menu == "default" else {"planner_candidates": MENU8}
    jres, tres = run_both(exact_fx, "adaptive", P, workload, **kw)
    assert tres.plan.strategy == jres.plan.strategy
    pj, pt = jres.plan.predicted_cycles, tres.plan.predicted_cycles
    assert pt.keys() == pj.keys()
    for name in pj:
        assert pt[name] == pytest.approx(pj[name], rel=1e-6), name
    np.testing.assert_array_equal(tres.plan.est_selectivity,
                                  np.asarray(jres.plan.est_selectivity))
    assert tres.plan.correlation_proxy == pytest.approx(
        jres.plan.correlation_proxy, rel=1e-6)
    assert_same(jres, tres)
    if workload == "family" and menu == "menu8":
        assert tres.plan.strategy == "partitioned"


def test_planner_on_float_fixture_family_batch():
    jres, tres = run_both(tiers("float"), "adaptive", P, "family",
                          planner_candidates=MENU8)
    assert tres.plan.strategy == jres.plan.strategy
    assert_close(jres, tres)


def test_planner_keeps_partitioned_out_of_a_mixed_batch(exact_fx):
    fx = exact_fx
    pl = T.make_executor("adaptive", fx["store"], graph=fx["graph"],
                         index=fx["scann"], exclusion=fx["excl"],
                         partitions=fx["parts"], planner_candidates=MENU8,
                         device="cpu")
    assert set(pl.candidates) == set(MENU8)
    bm = fx["bitmaps"]["family"].clone()
    bm[-1] = 0
    assert pl.plan(fx["q"], bm, T.SearchParams()).strategy != "partitioned"


def test_planner_memo_keys_on_tensor_identity(exact_fx):
    fx = exact_fx
    pl = T.make_executor("adaptive", fx["store"], graph=fx["graph"],
                         index=fx["scann"], device="cpu")
    q, bm = fx["q"], fx["bitmaps"]["sel_0.1"]
    a = pl.plan(q, bm, T.SearchParams())
    assert pl.plan(q, bm, T.SearchParams()).est_selectivity is \
        a.est_selectivity                               # memo hit
    fresh = bm.clone()
    b = pl.plan(q, fresh, T.SearchParams())
    assert b.est_selectivity is not a.est_selectivity   # recomputed
    np.testing.assert_array_equal(b.est_selectivity, a.est_selectivity)
    fresh[0] = 0                                        # in place: version
    c = pl.plan(q, fresh, T.SearchParams())
    assert c.est_selectivity[0] == 0.0
