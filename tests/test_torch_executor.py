"""The quickstart slice end to end: the port's executors against the
reference's on the same data, index and bitmaps, the cost model on their
counters, and the port's own quickstart (tensors on the CPU)."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch import quickstart
from torch_parity import FIXTURES, check, run_both, tiers, torch_params

METHODS = ("sweeping", "acorn", "navix", "iterative_scan", "scann",
           "bruteforce")
P = R.SearchParams(k=10, ef_search=48, beam_width=128, max_hops=512,
                   num_leaves_to_search=12, reorder_factor=4)


@pytest.fixture(scope="module")
def runs():
    fx = FIXTURES["float"]()
    return fx, {m: run_both(fx, m, P) for m in METHODS}


@pytest.mark.parametrize("method", METHODS)
def test_quickstart_slice_matches_reference(runs, method):
    fx, res = runs
    jres, tres = res[method]
    check("float", jres, tres)
    assert tres.strategy == jres.strategy
    _, truth = R.filtered_knn(fx["jstore"], fx["jq"],
                              fx["jbitmaps"]["med_pos_0.1"], 10)
    jr = float(np.mean(np.asarray(R.recall_at_k(jres.ids, truth, 10))))
    tr = float(T.recall_at_k(tres.ids, T.filtered_knn(
        fx["store"], fx["q"], fx["bitmaps"]["med_pos_0.1"], 10)[1],
        10).mean())
    assert abs(jr - tr) <= 0.01


@pytest.mark.parametrize("method", METHODS)
def test_cost_model_on_port_counters(runs, method):
    _, res = runs
    jres, tres = res[method]
    for consts in ("SYSTEM", "LIBRARY"):
        want = R.cycle_breakdown(jres.stats, 48, getattr(R, consts))
        got = T.cycle_breakdown(tres.stats, 48, getattr(T, consts))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=0.02, abs=1.0), k
    assert T.stats_table_row(tres.stats).keys() == \
        R.stats_table_row(jres.stats).keys()
    np.testing.assert_array_equal(tres.anytime.completion,
                                  jres.anytime.completion)


def test_exact_fixture_all_methods_bit_for_bit():
    fx = FIXTURES["exact"]()
    for m in METHODS:
        jres, tres = run_both(fx, m, P, "none_0.02")
        check("exact", jres, tres)


def test_budget_weights_and_linear_cycles_match_reference():
    fx = FIXTURES["exact"]()
    assert T.budget_cycle_weights(32) == R.budget_cycle_weights(32)
    jres, tres = run_both(fx, "sweeping", P)
    np.testing.assert_array_equal(T.linear_cycles(tres.stats, 32),
                                  R.linear_cycles(jres.stats, 32))


def test_bruteforce_budgeted_scan_matches_reference():
    fx = FIXTURES["exact"]()
    import dataclasses
    p = dataclasses.replace(P, page_budget=120)
    jres, tres = run_both(fx, "bruteforce", p)
    check("exact", jres, tres)
    np.testing.assert_array_equal(tres.anytime.budget_exhausted,
                                  jres.anytime.budget_exhausted)


_UNPORTED_ITEM = {"delta": "ROADMAP 1.11"}


@pytest.mark.parametrize("method", ["adaptive", "sweeping_sq8", "acorn_sq8",
                                    "sweeping_excl", "partitioned",
                                    "scann_vmapped", "delta"])
def test_methods_of_later_slices_name_their_roadmap_item(method):
    # an unported method names its item; the ported ones (scann_vmapped
    # since the legacy engines, ROADMAP 1.8) take a storage engine
    # (ROADMAP 1.7), all but scann_vmapped, which has no trace
    from repro_torch.storage import make_storage_engine
    fx = tiers("exact")
    item = _UNPORTED_ITEM.get(method)
    engine = make_storage_engine(fx["store"], fx["scann"], fx["graph"])
    kw = dict(graph=fx["graph"], index=fx["scann"], exclusion=fx["excl"],
              partitions=fx["parts"], device="cpu")
    if item:
        with pytest.raises(NotImplementedError, match=item):
            T.make_executor(method, fx["store"], storage=engine, **kw)
    elif method == "scann_vmapped":
        with pytest.raises(ValueError, match="batched"):
            T.make_executor(method, fx["store"], storage=engine, **kw)
        assert T.make_executor(method, fx["store"], **kw).name == method
    else:
        ex = T.make_executor(method, fx["store"], storage=engine, **kw)
        assert ex.name == method and ex.storage is engine
    with pytest.raises(ValueError, match="unknown method"):
        T.make_executor("nonsense", fx["store"], device="cpu")


@pytest.mark.parametrize("method", ["adaptive", "sweeping_sq8", "acorn_sq8",
                                    "navix_sq8", "iterative_scan_sq8"])
def test_methods_of_slice_two_are_built(method):
    fx = FIXTURES["exact"]()
    ex = T.make_executor(method, fx["store"], graph=fx["graph"],
                         index=fx["scann"], device="cpu")
    assert ex.name == method
    assert method == "adaptive" or ex.store.has_sq8


def test_unported_knobs_raise():
    import dataclasses
    fx = FIXTURES["exact"]()
    ex = T.make_executor("sweeping", fx["store"], graph=fx["graph"],
                         device="cpu")
    # the legacy engine (ROADMAP 1.8) runs, bit-equal to the frontier one
    p = torch_params(dataclasses.replace(P, graph_exec_mode="vmapped"))
    legacy = ex.search(fx["q"], fx["bitmaps"]["med_pos_0.1"], p)
    front = ex.search(fx["q"], fx["bitmaps"]["med_pos_0.1"],
                      torch_params(P))
    assert torch.equal(legacy.ids, front.ids)
    assert torch.equal(legacy.dists, front.dists)
    with pytest.raises(ValueError, match="graph_exec_mode"):
        ex.search(fx["q"], fx["bitmaps"]["med_pos_0.1"],
                  dataclasses.replace(p, graph_exec_mode="nonsense"))
    # the tier knobs of slice 2 are the executor's to set: a plain
    # sweeping executor resolves them away, as the reference's does
    for knobs in (dict(graph_quant="sq8"), dict(exclusion="prune")):
        p = torch_params(dataclasses.replace(P, **knobs))
        res = ex.search(fx["q"], fx["bitmaps"]["med_pos_0.1"], p)
        assert res.plan.params.graph_quant == "none"
        assert res.plan.params.exclusion == "none"


def test_port_quickstart_runs_on_cpu(capsys):
    out = quickstart.main(device="cpu", n=2000, dim=32, clusters=8,
                          num_queries=4, num_leaves=24)
    assert set(out) == set(quickstart.METHODS) | {"adaptive"}
    assert out["bruteforce"]["recall"] == 1.0
    for m in quickstart.METHODS:
        r = out[m]
        assert 0.0 <= r["recall"] <= 1.0 and r["mcycles"] > 0
        assert len(r["counters"]) == 7
    # step 5: the planner's choice at three selectivities
    assert set(out["adaptive"]) == {0.01, 0.1, 0.8}
    for r in out["adaptive"].values():
        assert r["chosen"] in r["predicted_mcycles"]
    assert "bruteforce" in capsys.readouterr().out
