"""The quickstart slice end to end: the port's executors against the
reference's on the same data, index and bitmaps, the cost model on their
counters, and the port's own quickstart (tensors on the CPU)."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch import quickstart
from torch_parity import FIXTURES, check, run_both, torch_params

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


@pytest.mark.parametrize("method", ["adaptive", "sweeping_sq8", "acorn_sq8",
                                    "sweeping_excl", "partitioned",
                                    "scann_vmapped", "delta"])
def test_methods_of_later_slices_name_their_roadmap_item(method):
    fx = FIXTURES["exact"]()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.make_executor(method, fx["store"], graph=fx["graph"],
                        index=fx["scann"], device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        T.make_executor("nonsense", fx["store"], device="cpu")


def test_unported_knobs_raise():
    import dataclasses
    fx = FIXTURES["exact"]()
    ex = T.make_executor("sweeping", fx["store"], graph=fx["graph"],
                         device="cpu")
    for knobs, item in ((dict(graph_quant="sq8"), "1.4b"),
                        (dict(graph_exec_mode="vmapped"), "1.8"),
                        (dict(exclusion="prune"), "1.9")):
        p = torch_params(dataclasses.replace(P, **knobs))
        with pytest.raises(NotImplementedError, match=item):
            ex.search(fx["q"], fx["bitmaps"]["med_pos_0.1"], p)


def test_port_quickstart_runs_on_cpu(capsys):
    out = quickstart.main(device="cpu", n=2000, dim=32, clusters=8,
                          num_queries=4, num_leaves=24)
    assert set(out) == set(quickstart.METHODS)
    assert out["bruteforce"]["recall"] == 1.0
    for r in out.values():
        assert 0.0 <= r["recall"] <= 1.0 and r["mcycles"] > 0
        assert len(r["counters"]) == 7
    assert "bruteforce" in capsys.readouterr().out
