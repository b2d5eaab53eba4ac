"""The legacy engines of the port against the reference's: the vmapped
graph engine (`graph_exec_mode="vmapped"`) for every strategy and navix
heuristic, f32 and SQ8, and the per-query ScaNN path (`scann_vmapped`);
each also against the port's own frontier engine / batched pipeline, for
which it is the equivalence oracle.

Tolerances: ids, distances and all seven counters bit-equal on the integer
and SQ8-exact fixtures; on the clustered float fixture recall against the
reference's ids >= 0.99 and counter means within 2 %.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.graph_search import search_batch as j_search
from repro_torch.core.graph_search import search_batch as t_search
from torch_parity import (COUNTERS, assert_close, assert_same, check,
                          exact_fixture, run_both, sq8_exact_fixture,
                          torch_params)

P = R.SearchParams(k=10, ef_search=32, beam_width=64, max_hops=256,
                   num_leaves_to_search=6, reorder_factor=4,
                   graph_exec_mode="vmapped")
GRAPH_CASES = [(s, "adaptive") for s in ("unfiltered", "sweeping", "acorn",
                                         "iterative_scan")] + [
    ("navix", h) for h in ("adaptive", "blind", "directed", "onehop")]


def _same(a, b):
    """Two (dists, ids, stats) triples bit-equal."""
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    np.testing.assert_array_equal(np.asarray(a[0]).view(np.int32),
                                  np.asarray(b[0]).view(np.int32))
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a[2], f)),
                                      np.asarray(getattr(b[2], f)),
                                      err_msg=f)


def _t(out):
    return tuple(x.numpy() for x in out[:2]) + (
        dataclasses.replace(out[2], **{f: getattr(out[2], f).numpy()
                                       for f in COUNTERS}),)


@pytest.mark.parametrize("strategy,heuristic", GRAPH_CASES)
@pytest.mark.parametrize("kind", ["exact", "sq8_exact"])
def test_vmapped_graph_engine_equal_reference(kind, strategy, heuristic):
    fx = exact_fixture() if kind == "exact" else sq8_exact_fixture()
    p = dataclasses.replace(P, strategy=strategy, navix_heuristic=heuristic,
                            graph_quant="sq8" if kind == "sq8_exact"
                            else "none")
    for bm in ("med_pos_0.1", "none_0.02"):
        want = j_search(fx["jgraph"], fx["jstore"], fx["jq"],
                        fx["jbitmaps"][bm], p)
        got = t_search(fx["graph"], fx["store"], fx["q"], fx["bitmaps"][bm],
                       torch_params(p))
        _same(want, _t(got))
        # the frontier engine is bit-equal to its oracle
        front = t_search(fx["graph"], fx["store"], fx["q"],
                         fx["bitmaps"][bm], dataclasses.replace(
                             torch_params(p), graph_exec_mode="frontier"))
        _same(_t(front), _t(got))


def test_vmapped_graph_engine_budgets_equal_reference():
    fx = exact_fixture()
    for strategy in ("sweeping", "iterative_scan"):
        p = dataclasses.replace(P, strategy=strategy, page_budget=150,
                                hop_budget=12)
        want = j_search(fx["jgraph"], fx["jstore"], fx["jq"],
                        fx["jbitmaps"]["med_pos_0.1"], p)
        got = t_search(fx["graph"], fx["store"], fx["q"],
                       fx["bitmaps"]["med_pos_0.1"], torch_params(p))
        _same(want, _t(got))


def test_vmapped_graph_engine_rejects_traces():
    fx = exact_fixture()
    with pytest.raises(ValueError, match="frontier"):
        t_search(fx["graph"], fx["store"], fx["q"],
                 fx["bitmaps"]["med_pos_0.1"], torch_params(P),
                 collect_trace=True)
    with pytest.raises(ValueError, match="graph_exec_mode"):
        t_search(fx["graph"], fx["store"], fx["q"],
                 fx["bitmaps"]["med_pos_0.1"], dataclasses.replace(
                     torch_params(P), graph_exec_mode="other"))


@pytest.mark.parametrize("kind", ["exact", "float"])
@pytest.mark.parametrize("workload", ["med_pos_0.1", "none_0.02"])
def test_scann_vmapped_equal_reference(kind, workload):
    from torch_parity import FIXTURES
    fx = FIXTURES[kind]()
    jres, tres = run_both(fx, "scann_vmapped", P, workload)
    check(kind, jres, tres)
    assert tres.plan.strategy == "scann"


def test_scann_vmapped_against_the_batched_pipeline():
    """The same leaves, candidates and results as the batched pipeline,
    whose per-query page accounting its counters equal."""
    fx = exact_fixture()
    p = torch_params(dataclasses.replace(P, scann_page_accounting=
                                         "per_query"))
    kw = dict(index=fx["scann"], device="cpu")
    for bm in ("med_pos_0.1", "none_0.02"):
        a = T.make_executor("scann_vmapped", fx["store"], **kw).search(
            fx["q"], fx["bitmaps"][bm], p)
        b = T.make_executor("scann", fx["store"], **kw).search(
            fx["q"], fx["bitmaps"][bm], p)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
        for f in COUNTERS:
            assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), f


def test_scann_vmapped_cos_scans_leaves_as_l2_like_the_reference():
    """The reference's only ScaNN path for "cos": its leaf scan scores
    every metric but "ip" as L2, and the port does the same."""
    x, q = np.random.RandomState(3).randn(600, 16).astype(np.float32), \
        np.random.RandomState(4).randn(6, 16).astype(np.float32)
    jstore = R.VectorStore.build(x, metric="cos")
    jscann = R.build_scann(jstore, num_leaves=12, levels=1, seed=0)
    bm = np.asarray(R.generate_bitmaps(jstore, jstore.vectors[:6],
                                       R.WorkloadSpec(0.5, "none"), 1))
    from repro_torch import interop
    store = interop.vector_store(jstore, "cpu")
    scann = interop.scann_index(jscann, "cpu")
    p = dataclasses.replace(P, num_leaves_to_search=4)
    jres = R.make_executor("scann_vmapped", jstore, index=jscann).search(
        q, bm, p)
    tres = T.make_executor("scann_vmapped", store, index=scann,
                           device="cpu").search(
        torch.as_tensor(q), interop.bitmaps(bm, "cpu"), torch_params(p))
    assert_close(jres, tres)
    np.testing.assert_array_equal(np.asarray(jres.ids), tres.ids.numpy())


def test_planner_runs_scann_vmapped_without_storage():
    fx = exact_fixture()
    from repro_torch.storage import make_storage_engine
    te = make_storage_engine(fx["store"], fx["scann"], fx["graph"])
    tp = T.make_executor("adaptive", fx["store"], graph=fx["graph"],
                         index=fx["scann"], storage=te, device="cpu",
                         planner_candidates=("scann_vmapped", "sweeping"))
    assert tp.candidates["scann_vmapped"].storage is None
    assert tp.candidates["sweeping"].storage is te
    jres, tres = run_both(fx, "adaptive", P,
                          planner_candidates=("scann_vmapped", "bruteforce"))
    assert jres.plan.strategy == tres.plan.strategy
    assert_same(jres, tres)
