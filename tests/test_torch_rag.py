"""The port's retrieval-augmented server (`repro_torch.serving.rag`)
against the reference's, on the CPU: `serve_queue`'s validation and loud
centroid fallback, the clean path equal to `executor.search`, the
degradation ladder under seeded storage faults (deterministic, and equal
to the reference's ids, rungs, retries and faults), deadline admission and
buckets, the ladder's shapes and prices, `nearest_centroid`, and
`retrieve` with a smoke LM carried across by `interop.lm_params` and the
reference's projection passed in through `embed_fn`.

Equal on the exact fixtures; on the float fixture recall@k against the
reference within 0.01."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RCFG
import repro.core as R
import repro.serving.rag as RR
import repro.storage as RST
import repro_torch.core as T
import repro_torch.serving.rag as TR
import repro_torch.storage as TST
from repro.models import build_model as jbuild
from repro_torch import interop
from repro_torch.models import build_model as tbuild
from torch_parity import (exact_fixture, float_fixture, recall_vs,
                          sq8_exact_fixture, torch_params)

torch.set_num_threads(1)

WORKLOAD = "med_pos_0.1"


def _params(**kw):
    base = dict(k=8, ef_search=32, beam_width=64, max_hops=64)
    base.update(kw)
    return R.SearchParams(**base)


def _query_server(mod, executor, params, queries, n):
    """A server whose prompt i embeds to query i (token row [i])."""
    return mod.RetrievalAugmentedServer(
        bundle=None, params=None, executor=executor, search_params=params,
        doc_tokens=np.arange(n * 4, dtype=np.int32).reshape(n, 4),
        chunk_len=4, embed_fn=lambda pr, tok: queries[tok[:, 0]])


def _prompts(fx):
    return np.arange(fx["q"].shape[0], dtype=np.int32)[:, None]


def test_serve_queue_validates_inputs():
    fx = exact_fixture()
    srv = _query_server(TR, T.BruteForceExecutor(fx["store"]),
                        torch_params(_params()), fx["q"], fx["store"].n)
    bm = fx["bitmaps"][WORKLOAD][:4]
    prompts = _prompts(fx)[:4]
    with pytest.raises(ValueError, match="empty request queue"):
        srv.serve_queue(prompts[:0], bm[:0])
    with pytest.raises(ValueError, match="length mismatch"):
        srv.serve_queue(prompts, bm[:2])
    with pytest.raises(ValueError, match="empty request queue"):
        srv.retrieve(prompts[:0], bm[:0])
    with pytest.raises(ValueError, match="length mismatch"):
        srv.retrieve(prompts, bm[:1])
    with pytest.raises(ValueError, match="deadlines length mismatch"):
        srv.serve_queue(prompts, bm, policy="fifo", deadlines=np.ones(2))
    with pytest.raises(ValueError, match="unknown policy"):
        srv.serve_queue(prompts, bm, policy="lifo")


def test_serve_queue_centroid_fallback_is_loud():
    fx = exact_fixture()
    tp = torch_params(_params())
    ex = T.GraphExecutor(fx["graph"], fx["store"], strategy="sweeping")
    srv = _query_server(TR, ex, tp, fx["q"], fx["store"].n)
    bm = fx["bitmaps"][WORKLOAD]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res, info = srv.serve_queue(_prompts(fx), bm, batch_size=4,
                                    policy="centroid")
    assert info["policy"] == "centroid"
    assert info["policy_effective"] == "fifo"
    assert "policy_fallback_reason" in info
    assert any(issubclass(x.category, RuntimeWarning) for x in w)
    res2, _ = srv.serve_queue(_prompts(fx), bm, batch_size=4, policy="fifo")
    np.testing.assert_array_equal(res.ids, res2.ids)


def _scann_pair(fx, capacity_frac=1.0):
    """(reference, port) ScannExecutors on the fixture's index, each with
    a storage engine."""
    reng = RST.make_storage_engine(fx["jstore"], index=fx["jscann"],
                                   capacity_frac=capacity_frac)
    teng = TST.make_storage_engine(fx["store"], index=fx["scann"],
                                   capacity_frac=capacity_frac)
    return (R.ScannExecutor(fx["jscann"], fx["jstore"], storage=reng),
            T.ScannExecutor(fx["scann"], fx["store"], storage=teng))


@pytest.mark.parametrize("kind", ("exact", "float"))
def test_serve_queue_clean_path(kind):
    """No deadlines, no faults, no budgets: every request on the primary
    rung, results equal to one executor.search, and to the reference's."""
    fx = exact_fixture() if kind == "exact" else float_fixture()
    p = _params(num_leaves_to_search=8, scann_page_accounting="per_query")
    tp = torch_params(p)
    rex, tex = _scann_pair(fx)
    tsrv = _query_server(TR, tex, tp, fx["q"], fx["store"].n)
    rsrv = _query_server(RR, rex, p, fx["jq"], fx["store"].n)
    res, info = tsrv.serve_queue(_prompts(fx), fx["bitmaps"][WORKLOAD],
                                 batch_size=4, policy="fifo")
    assert (info["rung_level"] == 0).all()
    assert (info["rung"] == "primary").all()
    assert not info["degraded"].any() and info["admitted"].all()
    direct = tex.search(fx["q"], fx["bitmaps"][WORKLOAD], tp)
    np.testing.assert_array_equal(res.ids, direct.ids.numpy())
    np.testing.assert_array_equal(res.tokens[:, -1], _prompts(fx)[:, 0])
    rres, rinfo = rsrv.serve_queue(_prompts(fx), fx["jbitmaps"][WORKLOAD],
                                   batch_size=4, policy="fifo")
    if kind == "exact":
        np.testing.assert_array_equal(res.ids, rres.ids)
        np.testing.assert_array_equal(res.dists.view(np.int32),
                                      rres.dists.view(np.int32))
        np.testing.assert_array_equal(res.tokens, rres.tokens)
        for key in ("pool_hits", "pool_misses", "compiles"):
            assert info[key] == rinfo[key], key
    else:
        assert recall_vs(res.ids, rres.ids) >= 0.99
    assert set(info) == set(rinfo)


def test_serve_queue_centroid_routing():
    """The centroid policy reorders the dispatch only: results equal
    FIFO's, the order groups by nearest centroid and is the
    reference's."""
    fx = exact_fixture()
    p = _params(num_leaves_to_search=8, scann_page_accounting="per_query")
    rex, tex = _scann_pair(fx)
    tsrv = _query_server(TR, tex, torch_params(p), fx["q"], fx["store"].n)
    rsrv = _query_server(RR, rex, p, fx["jq"], fx["store"].n)
    bm = fx["bitmaps"][WORKLOAD]
    r_fifo, info_f = tsrv.serve_queue(_prompts(fx), bm, batch_size=4,
                                      policy="fifo")
    tex.storage.reset_cold()
    r_cent, info_c = tsrv.serve_queue(_prompts(fx), bm, batch_size=4,
                                      policy="centroid")
    np.testing.assert_array_equal(r_fifo.ids, r_cent.ids)
    np.testing.assert_array_equal(r_fifo.tokens, r_cent.tokens)
    keys = TR.nearest_centroid(fx["scann"], fx["q"]).numpy()
    assert (np.diff(keys[info_c["order"]]) >= 0).all()
    assert info_c["pool_hits"] + info_c["pool_misses"] == \
        info_f["pool_hits"] + info_f["pool_misses"] > 0
    _, rinfo = rsrv.serve_queue(_prompts(fx), fx["jbitmaps"][WORKLOAD],
                                batch_size=4, policy="centroid")
    np.testing.assert_array_equal(info_c["order"], rinfo["order"])


@pytest.mark.parametrize("kind", ("exact", "float"))
def test_nearest_centroid_equals_reference(kind):
    fx = exact_fixture() if kind == "exact" else float_fixture()
    got = TR.nearest_centroid(fx["scann"], fx["q"]).numpy()
    want = np.asarray(RR.nearest_centroid(fx["jscann"], fx["jq"]))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _chaos(side: str, fx, p):
    """serve_queue under seeded storage faults on one side: a sweeping
    primary on the SQ8 store and a ladder of primary, sq8_norerank,
    scann_lite, partial_scan."""
    mod, ST, C, store, graph, index, q, bm = (
        (TR, TST, T, fx["store"], fx["graph"], fx["scann"], fx["q"],
         fx["bitmaps"][WORKLOAD]) if side == "port" else
        (RR, RST, R, fx["jstore"], fx["jgraph"], fx["jscann"], fx["jq"],
         fx["jbitmaps"][WORKLOAD]))
    plan = ST.FaultPlan(seed=13, read_fail_prob=0.12, max_retries=1,
                        latency_spike_prob=0.05)
    eng = ST.make_storage_engine(store, index=index, graph=graph,
                                 capacity_frac=0.25, faults=plan)
    gex = C.GraphExecutor(graph, store, strategy="sweeping", storage=eng)
    ladder = mod.default_ladder(gex)
    ladder.insert(2, mod.LadderRung(
        "scann_lite", C.ScannExecutor(index, store, storage=eng),
        lambda r: dataclasses.replace(
            r, num_leaves_to_search=max(1, r.num_leaves_to_search // 2))))
    srv = _query_server(mod, gex, p if side == "ref" else torch_params(p),
                        q, store.n)
    return srv.serve_queue(_prompts(fx), bm, batch_size=4, policy="fifo",
                           ladder=ladder)


def test_chaos_ladder_deterministic_and_equal_reference():
    """Under seeded faults every request has k results or is flagged
    degraded, a replay gives the same outcome, and the port's ids, rungs,
    retries and faults are the reference's."""
    fx = sq8_exact_fixture()
    p = _params(graph_exec_mode="frontier", num_leaves_to_search=8,
                scann_page_accounting="per_query")
    res, info = _chaos("port", fx, p)
    assert info["pool_failed_reads"] > 0
    full = (res.ids >= 0).all(axis=1)
    assert (full | info["degraded"]).all()
    assert info["ladder"] == ["primary", "sq8_norerank", "scann_lite",
                              "partial_scan"]
    assert info["retried"].any()
    res2, info2 = _chaos("port", fx, p)
    rres, rinfo = _chaos("ref", fx, p)
    for other, oinfo in ((res2, info2), (rres, rinfo)):
        np.testing.assert_array_equal(res.ids, np.asarray(other.ids))
        for key in ("rung", "rung_level", "retried", "faulted",
                    "degraded", "budget_exhausted"):
            np.testing.assert_array_equal(info[key], oinfo[key],
                                          err_msg=key)
        for key in ("pool_failed_reads", "pool_retries", "pool_spikes",
                    "pool_hits", "pool_misses", "compiles"):
            assert info[key] == oinfo[key], key


def test_serve_queue_deadline_admission():
    fx = exact_fixture()
    p = _params(num_leaves_to_search=8)
    tp = torch_params(p)
    tex = T.ScannExecutor(fx["scann"], fx["store"])
    rex = R.ScannExecutor(fx["jscann"], fx["jstore"])
    floor = TR.admission_floor(fx["store"], tp)
    assert floor == RR.admission_floor(fx["jstore"], p)
    nreq = fx["q"].shape[0]
    dls = np.full(nreq, floor * 50)
    dls[0] = floor * 0.4                      # impossible: rejected
    dls[1] = floor * 3.3
    res, info = _query_server(TR, tex, tp, fx["q"], fx["store"].n
                              ).serve_queue(_prompts(fx),
                                            fx["bitmaps"][WORKLOAD],
                                            batch_size=4, policy="fifo",
                                            deadlines=dls)
    assert not info["admitted"][0] and info["rung"][0] == "rejected"
    assert (res.ids[0] == -1).all()
    assert info["admitted"][1:].all() and (info["rung_level"][1:] >= 0).all()
    rres, rinfo = _query_server(RR, rex, p, fx["jq"], fx["store"].n
                                ).serve_queue(_prompts(fx),
                                              fx["jbitmaps"][WORKLOAD],
                                              batch_size=4, policy="fifo",
                                              deadlines=dls)
    np.testing.assert_array_equal(res.ids, rres.ids)
    for key in ("admitted", "deadline_bucket", "rung", "truncated",
                "budget_exhausted"):
        np.testing.assert_array_equal(info[key], rinfo[key], err_msg=key)
    assert info["compiles"] == rinfo["compiles"]
    for d in (123456.0, 98.7, 0.0, float("inf"), -5.0, 1.0, 7.77e9):
        assert TR.bucket_deadline(d) == RR.bucket_deadline(d)
    assert TR.bucket_deadline(123456.0) == 120000.0


def test_default_ladder_shapes_and_prices():
    fx = sq8_exact_fixture()
    gex = T.GraphExecutor(fx["graph"], fx["store"], strategy="sweeping")
    assert [r.name for r in TR.default_ladder(gex)] == \
        ["primary", "sq8_norerank", "partial_scan"]
    plain = T.GraphExecutor(fx["graph"], exact_fixture()["store"],
                            strategy="sweeping")
    assert [r.name for r in TR.default_ladder(plain)] == \
        ["primary", "partial_scan"]
    sx = T.ScannExecutor(fx["scann"], fx["store"])
    assert [r.name for r in TR.default_ladder(sx)] == \
        ["primary", "scann_lite", "partial_scan"]
    planner = T.make_executor("adaptive", fx["store"], graph=fx["graph"],
                              index=fx["scann"], device="cpu")
    assert [r.name for r in TR.default_ladder(planner)] == \
        ["primary", "sq8_norerank", "scann_lite", "partial_scan"]
    p = _params(num_leaves_to_search=8)
    rsx = R.ScannExecutor(fx["jscann"], fx["jstore"])
    rgex = R.GraphExecutor(fx["jgraph"], fx["jstore"], strategy="sweeping")
    for tex, rex in ((sx, rsx), (gex, rgex)):
        for sel in (0.02, 0.3):
            got = TR.price_ladder(TR.default_ladder(tex), torch_params(p),
                                  sel, batch_q=8)
            want = RR.price_ladder(RR.default_ladder(rex), p, sel,
                                   batch_q=8)
            assert got == want
    prices = TR.price_ladder(TR.default_ladder(sx), torch_params(p), 0.3,
                             batch_q=8)
    assert prices["scann_lite"] < prices["primary"]
    assert prices["partial_scan"] > 0


def test_retrieve_with_smoke_lm_equals_reference():
    """`retrieve` end to end with llama3.2-3b's smoke LM: the reference's
    weights (interop.lm_params) and its projection (through embed_fn) give
    the same embedded queries, ids and augmented tokens; every returned id
    passes its filter."""
    fx = exact_fixture()
    cfg = RCFG.smoke_config("llama3.2-3b")
    jb = jbuild(cfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tp_lm = interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    dim = fx["store"].dim
    proj = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                        (cfg.d_model, dim), jnp.float32)
                      / np.sqrt(cfg.d_model))
    proj_t = torch.tensor(proj)
    sp = _params(k=4, num_leaves_to_search=16)
    rng = np.random.RandomState(1)
    docs = rng.randint(0, cfg.vocab, (fx["store"].n, 8)).astype(np.int32)
    prompts = rng.randint(0, cfg.vocab, (4, 16)).astype(np.int32)
    bm = fx["bitmaps"][WORKLOAD][:4]
    rsrv = RR.RetrievalAugmentedServer(
        jb, jp, R.ScannExecutor(fx["jscann"], fx["jstore"]), sp, docs,
        chunk_len=8)
    tsrv = TR.RetrievalAugmentedServer(
        tbuild(interop.arch_config(cfg)), tp_lm,
        T.ScannExecutor(fx["scann"], fx["store"]), torch_params(sp), docs,
        chunk_len=8,
        embed_fn=lambda p, tok: p["embed"]["tok"].to(torch.float32)[
            tok].mean(1) @ proj_t)
    want_q = np.asarray(rsrv._embed(jp, jnp.asarray(prompts)))
    got_q = tsrv._embed_prompts(prompts).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=1e-5, atol=1e-6)
    want = rsrv.retrieve(prompts, fx["jbitmaps"][WORKLOAD][:4])
    got = tsrv.retrieve(prompts, bm)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.shape == (4, 16 + 4 * 8) and got.strategy == "scann"
    ok = T.probe_batch(bm, torch.as_tensor(got.ids).clamp(min=0).long())
    assert bool((ok | torch.as_tensor(got.ids < 0)).all())
