"""The port's mesh-sharded graph and storage tiers (DESIGN.md §13) against
the port's own one-device engine and the reference's sharded executor, on
the shared fixtures of `torch_parity`.

Lockstep (beam_exchange_interval = 1) must be invisible: the owner-masked
`min` / `max` select the owning shard's untouched values, so ids, dists
and every counter equal the one-device engine's for any shard count.
Drift (E > 1) is the one mode that computes something new: it is held
bit for bit to the reference's drift on the exact fixture."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.distributed import ShardedGraphExecutor as RSharded
from repro.core.distributed import make_sharded_storage as r_storage
from repro.core.distributed import shard_graph_tiers as r_tiers
from repro.storage import make_storage_engine as r_engine
from repro_torch import interop
from repro_torch.core import graph_search as gs
from repro_torch.core.distributed import (ShardedGraphExecutor,
                                          make_sharded_storage,
                                          shard_graph_tiers)
from repro_torch.serving import ContinuousServer, Request, results_in_order

from torch_parity import COUNTERS, FIXTURES, assert_same, torch_params

STRATEGIES = ("unfiltered", "sweeping", "acorn", "navix", "iterative_scan")
WORKLOAD = "med_pos_0.1"


def _params(strategy, quant="none", E=1) -> "R.SearchParams":
    return R.SearchParams(k=10, ef_search=32, beam_width=128,
                          strategy=strategy, max_hops=150, graph_quant=quant,
                          beam_exchange_interval=E, batch_tuples=64,
                          max_rounds=8)


def _fixture(kind: str) -> dict:
    """The fixture with an SQ8 shadow on both sides (the float fixture's
    is each side's own)."""
    fx = dict(FIXTURES[kind]())
    if fx["store"].q_vectors is None:
        fx["jstore"] = R.quantize_store(fx["jstore"])
        fx["store"] = T.quantize_store(fx["store"])
    return fx


def _method(strategy, quant):
    return strategy if quant == "none" else f"{strategy}_sq8"


def _same(a, b) -> None:
    """Two port results equal bit for bit: ids, dists, seven counters."""
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.dists.view(torch.int32), b.dists.view(torch.int32))
    for c in COUNTERS:
        assert torch.equal(getattr(a.stats, c), getattr(b.stats, c)), c


@pytest.mark.parametrize("S", [1, 3, 8])
def test_views_are_the_reference_blocks(S):
    fx = _fixture("sq8_exact")
    rg, rs = r_tiers(fx["jgraph"], fx["jstore"], S)
    tg, ts = shard_graph_tiers(fx["graph"], fx["store"], S)
    assert ts.n == fx["store"].n and ts.local_n == -(-fx["store"].n // S)
    assert tg.entry_point == int(np.asarray(rg.entry_point)[0])
    assert tg.local_entry == tuple(int(e) for e in np.asarray(rg.local_entry))
    # (L, S, rps, deg) here, (S, L, rps, deg) there
    np.testing.assert_array_equal(tg.neighbors.permute(1, 0, 2, 3).numpy(),
                                  np.asarray(rg.neighbors))
    for f in ("vectors", "norms_sq", "q_vectors", "q_norms_sq"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(rs, f)), err_msg=f)
    for f in ("q_scale", "q_mean"):
        for s in range(S):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(rs, f))[s])


def test_views_of_an_even_split_share_the_store():
    fx = _fixture("sq8_exact")
    g, s = shard_graph_tiers(fx["graph"], fx["store"], 4)     # 2000 / 4
    assert s.vectors.data_ptr() == fx["store"].vectors.data_ptr()
    assert s.q_vectors.data_ptr() == fx["store"].q_vectors.data_ptr()
    assert g.neighbors.data_ptr() == fx["graph"].neighbors.data_ptr()
    g, s = shard_graph_tiers(fx["graph"], fx["store"], 3, f32=False)
    assert s.vectors is None and s.norms_sq is None and s.has_sq8
    assert g.local_n == 667 and s.dim == fx["store"].dim


@pytest.mark.parametrize("quant", ["none", "sq8"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ["sq8_exact", "float"])
def test_lockstep_equals_the_unsharded_engine(kind, strategy, quant):
    """S in {1, 2, 4, 8}: bit-equal ids, dists and counters."""
    fx = _fixture(kind)
    p = torch_params(_params(strategy, quant))
    bm = fx["bitmaps"][WORKLOAD]
    base = T.make_executor(_method(strategy, quant), fx["store"],
                           graph=fx["graph"], device="cpu").search(
        fx["q"], bm, p)
    for S in (1, 2, 4, 8):
        ex = ShardedGraphExecutor(fx["graph"], fx["store"], S,
                                  strategy=strategy, graph_quant=quant,
                                  device="cpu")
        assert ex.name == f"sharded{S}_{_method(strategy, quant)}"
        _same(ex.search(fx["q"], bm, p), base)


@pytest.mark.parametrize("quant", ["none", "sq8"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_lockstep_equals_the_reference_sharded_executor(strategy, quant):
    fx = _fixture("sq8_exact")
    p = _params(strategy, quant)
    jres = RSharded(fx["jgraph"], fx["jstore"], 4, strategy=strategy,
                    graph_quant=quant).search(fx["jq"],
                                              fx["jbitmaps"][WORKLOAD], p)
    tres = ShardedGraphExecutor(fx["graph"], fx["store"], 4,
                                strategy=strategy, graph_quant=quant,
                                device="cpu").search(
        fx["q"], fx["bitmaps"][WORKLOAD], torch_params(p))
    assert_same(jres, tres)


@pytest.mark.parametrize("strategy,quant,S,E", [
    ("sweeping", "none", 2, 2), ("sweeping", "none", 2, 4),
    ("sweeping", "none", 4, 2), ("sweeping", "none", 4, 4),
    ("sweeping", "sq8", 4, 2), ("acorn", "none", 4, 2),
    ("navix", "none", 2, 4), ("unfiltered", "none", 4, 4)])
def test_drift_equals_the_reference(strategy, quant, S, E):
    """Induced-subgraph supersteps, beam exchanges, the collective
    finalize and the summed stats, bit for bit on the exact fixture."""
    fx = _fixture("sq8_exact")
    p = _params(strategy, quant, E)
    jres = RSharded(fx["jgraph"], fx["jstore"], S, strategy=strategy,
                    graph_quant=quant).search(fx["jq"],
                                              fx["jbitmaps"][WORKLOAD], p)
    tres = ShardedGraphExecutor(fx["graph"], fx["store"], S,
                                strategy=strategy, graph_quant=quant,
                                device="cpu").search(
        fx["q"], fx["bitmaps"][WORKLOAD], torch_params(p))
    assert_same(jres, tres)


def test_drift_recall_monotone_in_exchange_interval():
    """E = 1 is exact against the base engine; widening E only loses
    recall (within the reference's 0.05 slack), never below 0.5."""
    fx = _fixture("float")
    bm = fx["bitmaps"][WORKLOAD]
    _, truth = T.filtered_knn(fx["store"], fx["q"], bm, 10)

    def rec(ids):
        return float(T.recall_at_k(ids, truth, 10).mean())

    ex = ShardedGraphExecutor(fx["graph"], fx["store"], 2, device="cpu")
    recalls = {E: rec(ex.search(fx["q"], bm, torch_params(
        _params("sweeping", E=E))).ids) for E in (1, 2, 4, 8)}
    base = T.make_executor("sweeping", fx["store"], graph=fx["graph"],
                           device="cpu")
    assert recalls[1] == rec(base.search(fx["q"], bm, torch_params(
        _params("sweeping"))).ids)
    prev = recalls[1]
    for E in (2, 4, 8):
        assert recalls[E] <= prev + 0.05, recalls
        assert recalls[E] >= 0.5, recalls
        prev = recalls[E]


def _raises_same(rcall, tcall) -> None:
    with pytest.raises(ValueError) as rerr:
        rcall()
    with pytest.raises(ValueError) as terr:
        tcall()
    assert str(terr.value) == str(rerr.value)


def test_validations_match_the_reference():
    fx = _fixture("sq8_exact")
    rg, rst, rq, rbm = (fx["jgraph"], fx["jstore"], fx["jq"],
                        fx["jbitmaps"][WORKLOAD])
    tg, tst, tq, tbm = fx["graph"], fx["store"], fx["q"], fx["bitmaps"][
        WORKLOAD]
    rplain = R.VectorStore.build(np.asarray(rst.vectors))
    tplain = T.VectorStore(tst.vectors, tst.norms_sq)
    rengines = [r_engine(rst, graph=rg, capacity_frac=0.5)
                for _ in range(2)]
    tengines = [interop.storage_engine(e) for e in rengines]
    racct = r_storage(rengines, rst.n)
    tacct = make_sharded_storage(tengines, tst.n)

    def both(ctor_kw, params=None, stepped=False):
        def run(cls, g, st, q, bm, conv, acct):
            kw = dict(ctor_kw)
            if kw.pop("storage", False):
                kw["storage"] = acct
            if cls is ShardedGraphExecutor:
                kw["device"] = "cpu"
            ex = cls(g, st, kw.pop("S", 2), **kw)
            if params is not None:
                p = conv(params)
                if stepped:
                    return ex.init_frontier(q, bm, p)
                return ex.search(q, bm, p)
        _raises_same(lambda: run(RSharded, rg, rst, rq, rbm, lambda p: p,
                                 racct),
                     lambda: run(ShardedGraphExecutor, tg, tst, tq, tbm,
                                 torch_params, tacct))

    both({"strategy": "bogus"})
    both({"graph_quant": "sq4"})
    _raises_same(lambda: RSharded(rg, rplain, 2, graph_quant="sq8"),
                 lambda: ShardedGraphExecutor(tg, tplain, 2,
                                              graph_quant="sq8",
                                              device="cpu"))
    both({"f32": False})
    both({"S": 4, "storage": True})
    both({"strategy": "iterative_scan"}, _params("iterative_scan", E=2))
    both({"storage": True}, _params("sweeping", E=4))
    both({}, _params("sweeping", E=0))
    both({}, R.SearchParams(k=10, graph_exec_mode="vmapped"))
    both({"f32": False, "graph_quant": "sq8"}, _params("sweeping", "sq8"))
    both({}, _params("sweeping", E=2), stepped=True)
    # exclusion on a sharded store: search_batch's own refusal
    rgv, rsv = r_tiers(rg, rst, 2)
    tgv, tsv = shard_graph_tiers(tg, tst, 2)
    rx = R.SearchParams(k=10, strategy="sweeping", exclusion="prune")
    from repro.core.graph_search import search_batch as rsearch
    _raises_same(
        lambda: rsearch(rgv, rsv, rq, rbm, rx, excl=np.zeros((1, 1))),
        lambda: gs.search_batch(tgv, tsv, tq, tbm, torch_params(rx),
                                excl=gs.QueryRadii(torch.zeros(1, 1),
                                                   torch.zeros(1))))


@pytest.mark.parametrize("quant", ["none", "sq8"])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_sharded_storage_equals_the_reference(S, quant):
    """Merged and per-shard StorageStats, each pool at 0.5 / S of the
    pages, equal to the reference's; at S = 1 the merged stats equal the
    unsharded executor's with the same pool."""
    fx = _fixture("sq8_exact")
    p = _params("sweeping", quant)
    rengines = [r_engine(fx["jstore"], graph=fx["jgraph"],
                                      capacity_frac=0.5 / S)
                for _ in range(S)]
    tengines = [interop.storage_engine(e) for e in rengines]
    racct = r_storage(rengines, fx["jstore"].n)
    tacct = make_sharded_storage(tengines, fx["store"].n)
    jres = RSharded(fx["jgraph"], fx["jstore"], S, graph_quant=quant,
                    storage=racct).search(fx["jq"], fx["jbitmaps"][WORKLOAD],
                                          p)
    tres = ShardedGraphExecutor(fx["graph"], fx["store"], S,
                                graph_quant=quant, storage=tacct,
                                device="cpu").search(
        fx["q"], fx["bitmaps"][WORKLOAD], torch_params(p))
    assert_same(jres, tres)
    assert tres.storage.as_dict() == jres.storage.as_dict()
    assert len(tacct.last_per_shard) == S
    for a, b in zip(tacct.last_per_shard, racct.last_per_shard):
        assert a.as_dict() == b.as_dict()
        assert a.hit_rate == b.hit_rate
    st, rst = tacct.state(), racct.state()
    assert (st.capacity, st.used, dict(st.residency)) == \
        (rst.capacity, rst.used, dict(rst.residency))
    if S == 1:
        one = interop.storage_engine(r_engine(
            fx["jstore"], graph=fx["jgraph"], capacity_frac=0.5))
        base = T.make_executor(_method("sweeping", quant), fx["store"],
                               graph=fx["graph"], storage=one,
                               device="cpu").search(
            fx["q"], fx["bitmaps"][WORKLOAD], torch_params(p))
        assert base.storage.as_dict() == tres.storage.as_dict()


def test_continuous_server_over_shards_equals_over_graph_executor():
    fx = _fixture("sq8_exact")
    p = torch_params(_params("sweeping"))
    bm = fx["bitmaps"][WORKLOAD]
    nq = fx["q"].shape[0]
    reqs = [Request(rid=i, query=fx["q"][i], bitmap=bm[i])
            for i in range(nq)]
    out = {}
    for name, ex in (("base", T.GraphExecutor(fx["graph"], fx["store"])),
                     ("sharded", ShardedGraphExecutor(
                         fx["graph"], fx["store"], 4, device="cpu"))):
        recs, info = ContinuousServer(ex, p, width=4, hop_chunk=8).serve(
            reqs)
        out[name] = (results_in_order(recs, nq, p.k), info["ticks"])
    (bi, bd), bt = out["base"]
    (si, sd), st = out["sharded"]
    np.testing.assert_array_equal(si, bi)
    np.testing.assert_array_equal(sd.view(np.int32), bd.view(np.int32))
    assert st == bt


def test_stepped_delegates_equal_graph_executor():
    fx = _fixture("sq8_exact")
    p = torch_params(_params("sweeping"))
    bm = fx["bitmaps"][WORKLOAD]
    base = T.GraphExecutor(fx["graph"], fx["store"])
    ex = ShardedGraphExecutor(fx["graph"], fx["store"], 4, device="cpu")
    sb, ss = base.init_frontier(fx["q"], bm, p), ex.init_frontier(
        fx["q"], bm, p)
    for _ in range(3):
        sb = base.step_frontier(sb, p, 20)
        ss = ex.step_frontier(ss, p, 20)
    for a, b in zip(base.finalize_frontier(sb, p)[:2],
                    ex.finalize_frontier(ss, p)[:2]):
        assert torch.equal(a, b)
    idle = ex.idle_frontier(p, 3)
    assert bool(idle.done.all()) and idle.visited.shape == (
        3, fx["store"].n + 1)
    lane = ex.init_frontier(fx["q"][:1], bm[:1], p)
    idle = ex.write_frontier_slot(idle, lane, 1)
    assert torch.equal(idle.w_id[1], lane.w_id[0])


def test_beam_exchange_keeps_the_first_copy_and_drops_padding():
    """Copies of an id (which an earlier exchange made) collapse to one,
    -1 drops, W becomes the global top-ef on every state, and the fresh
    ids join each pool and visited map."""
    fx = _fixture("sq8_exact")
    p = torch_params(_params("sweeping"))
    gv, sv = shard_graph_tiers(fx["graph"], fx["store"], 2)
    q, bm = fx["q"][:2], fx["bitmaps"][WORKLOAD][:2]
    states = [gs.frontier_init(gv.select(i, False, True),
                               sv.select(i, False), q, bm, p)
              for i in range(2)]
    ef = states[0].w_d.shape[1]
    inf = float("inf")
    states[0].w_d[:] = inf
    states[0].w_id[:] = -1
    states[1].w_d[:] = inf
    states[1].w_id[:] = -1
    states[0].w_d[:, :3] = torch.tensor([1.0, 2.0, 5.0])
    states[0].w_id[:, :3] = torch.tensor([7, 9, 11])
    states[1].w_d[:, :2] = torch.tensor([2.0, 3.0])
    states[1].w_id[:, :2] = torch.tensor([9, 13])
    out = gs.beam_exchange(sv, states, p, gv.coll)
    for s in out:
        assert s.w_id[:, :4].tolist() == [[7, 9, 13, 11]] * 2
        assert s.w_d[:, :4].tolist() == [[1.0, 2.0, 3.0, 5.0]] * 2
        assert bool((s.w_id[:, 4:] == -1).all()) and s.w_d.shape[1] == ef
        assert bool(s.visited[:, [7, 9, 11, 13]].all())
