"""The library half of the paper's tables and figures, port against the
reference on the same numpy inputs: query hardness (Table 2's LID, LRC and
distance-versus-filter cost), the workload grid and distance order, modeled
QPS and the measured miss penalty, and the incremental HNSW builder."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.hardness as RH
import repro.storage as RS
import repro_torch.core as T
import repro_torch.core.hardness as TH
import repro_torch.storage as TS
from repro.data import DatasetSpec, make_dataset
from repro_torch import interop
from torch_parity import exact_fixture, run_both


def _clustered(metric: str, n: int = 3000, dim: int = 32, nq: int = 40):
    jstore, jq = make_dataset(DatasetSpec(f"t-hard-{metric}", n, dim, metric,
                                          clusters=8), num_queries=nq,
                              seed=3)
    return jstore, jq, interop.vector_store(jstore, "cpu"), torch.as_tensor(
        np.asarray(jq))


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_lid_mle_matches_the_reference(metric, k):
    jstore, jq, store, q = _clustered(metric)
    want = RH.lid_mle(jstore, jnp.asarray(jq), k=k)
    got = TH.lid_mle(store, q, k=k, device="cpu")
    assert want > 0 and got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("k,sel,corr", [(10, 0.1, "low_pos"),
                                        (5, 0.02, "none"),
                                        (20, 0.5, "high_pos"),
                                        (10, 0.2, "negative")])
def test_lrc_matches_the_reference(monkeypatch, k, sel, corr):
    """The two generators draw different rows (jax.random against
    torch.Generator), so the reference's passing rows are handed to the
    port."""
    from repro.core.workload import generate_passing_rows as ref_rows
    jstore, jq, store, q = _clustered("l2", n=2000, nq=24)
    rows = ref_rows(jstore, jnp.asarray(jq), R.WorkloadSpec(sel, corr), 7)
    seen = []

    def passing(store_, queries, spec, seed=0, device="cuda"):
        seen.append((spec, seed))
        return torch.as_tensor(np.stack([np.asarray(r) for r in rows]))

    monkeypatch.setattr(T.workload, "generate_passing_rows", passing)
    want = RH.lrc(jstore, jnp.asarray(jq), k=k, selectivity=sel, seed=7,
                  correlation=corr)
    got = TH.lrc(store, q, k=k, selectivity=sel, seed=7, correlation=corr,
                 device="cpu")
    assert seen == [(T.WorkloadSpec(sel, corr), 7)]
    assert 0.0 <= got <= 1.0
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_dist_filter_relative_cost_runs_on_the_cpu():
    cost = TH.dist_filter_relative_cost(32, trials=5, n=1024, device="cpu")
    assert np.isfinite(cost) and cost > 0


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_query_distance_order_matches_the_reference(metric):
    """A float store whose distances sit well apart (the fixture asserts
    it), so sums in another order cannot swap two rows."""
    rng = np.random.RandomState(40)
    x = rng.randn(64, 8).astype(np.float32)
    qx = rng.randn(4, 8).astype(np.float32)
    jstore = R.VectorStore.build(x, metric=metric)
    want = np.asarray(R.workload.query_distance_order(jstore,
                                                      jnp.asarray(qx)))
    d = np.sort(np.asarray(R.workload.full_distances(jstore,
                                                     jnp.asarray(qx))), 1)
    assert np.diff(d, axis=1).min() > 1e-5 * np.abs(d).max()
    got = T.workload.query_distance_order(interop.vector_store(jstore, "cpu"),
                                          torch.as_tensor(qx))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_grid_is_keyed_and_seeded_like_the_reference(monkeypatch):
    """The full 9 x 5 grid: the same keys in the same order, each cell drawn
    at the reference's stepped seed (one more per cell, correlation-major);
    the draws themselves are recorded, not made."""
    calls = {"ref": [], "port": []}

    def recorder(side):
        def draw(store, queries, spec, seed=0, **kw):
            calls[side].append((spec.selectivity, spec.correlation, seed))
            return len(calls[side])
        return draw

    monkeypatch.setattr(R.workload, "generate_bitmaps", recorder("ref"))
    monkeypatch.setattr(T.workload, "generate_bitmaps", recorder("port"))
    want = R.generate_grid(None, None, seed=5)
    got = T.generate_grid(None, None, seed=5, device="cpu")
    assert T.PAPER_SELECTIVITIES == R.PAPER_SELECTIVITIES
    assert list(got) == list(want) and len(got) == 45
    assert list(got.values()) == list(want.values())
    assert calls["port"] == calls["ref"]
    assert calls["port"][0] == (0.01, "high_pos", 5)
    assert calls["port"][-1] == (0.9, "none", 49)


@pytest.mark.parametrize("corr", ["med_pos", "none"])
def test_generate_grid_cells_are_the_ports_own_bitmaps(corr):
    jstore, jq, store, q = _clustered("l2", n=700, nq=6)
    sels = (0.01, 0.3, 0.9)
    grid = T.generate_grid(store, q, sels, (corr, "low_pos"), seed=2,
                           device="cpu")
    assert list(grid) == [(s, c) for c in (corr, "low_pos") for s in sels]
    for i, ((sel, c), bm) in enumerate(grid.items()):
        assert torch.equal(bm, T.generate_bitmaps(
            store, q, T.WorkloadSpec(sel, c), 2 + i, device="cpu"))
        pop = T.bitmap_popcount(bm)
        assert bool((pop == max(1, round(sel * store.n))).all())


def _stats_pair():
    fx = exact_fixture()
    p = R.SearchParams(k=10, ef_search=32, beam_width=64, strategy="acorn")
    je = RS.make_storage_engine(fx["jstore"], fx["jscann"], fx["jgraph"],
                                capacity_frac=0.3, policy="lru")
    jres, tres = run_both(fx, "acorn", p, storage=(je, interop.storage_engine(
        je)))
    return fx, jres, tres


@pytest.mark.parametrize("threads,overhead", [(1, None), (16, None),
                                              (8, None), (8, {8: 1.25})])
@pytest.mark.parametrize("regime", ["SYSTEM", "LIBRARY"])
def test_modeled_qps_matches_the_reference(regime, threads, overhead):
    fx, jres, tres = _stats_pair()
    dim = fx["store"].dim
    want = R.modeled_qps(jres.stats, dim, getattr(R, regime),
                         threads=threads, thread_overhead=overhead)
    got = T.modeled_qps(tres.stats, dim, getattr(T, regime),
                        threads=threads, thread_overhead=overhead)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("batch_q", [0, 1, 16, 1000])
@pytest.mark.parametrize("regime", ["SYSTEM", "LIBRARY"])
def test_measured_miss_penalty_matches_the_reference(regime, batch_q):
    """On the reference's StorageStats of one storage search, carried
    across field by field into the port's."""
    _, jres, _ = _stats_pair()
    js = jres.storage
    assert js.miss_total > 0
    ts = TS.StorageStats(**{f.name: getattr(js, f.name)
                            for f in dataclasses.fields(js)})
    want = R.measured_miss_penalty(js, batch_q, getattr(R, regime))
    got = T.measured_miss_penalty(ts, batch_q, getattr(T, regime))
    assert got == pytest.approx(want, rel=1e-9)


def test_build_incremental_matches_the_reference():
    """The reference test's store and settings: neighbour tables, levels
    and entry point byte for byte."""
    jstore, _ = make_dataset(DatasetSpec("t-inc", 600, 24, "l2", clusters=8),
                             num_queries=5, seed=1)
    want = R.build_incremental(jstore, m=8, ef_construction=40, seed=0)
    got = T.build_incremental(interop.vector_store(jstore, "cpu"), m=8,
                              ef_construction=40, seed=0, device="cpu")
    assert got.neighbors.dtype == torch.int32
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    np.testing.assert_array_equal(got.node_level.numpy(),
                                  np.asarray(want.node_level))
    assert got.entry_point == int(want.entry_point) and got.m == want.m
