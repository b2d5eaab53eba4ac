"""The selectivity-aware tiers of the port against the reference: FAVOR
exclusion radii and the `frontier_scan_excl[_sq8]` kernels' plain versions,
the family workload, JAG partitioned graphs, and the `sweeping_excl[_sq8]`
and `partitioned[_sq8]` methods.

Tolerances: kernel distances rtol 1e-5, atol 1e-4 (as the other kernels);
keep masks exact; radii exact on the integer fixture; on the SQ8-exact
fixture ids, distances and all seven counters bit-equal; on the float
fixture recall within 0.01 and each counter's mean within 2 %.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core.types import words_from_uint32
from repro_torch.kernels import ops, ref
from torch_parity import assert_close, assert_same, run_both, tiers

RTOL, ATOL = 1e-5, 1e-4
MARGIN = 0.3
P = R.SearchParams(k=10, ef_search=48, beam_width=128, max_hops=512,
                   num_leaves_to_search=12, reorder_factor=4,
                   exclusion_margin=MARGIN)


def _excl_inputs(seed=7, q=6, c=40, n=300, d=48, sq8=False):
    rng = np.random.RandomState(seed)
    queries = rng.randn(q, d).astype(np.float32)
    if sq8:
        rows = rng.randint(-127, 128, size=(n, d)).astype(np.int8)
        scale = (rng.rand(d) * 0.02 + 0.001).astype(np.float32)
        mean = (rng.randn(d) * 0.1).astype(np.float32)
        x = rows.astype(np.float32) * scale + mean
        queries *= 0.3
    else:
        rows = x = rng.randn(n, d).astype(np.float32)
        scale = mean = None
    norms = (x * x).sum(-1)
    ids = rng.randint(-1, n, size=(q, c)).astype(np.int32)
    ids[:, -3:] = -1
    bm = rng.randint(0, 2 ** 32, size=(q, (n + 31) // 32),
                     dtype=np.uint64).astype(np.uint32)
    # radius table: 3 rows; queries read different rows
    table = (rng.rand(3, n) * (8.0 if sq8 else 100.0)).astype(np.float32)
    table[0, :5] = 0.0
    row = rng.randint(0, 3, size=q).astype(np.int32)
    tau = (rng.rand(q) * 40.0).astype(np.float32)
    tau[0] = np.inf                            # W not full: keep everything
    return queries, rows, scale, mean, norms, ids, bm, table, row, tau


@pytest.mark.parametrize("sq8", [False, True])
def test_frontier_scan_excl_plain_vs_oracle_and_pallas(sq8):
    (queries, rows, scale, mean, norms, ids, bm, table, row,
     tau) = _excl_inputs(sq8=sq8)
    safe = np.maximum(ids, 0)
    e = table[row[:, None], safe]                     # the gathered radii
    j = lambda a: jnp.asarray(a)                      # noqa: E731
    t = lambda a: torch.as_tensor(a)                  # noqa: E731
    if sq8:
        jargs = (j(queries), j(rows[safe]), j(scale), j(mean),
                 j(norms[safe]), j(ids), j(bm), j(e), j(tau[:, None]))
        want = jref.frontier_scan_excl_sq8_ref(*jargs, margin=MARGIN)
        pallas = jops.frontier_scan_excl_sq8(*jargs, margin=MARGIN,
                                             use_pallas=True)
        got = ops.frontier_scan_excl_sq8(
            t(queries), t(rows), t(scale), t(mean), t(norms), t(ids),
            words_from_uint32(bm, "cpu"), t(table), t(row), t(tau),
            margin=MARGIN)
    else:
        jargs = (j(queries), j(rows[safe]), j(norms[safe]), j(ids), j(bm),
                 j(e), j(tau[:, None]))
        want = jref.frontier_scan_excl_ref(*jargs, margin=MARGIN)
        pallas = jops.frontier_scan_excl(*jargs, margin=MARGIN,
                                         use_pallas=True)
        got = ops.frontier_scan_excl(
            t(queries), t(rows), t(norms), t(ids),
            words_from_uint32(bm, "cpu"), t(table), t(row), t(tau),
            margin=MARGIN)
    gd, gp, gk = (g.numpy() for g in got)
    for wd, wp, wk in (want, pallas):
        _close_d(gd, wd)
        np.testing.assert_array_equal(gp, np.asarray(wp))
        np.testing.assert_array_equal(gk, np.asarray(wk))
    # the keep rule on the port's own distances, padding kept
    np.testing.assert_array_equal(gk, ref.excl_keep_mask(
        got[0], torch.as_tensor(e), torch.as_tensor(tau)[:, None], got[1],
        MARGIN).numpy())
    assert gk[ids < 0].all() and gk[0].all()
    assert not gk.all()                               # something is pruned


@pytest.mark.parametrize("margin", [0.0, MARGIN, 1.0])
@pytest.mark.parametrize("sq8", [False, True])
def test_frontier_scan_excl_plain_vs_reference_at_each_margin(sq8, margin):
    """The port's plain exclusion scans against the reference's on the
    integer fixture (integer queries and rows, SQ8 scale 1 and mean 0, so
    every product and sum is exact): dist, pass and keep equal, with -1
    padding, a zero radius a row and a fifth of tau +inf.  At margin 0 the
    rule's bound for padding is 0 * inf = NaN: no padded id is kept."""
    rng = np.random.RandomState(int(margin * 10) + 2 * sq8)
    q, c, n, d = 9, 40, 300, 32
    queries = rng.randint(-127, 128, (q, d)).astype(np.float32)
    ints = rng.randint(-127, 128, (n, d))
    rows = ints.astype(np.int8) if sq8 else ints.astype(np.float32)
    x = ints.astype(np.float32)
    norms = (x * x).sum(-1)
    ids = rng.randint(-1, n, (q, c)).astype(np.int32)
    ids[:, -3:] = -1
    ids[1] = -1
    bm = rng.randint(0, 2 ** 32, size=(q, (n + 31) // 32),
                     dtype=np.uint64).astype(np.uint32)
    table = rng.randint(0, 4 * d * 127 ** 2, (3, n)).astype(np.float32)
    table[:, ::7] = 0.0
    row = rng.randint(0, 3, q).astype(np.int32)
    tau = rng.randint(0, 2 * d * 127 ** 2, q).astype(np.float32)
    tau[rng.rand(q) < 0.2] = np.inf
    safe = np.maximum(ids, 0)
    e = table[row[:, None], safe]                     # the reference's gather
    j = lambda a: jnp.asarray(a)                      # noqa: E731
    t = lambda a: torch.as_tensor(a)                  # noqa: E731
    bmw = words_from_uint32(bm, "cpu")
    if sq8:
        scale, mean = np.ones(d, np.float32), np.zeros(d, np.float32)
        want = jref.frontier_scan_excl_sq8_ref(
            j(queries), j(rows[safe]), j(scale), j(mean), j(norms[safe]),
            j(ids), j(bm), j(e), j(tau[:, None]), margin=margin)
        got = ref.frontier_scan_excl_sq8_ref(
            t(queries), t(rows), t(scale), t(mean), t(norms), t(ids), bmw,
            t(table), t(row), t(tau), margin=margin)
    else:
        want = jref.frontier_scan_excl_ref(
            j(queries), j(rows[safe]), j(norms[safe]), j(ids), j(bm), j(e),
            j(tau[:, None]), margin=margin)
        got = ref.frontier_scan_excl_ref(
            t(queries), t(rows), t(norms), t(ids), bmw, t(table), t(row),
            t(tau), margin=margin)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2].numpy()
    if margin == 0.0:
        assert not keep[ids < 0].any()
    else:
        assert keep[ids < 0].all()
    assert keep.any() and not keep.all()


def _close_d(got, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_excl_keep_mask_matches_reference_exactly():
    rng = np.random.RandomState(8)
    d = rng.rand(50, 20).astype(np.float32) * 10
    d[0, :3] = np.inf
    e = rng.rand(50, 20).astype(np.float32) * 10
    tau = rng.rand(50, 1).astype(np.float32) * 10
    ok = rng.rand(50, 20) < 0.2
    want = jref.excl_keep_mask(jnp.asarray(d), jnp.asarray(e),
                               jnp.asarray(tau), jnp.asarray(ok), MARGIN)
    got = ref.excl_keep_mask(torch.as_tensor(d), torch.as_tensor(e),
                             torch.as_tensor(tau), torch.as_tensor(ok),
                             MARGIN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["sq8_exact", "float"])
def test_build_exclusion_matches_reference(kind):
    fx = tiers(kind)
    got = T.build_exclusion(fx["store"], families=fx["fams"], device="cpu")
    want = fx["jexcl"]
    assert got.family_tags == want.family_tags
    assert got.ladder_ks == want.ladder_ks
    np.testing.assert_array_equal(T.words_to_uint32(got.family_bitmaps),
                                  np.asarray(want.family_bitmaps))
    if kind == "sq8_exact":                 # integer rows: exact radii
        np.testing.assert_array_equal(got.ladder.numpy(),
                                      np.asarray(want.ladder))
        np.testing.assert_array_equal(got.family_radii.numpy(),
                                      np.asarray(want.family_radii))
    else:
        np.testing.assert_allclose(got.ladder.numpy(),
                                   np.asarray(want.ladder), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got.family_radii.numpy(),
                                   np.asarray(want.family_radii), rtol=1e-4,
                                   atol=1e-4)
    # a passing row's family radius is 0, and only a passing row's
    bits = T.unpack_bitmap(got.family_bitmaps, got.n)
    assert bool(((got.family_radii == 0) == bits).all())


@pytest.mark.parametrize("workload", ["family", "none_0.02", "med_pos_0.1"])
def test_select_radii_and_match_match_reference(workload):
    fx = tiers("sq8_exact")
    jbm, bm = fx["jbitmaps"][workload], fx["bitmaps"][workload]
    np.testing.assert_array_equal(
        T.match_families(fx["excl"], bm).numpy(),
        np.asarray(R.match_families(fx["jexcl"], jbm)))
    want = np.asarray(R.select_radii(fx["jexcl"], jbm))
    got = T.select_radii(fx["excl"], bm)
    assert got.rows.shape == (bm.shape[0],)
    assert got.table.data_ptr() == fx["excl"].radii.data_ptr()  # no copy
    np.testing.assert_array_equal(got.dense().numpy(), want)


def test_ladder_rung_matches_reference():
    fx = tiers("sq8_exact")
    for s in (1.0, 0.5, 0.1, 0.02, 0.003, 1e-6):
        assert T.ladder_rung(fx["excl"], s) == R.ladder_rung(fx["jexcl"], s)


def test_generate_families_popcount_and_nearest_rows():
    fx = tiers("float")
    store = fx["store"]
    fams = T.generate_families(store, 0.05, num_families=4, seed=0,
                               device="cpu")
    assert sorted(fams) == sorted(fx["jfams"])
    n_sel = int(np.ceil(0.05 * store.n))
    centers = np.random.RandomState(0).choice(store.n, 4, replace=False)
    for f, tag in enumerate(sorted(fams)):
        bits = T.unpack_bitmap(fams[tag], store.n)
        assert int(bits.sum()) == n_sel
        d = T.full_distances(store, store.vectors[int(centers[f])][None])[0]
        # every passing row is at least as near the centre as every other
        assert float(d[bits].max()) <= float(d[~bits].min())
        ref_bits = R.unpack_bitmap(np.asarray(fx["jfams"][tag]), store.n)
        assert (bits.numpy() != ref_bits).sum() <= 2   # ties may differ


def test_assign_family_bitmaps_matches_reference():
    fx = tiers("sq8_exact")
    bm, assign = T.assign_family_bitmaps(fx["fams"], 16, seed=1)
    np.testing.assert_array_equal(assign, fx["assign"])
    np.testing.assert_array_equal(T.words_to_uint32(bm),
                                  np.asarray(fx["jbitmaps"]["family"]))


@pytest.mark.parametrize("method,workload,mode", [
    ("sweeping_excl", "family", "prune_exact"),
    ("sweeping_excl", "none_0.02", "prune"),
    ("sweeping_excl", "med_pos_0.1", "prune"),
    ("sweeping_excl_sq8", "family", "prune_exact"),
    ("sweeping_excl_sq8", "none_0.02", "prune"),
])
def test_sweeping_excl_bit_equal_on_sq8_exact_fixture(method, workload,
                                                      mode):
    jres, tres = run_both(tiers("sq8_exact"), method, P, workload)
    assert_same(jres, tres)
    assert tres.plan.params.exclusion == mode == jres.plan.params.exclusion


@pytest.mark.parametrize("method", ["partitioned", "partitioned_sq8"])
def test_partitioned_bit_equal_on_sq8_exact_fixture(method):
    jres, tres = run_both(tiers("sq8_exact"), method, P, "family")
    assert_same(jres, tres)


@pytest.mark.parametrize("unmatched", ["one", "repeated"])
def test_partitioned_fallback_bit_equal(unmatched):
    # queries that match no family run the base sweeping executor; the
    # plan-time match is charged once per distinct bitmap, also when
    # unmatched queries share one
    fx = tiers("sq8_exact")
    jbm = fx["jbitmaps"]["family"]
    other = fx["jbitmaps"]["none_0.02"]
    tail = other[-1:] if unmatched == "one" \
        else jnp.concatenate([other[-2:-1], other[-2:-1], other[-1:]])
    mixed_j = jnp.concatenate([jbm[:-tail.shape[0]], tail])
    fx = dict(fx, jbitmaps=dict(fx["jbitmaps"], mixed=mixed_j),
              bitmaps=dict(fx["bitmaps"], mixed=interop.bitmaps(mixed_j,
                                                               "cpu")))
    jres, tres = run_both(fx, "partitioned", P, "mixed")
    assert_same(jres, tres)


@pytest.mark.parametrize("method,workload", [
    ("sweeping_excl", "family"), ("sweeping_excl_sq8", "family"),
    ("sweeping_excl", "none_0.02"), ("partitioned", "family"),
    ("partitioned_sq8", "family")])
def test_tiers_close_on_float_fixture(method, workload):
    jres, tres = run_both(tiers("float"), method, P, workload)
    assert_close(jres, tres)


def test_exclusion_prunes_hops_on_family_batch():
    fx = tiers("float")
    _, base = run_both(fx, "sweeping", P, "family")
    _, excl = run_both(fx, "sweeping_excl", P, "family")
    assert float(excl.stats.hops.double().mean()) < \
        float(base.stats.hops.double().mean())


def test_port_built_partitions_serve_their_families():
    fx = tiers("float")
    store = T.quantize_store(fx["store"])
    pg = T.build_graph_partitioned(store, fx["fams"], m=8,
                                   ef_construction=32, seed=0, device="cpu")
    assert pg.tags == fx["jparts"].tags and pg.built_n == store.n
    for part, jpart in zip(pg.partitions, fx["jparts"].partitions):
        np.testing.assert_array_equal(part.rows.numpy(),
                                      np.asarray(jpart.rows))
        assert part.store.has_sq8 and part.graph.n == part.rows.numel()
    bm = fx["bitmaps"]["family"]
    np.testing.assert_array_equal(pg.match(bm).numpy(), fx["assign"])
    ex = T.make_executor("partitioned", store, graph=fx["graph"],
                         partitions=pg, device="cpu")
    res = ex.search(fx["q"], bm, T.SearchParams(k=10, ef_search=48,
                                                beam_width=128))
    _, truth = T.filtered_knn(store, fx["q"], bm, 10)
    assert float(T.recall_at_k(res.ids, truth, 10).mean()) >= 0.9


def test_exclusion_validation():
    fx = tiers("sq8_exact")
    with pytest.raises(ValueError, match="sweeping"):
        T.GraphExecutor(fx["graph"], fx["store"], strategy="acorn",
                        exclusion=fx["excl"])
    with pytest.raises(ValueError, match="need graph= and exclusion="):
        T.make_executor("sweeping_excl", fx["store"], graph=fx["graph"],
                        device="cpu")
    p = T.SearchParams(exclusion="prune")
    with pytest.raises(ValueError, match="per-query radii"):
        T.search_batch(fx["graph"], fx["store"], fx["q"],
                       fx["bitmaps"]["family"], p)
    radii = T.select_radii(fx["excl"], fx["bitmaps"]["family"])
    with pytest.raises(ValueError, match="exclusion='none'"):
        T.search_batch(fx["graph"], fx["store"], fx["q"],
                       fx["bitmaps"]["family"], T.SearchParams(), excl=radii)
    with pytest.raises(ValueError, match="margin"):
        T.search_batch(fx["graph"], fx["store"], fx["q"],
                       fx["bitmaps"]["family"],
                       dataclasses.replace(p, exclusion_margin=0.0),
                       excl=radii)
    with pytest.raises(ValueError, match="no partitions"):
        T.PartitionedGraphExecutor(T.PartitionedGraph((), fx["store"].n),
                                   fx["store"])
    plain = T.VectorStore(fx["store"].vectors, fx["store"].norms_sq)
    bare = T.build_graph_partitioned(plain, {"f": fx["fams"][
        sorted(fx["fams"])[0]]}, m=8, ef_construction=16, device="cpu")
    with pytest.raises(ValueError, match="quantize_store"):
        T.PartitionedGraphExecutor(bare, plain, graph_quant="sq8")
