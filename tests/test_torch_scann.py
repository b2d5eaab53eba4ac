"""ScaNN of the port against the reference: search on the reference's own
index (carried across), both page-accounting modes, query-block tiling, the
budget clamp, and the port's own builder (tensors on the CPU)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.scann import _kmeans as jkmeans
from repro.core.scann import _unique_pad as junique_pad
import repro_torch.core as T
from repro_torch.core.scann import _kmeans, _segment_sum, _unique_pad
from torch_parity import fixture_kind  # noqa: F401
from torch_parity import FIXTURES, check, run_both, torch_params

BASE = R.SearchParams(k=10, num_leaves_to_search=8, reorder_factor=4)


@pytest.mark.parametrize("accounting", ["batch", "per_query"])
@pytest.mark.parametrize("workload", ["med_pos_0.1", "none_0.02"])
def test_scann_search_parity(fixture_kind, accounting, workload):
    p = dataclasses.replace(BASE, scann_page_accounting=accounting)
    jres, tres = run_both(FIXTURES[fixture_kind](), "scann", p, workload)
    check(fixture_kind, jres, tres)


@pytest.mark.parametrize("block", [3, 5])
def test_scann_query_block_invariance(block):
    fx = FIXTURES["exact"]()
    p = dataclasses.replace(BASE, scann_query_block=block)
    jres, tres = run_both(fx, "scann", p)
    check("exact", jres, tres)     # tiled: the same counters as the reference
    whole = T.make_executor("scann", fx["store"], index=fx["scann"],
                            device="cpu").search(
        fx["q"], fx["bitmaps"]["med_pos_0.1"], torch_params(BASE))
    assert torch.equal(whole.ids, tres.ids)
    assert torch.equal(whole.dists, tres.dists)


def test_scann_budget_clamp_matches_reference():
    fx = FIXTURES["exact"]()
    for budget in (dict(page_budget=30), dict(hop_budget=3),
                   dict(deadline_cycles=2e6)):
        p = dataclasses.replace(BASE, **budget)
        want = R.leaves_within_budget(fx["jscann"], fx["jstore"], p)
        got = T.leaves_within_budget(fx["scann"], fx["store"],
                                     torch_params(p))
        assert got == want
        jres, tres = run_both(fx, "scann", p)
        check("exact", jres, tres)
        np.testing.assert_array_equal(tres.anytime.budget_exhausted,
                                      jres.anytime.budget_exhausted)


def test_unique_pad_matches_reference():
    ids = np.array([7, 3, 3, 0, 9, 7], np.int32)
    m, v, inv = junique_pad(__import__("jax").numpy.asarray(ids), 12, 8)
    gm, gv, ginv = _unique_pad(torch.as_tensor(ids), 12, 8)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(m))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(v))
    valid = np.asarray(v)
    np.testing.assert_array_equal(ginv.numpy()[np.asarray(m)[valid]],
                                  np.asarray(inv)[np.asarray(m)[valid]])
    sm, sv, _ = _unique_pad(torch.as_tensor(ids), 12)
    assert sm.tolist() == [0, 3, 7, 9] and bool(sv.all())


def test_kmeans_assignments_match_reference():
    # sums run in another order (numpy vs torch), so only >= 99 % of the
    # assignments are required to agree; in practice they all do
    fx = FIXTURES["float"]()
    x = np.asarray(fx["jstore"].vectors)
    jc, ja = jkmeans(x, 40, seed=3)
    tc, ta = _kmeans(fx["store"].vectors, 40, seed=3)
    assert (ta.numpy() == ja).mean() >= 0.99
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,k,skew", [(5000, 40, False), (3000, 64, True),
                                       (7, 10, False)])
def test_segment_sum_is_np_add_at(n, k, skew):
    # the k-means centroid sums: np.add.at's order, byte for byte, with
    # empty and lopsided groups
    rs = np.random.RandomState(n + k)
    x = rs.randn(n, 24)
    a = rs.randint(0, k, n)
    if skew:
        a[rs.rand(n) < 0.7] = 5
    a[a == 1] = 2
    want = np.zeros((k, x.shape[1]))
    np.add.at(want, a, x)
    got = _segment_sum(torch.as_tensor(x), torch.as_tensor(a), k)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [1, 2])
def test_build_scann_matches_reference(levels):
    fx = FIXTURES["float"]()
    js = R.build_scann(fx["jstore"], num_leaves=48, levels=levels, seed=1)
    ts = T.build_scann(fx["store"], num_leaves=48, levels=levels, seed=1,
                       device="cpu")
    assert ts.levels == js.levels
    assert tuple(ts.leaf_rowids.shape) == np.asarray(js.leaf_rowids).shape
    assert (ts.leaf_rowids.numpy() == np.asarray(js.leaf_rowids)).mean() \
        >= 0.99
    np.testing.assert_array_equal(ts.scale.numpy(), np.asarray(js.scale))
    np.testing.assert_array_equal(ts.mean.numpy(), np.asarray(js.mean))
    assert (ts.leaf_tiles.numpy() == np.asarray(js.leaf_tiles)).mean() \
        >= 0.99
    np.testing.assert_allclose(ts.row_norms_sq.numpy(),
                               np.asarray(js.row_norms_sq), rtol=1e-5)
    np.testing.assert_array_equal(ts.pca.numpy(), np.asarray(js.pca))
    if levels == 2:
        assert (ts.branch_leaves.numpy()
                == np.asarray(js.branch_leaves)).mean() >= 0.99


def test_build_scann_with_pca():
    # the PCA rotation's eigenvector signs are solver-dependent, so the
    # projected index is checked for its properties, not against the
    # reference's bits
    fx = FIXTURES["float"]()
    ts = T.build_scann(fx["store"], num_leaves=32, levels=2, pca_dims=24,
                       seed=0, device="cpu")
    proj = ts.pca[:-1]
    assert tuple(proj.shape) == (48, 24) and ts.leaf_tiles.shape[2] == 24
    torch.testing.assert_close(proj.T @ proj, torch.eye(24), atol=1e-4,
                               rtol=0)
    bm = fx["bitmaps"]["med_pos_0.1"]
    _, truth = T.filtered_knn(fx["store"], fx["q"], bm, 10)
    res = T.make_executor("scann", fx["store"], index=ts,
                          device="cpu").search(
        fx["q"], bm, torch_params(dataclasses.replace(
            BASE, num_leaves_to_search=16)))
    assert float(T.recall_at_k(res.ids, truth, 10).mean()) >= 0.8


def test_own_index_search_recall():
    fx = FIXTURES["float"]()
    ts = T.build_scann(fx["store"], num_leaves=48, levels=2, seed=0,
                       device="cpu")
    bm = fx["bitmaps"]["med_pos_0.1"]
    _, truth = T.filtered_knn(fx["store"], fx["q"], bm, 10)
    res = T.make_executor("scann", fx["store"], index=ts,
                          device="cpu").search(
        fx["q"], bm, torch_params(dataclasses.replace(
            BASE, num_leaves_to_search=16)))
    assert float(T.recall_at_k(res.ids, truth, 10).mean()) >= 0.9
