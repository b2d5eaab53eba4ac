"""Datasets, workload bitmaps and the bruteforce ground truth of the port
against the reference (tensors on the CPU)."""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.data import DatasetSpec as JSpec
from repro.data import make_dataset as jmake
import repro_torch.core as T
from repro_torch.core.workload import empirical_correlation
from repro_torch.data import DatasetSpec, make_dataset
from torch_parity import exact_fixture, float_fixture


@pytest.mark.parametrize("args", [
    ("a", 1500, 48, "l2", 16, False),
    ("b", 700, 32, "ip", 8, False),
    ("c", 900, 40, "l2", 12, True),
])
def test_make_dataset_byte_identical(args):
    name, n, dim, metric, clusters, ood = args
    jstore, jq = jmake(JSpec(name, n, dim, metric, clusters=clusters,
                             ood_queries=ood), num_queries=9, seed=3)
    store, q = make_dataset(DatasetSpec(name, n, dim, metric,
                                        clusters=clusters, ood_queries=ood),
                            num_queries=9, seed=3, device="cpu")
    assert store.vectors.dtype == torch.float32 and q.dtype == torch.float32
    np.testing.assert_array_equal(store.vectors.numpy(),
                                  np.asarray(jstore.vectors))
    np.testing.assert_array_equal(q.numpy(), jq)
    # the squared norms are a float32 sum in another order
    np.testing.assert_allclose(store.norms_sq.numpy(),
                               np.asarray(jstore.norms_sq), rtol=1e-6)


@pytest.fixture(scope="module")
def small():
    return make_dataset(DatasetSpec("w", 3000, 32, "l2", clusters=12),
                        num_queries=12, seed=0, device="cpu")


@pytest.mark.parametrize("corr", T.CORRELATIONS)
@pytest.mark.parametrize("sel", [0.01, 0.1, 0.5])
def test_generate_bitmaps_popcount_exact(small, corr, sel):
    store, q = small
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(sel, corr), seed=4,
                            device="cpu")
    assert bm.dtype == torch.int32 and bm.shape == (12, (3000 + 31) // 32)
    want = round(sel * store.n)
    assert T.bitmap_popcount(bm).tolist() == [want] * 12
    # no bit past row n - 1
    assert not T.unpack_bitmap(bm, bm.shape[1] * 32)[:, store.n:].any()


def test_generate_bitmaps_correlation_order(small):
    store, q = small
    corr = {}
    for c in T.CORRELATIONS:
        rows = T.generate_passing_rows(store, q, T.WorkloadSpec(0.1, c),
                                       seed=5, device="cpu")
        assert all(len(set(r.tolist())) == r.numel() for r in rows)
        corr[c] = np.mean([empirical_correlation(store, q[i], rows[i])
                           for i in range(q.shape[0])])
    assert corr["high_pos"] > corr["med_pos"] > corr["low_pos"] \
        > corr["none"] > corr["negative"]


def test_generate_bitmaps_seeded(small):
    store, q = small
    ws = T.WorkloadSpec(0.1, "med_pos")
    a = T.generate_bitmaps(store, q, ws, seed=7, device="cpu")
    b = T.generate_bitmaps(store, q, ws, seed=7, device="cpu")
    c = T.generate_bitmaps(store, q, ws, seed=8, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("fixture", [exact_fixture, float_fixture])
def test_bruteforce_ids_exact(fixture):
    fx = fixture()
    for w in fx["bitmaps"]:
        wd, wi = R.filtered_knn(fx["jstore"], fx["jq"], fx["jbitmaps"][w],
                                10)
        gd, gi = T.filtered_knn(fx["store"], fx["q"], fx["bitmaps"][w], 10)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5,
                                   atol=1e-4)
    wd, wi = R.knn(fx["jstore"], fx["jq"], 10)
    gd, gi = T.knn(fx["store"], fx["q"], 10)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_filtered_knn_partial_matches_reference():
    fx = exact_fixture()
    bm = fx["jbitmaps"]["med_pos_0.1"]
    want = R.filtered_knn_partial(fx["jstore"], fx["jq"], bm, 10, 50)
    got = T.filtered_knn_partial(fx["store"], fx["q"],
                                 fx["bitmaps"]["med_pos_0.1"], 10, 50)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_exact_fixture_distances_are_integers():
    fx = exact_fixture()
    d = T.full_distances(fx["store"], fx["q"])
    assert torch.equal(d, torch.round(d))
