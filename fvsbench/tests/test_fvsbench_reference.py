"""The plain reference against brute force in numpy, the answer checks
against each kind of bad answer, and the traffic generator's filters."""
import numpy as np
import pytest
import torch

import fvsbench_testkit  # noqa: F401  (paths)
from fvsbench import datagen, traffic
from fvsbench.reference import exact


def pack_np(bits: np.ndarray) -> torch.Tensor:
    q, n = bits.shape
    pad = np.zeros((q, (n + 31) // 32 * 32), bool)
    pad[:, :n] = bits
    w = (pad.reshape(q, -1, 32).astype(np.uint64)
         << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.as_tensor(w.view(np.int32))


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(3)
    rows = rng.randn(700, 12).astype(np.float32)
    queries = rng.randn(70, 12).astype(np.float32)
    bits = rng.rand(70, 700) < 0.2
    bits[0] = False
    bits[0, [5, 9]] = True         # fewer passing rows than k
    return rows, queries, bits


def test_unpack_popcount_passes(case):
    _, _, bits = case
    words = pack_np(bits)
    assert torch.equal(exact.unpack(words, 700), torch.as_tensor(bits))
    assert exact.popcount(words).tolist() == bits.sum(1).tolist()
    ids = torch.as_tensor([[5, 9, 6, -1, 700, 10 ** 6]] * 70)
    got = exact.passes(words, torch.arange(70), ids)
    want = [[bits[q, i] if 0 <= i < 700 else False for i in row]
            for q, row in enumerate(ids.tolist())]
    assert got.tolist() == want


def test_exact_knn_matches_brute_force(case):
    rows, queries, bits = case
    d, ids = exact.exact_knn(torch.as_tensor(rows), torch.as_tensor(queries),
                             pack_np(bits), 10)
    dd = ((queries[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    dd[~bits] = np.inf
    for q in range(70):
        want = np.argsort(dd[q], kind="stable")[:10]
        want = [int(i) for i in want if np.isfinite(dd[q, i])]
        assert ids[q, :len(want)].tolist() == want
        assert (ids[q, len(want):] == -1).all()
        assert np.allclose(d[q, :len(want)].numpy(), dd[q, want], rtol=1e-5,
                           atol=1e-5)


def test_checks_pass_the_exact_answers_and_flag_each_fault(case):
    rows, queries, bits = case
    r, q, words = torch.as_tensor(rows), torch.as_tensor(queries), \
        pack_np(bits)
    d, ids = exact.exact_knn(r, q, words, 10)
    qidx = torch.arange(70)
    passing = exact.popcount(words)
    assert not exact.bad_answers(words, passing, 700, qidx, ids, d).any()
    assert exact.answer_error(r, q, qidx, ids, d) < 1e-6

    def bad(i2, d2):
        return exact.bad_answers(words, passing, 700, qidx, i2, d2)

    failing = int(np.flatnonzero(~bits[1])[0])
    i2 = ids.clone(); i2[1, 3] = failing
    assert bad(i2, d)[1]                                   # fails filter
    i2 = ids.clone(); i2[1, 3] = i2[1, 2]
    assert bad(i2, d)[1]                                   # a row twice
    i2 = ids.clone(); i2[1, 3] = 700
    assert bad(i2, d)[1]                                   # outside
    i2 = ids.clone(); i2[1, 9] = -1
    assert bad(i2, d)[1]                                   # short
    i2 = ids.clone(); i2[1, 4] = -1
    assert bad(i2, d)[1]                                   # hole
    d2 = d.clone(); d2[1, 3], d2[1, 4] = d[1, 4], d[1, 3] + 1
    assert bad(ids, d2)[1]                                 # unordered
    assert not bad(ids, d)[0]      # two passing rows, two answers: fine
    d2 = d.clone(); d2[2, 0] *= 1.001
    assert exact.answer_error(r, q, qidx, ids, d2) > 1e-4


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159265])
    y = exact.to_tf32(x)
    assert y[:2].tolist() == x[:2].tolist()
    assert y[2] == 1.0                      # tie to even
    assert y[3] == 1.0 + 2 ** -9            # tie to even, upward
    assert (y.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(y[4]) + 3.14159265) < 2 ** -10 * 4


@pytest.mark.parametrize("corr", traffic.CORRELATIONS)
@pytest.mark.parametrize("sel", (0.01, 0.3, 0.99))
def test_filters_pass_the_selected_share(corr, sel):
    g = datagen.make_generator(1, "cpu")
    rows = torch.randn((1000, 8), generator=g)
    queries = torch.randn((70, 8), generator=g)
    words = traffic.filter_bitmaps(rows, queries, sel, corr, seed=4)
    assert (exact.popcount(words) == round(sel * 1000)).all()
    again = traffic.filter_bitmaps(rows, queries, sel, corr, seed=4)
    assert torch.equal(words, again)


def test_correlation_orders_the_passing_rows():
    g = datagen.make_generator(2, "cpu")
    rows = torch.randn((2000, 8), generator=g)
    queries = torch.randn((64, 8), generator=g)
    d = traffic.l2_distances(rows, queries)
    mean = {}
    for corr in ("high_pos", "none", "negative"):
        bits = exact.unpack(traffic.filter_bitmaps(rows, queries, 0.05, corr,
                                                   seed=1), 2000)
        mean[corr] = float(d[bits].mean())
    assert mean["high_pos"] < mean["none"] < mean["negative"]


def test_pool_mix_and_schedule():
    rows = torch.randn((500, 4))
    queries = torch.randn((40, 4))
    mix = {"filters": [{"selectivity": 0.1, "correlation": "none",
                        "share": 3}, {"selectivity": 0.5,
                                      "correlation": "med_pos", "share": 1}]}
    words, label = traffic.pool_bitmaps(rows, queries, mix, seed=2)
    assert label.tolist() == [0] * 30 + [1] * 10
    assert exact.popcount(words).tolist() == [50] * 30 + [250] * 10
    assert traffic.due_times({"kind": "closed"}, 10, 1) is None
    due = traffic.due_times({"kind": "poisson", "rate_qps": 100.0}, 5000, 1)
    assert np.all(np.diff(due) > 0)
    assert 45 < due[-1] < 55
    assert sorted(traffic.query_order(30, 5)) == list(range(30))


def test_table_from_the_config_queries_from_the_seed():
    cfg = {"n": 300, "dim": 6, "clusters": 4, "cluster_spread": 0.8,
           "data_seed": 0, "normalize": True}
    a = datagen.make_vectors(cfg, 20, 7, "cpu")
    b = datagen.make_vectors(cfg, 20, 7, "cpu")
    c = datagen.make_vectors(cfg, 20, 8, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    assert torch.allclose(a[0].norm(dim=1), torch.ones(300))
    assert traffic.sub_seed(2 ** 33 + 5, 1) < 2 ** 32
