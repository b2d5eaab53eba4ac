"""Port core types against the reference: bitmaps, stable top-k, merges,
distances, SQ8 quantization (tensors on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.types as RT
from repro.core.executor import _bitmap_popcount
import repro_torch.core.types as TT


def _words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("n", [31, 32, 33, 100, 1000])
def test_pack_bool_bitmap_matches_reference(n):
    rng = np.random.RandomState(n)
    bits = rng.rand(3, n) < 0.4
    bits[:, -1] = True                       # the last row, bit 31 for n=32
    want = np.asarray(RT.pack_bool_bitmap(bits))
    got = TT.words_to_uint32(TT.pack_bool_bitmap(torch.as_tensor(bits)))
    np.testing.assert_array_equal(got, want)


def test_probe_bitmap_bit31_and_padding():
    rng = np.random.RandomState(0)
    words = _words(rng, (8,))
    words[2] |= np.uint32(1 << 31)           # row 95 passes
    words[3] &= np.uint32(0x7FFFFFFF)        # row 127 fails
    ids = np.array([95, 127, -1, 0, 31, 32, 255, -5], np.int32)
    want = np.asarray(RT.probe_bitmap(jnp.asarray(words), jnp.asarray(ids)))
    got = TT.probe_bitmap(TT.words_from_uint32(words, "cpu"),
                          torch.as_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(got[0]) and not bool(got[1]) and not bool(got[2])


def test_probe_batch_matches_per_query_reference():
    rng = np.random.RandomState(1)
    words = _words(rng, (4, 10))
    ids = rng.randint(-1, 320, size=(4, 3, 7)).astype(np.int32)
    want = np.stack([np.asarray(RT.probe_bitmap(jnp.asarray(w),
                                                jnp.asarray(i)))
                     for w, i in zip(words, ids)])
    got = TT.probe_batch(TT.words_from_uint32(words, "cpu"),
                         torch.as_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_and_roundtrip():
    rng = np.random.RandomState(2)
    words = _words(rng, (2, 5))
    want = RT.unpack_bitmap(words, 150)
    got = TT.unpack_bitmap(TT.words_from_uint32(words, "cpu"), 150)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TT.words_to_uint32(TT.words_from_uint32(words, "cpu")), words)


def test_pack_bitmap_of_rows():
    rows = np.array([0, 31, 63, 64, 99])
    want = np.asarray(RT.pack_bitmap(rows, 100))
    got = TT.words_to_uint32(TT.pack_bitmap(rows, 100, device="cpu"))
    np.testing.assert_array_equal(got, want)


def test_bitmap_andnot_and_popcount():
    rng = np.random.RandomState(3)
    a, b = _words(rng, (3, 6)), _words(rng, (4,))
    want = np.asarray(RT.bitmap_andnot(jnp.asarray(a), jnp.asarray(b)))
    got = TT.bitmap_andnot(TT.words_from_uint32(a, "cpu"),
                           TT.words_from_uint32(b, "cpu"))
    np.testing.assert_array_equal(TT.words_to_uint32(got), want)
    np.testing.assert_array_equal(
        TT.bitmap_popcount(TT.words_from_uint32(a, "cpu")).numpy(),
        np.asarray(_bitmap_popcount(jnp.asarray(a))))


def test_bitset_mark_matches_reference():
    ids = np.array([5, 31, -1, 64, 95, 7], np.int32)
    mask = np.array([True, True, True, False, True, True])
    want = np.asarray(RT.bitset_mark(RT.bitset_zeros(100), jnp.asarray(ids),
                                     jnp.asarray(mask)))
    got = TT.bitset_mark(TT.bitset_zeros(100, device="cpu"),
                         torch.as_tensor(ids), torch.as_tensor(mask))
    np.testing.assert_array_equal(TT.words_to_uint32(got), want)
    assert TT.bitset_words(100) == RT.bitset_words(100) == 4


@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk_smallest_is_stable_like_lax_top_k(k):
    # integer-valued floats: many exact ties, plus +inf padding
    rng = np.random.RandomState(k)
    v = rng.randint(0, 6, size=(4, 24)).astype(np.float32)
    v[:, ::5] = np.inf
    wd, wi = RT.topk_smallest(jnp.asarray(v), k)
    gd, gi = TT.topk_smallest(torch.as_tensor(v), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_merge_topk_tie_order_and_padding():
    da = np.array([[1.0, 2.0, np.inf], [0.0, 0.0, 3.0]], np.float32)
    ia = np.array([[4, 7, -1], [1, 2, 9]], np.int32)
    db = np.array([[1.0, 2.0], [0.0, np.inf]], np.float32)
    ib = np.array([[11, 12], [13, -1]], np.int32)
    wd, wi = RT.merge_topk(*map(jnp.asarray, (da, ia, db, ib)), k=5)
    gd, gi = TT.merge_topk(*map(torch.as_tensor, (da, ia, db, ib)), k=5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_distance_matches_reference(metric):
    rng = np.random.RandomState(4)
    q = rng.randint(-9, 10, size=(3, 1, 16)).astype(np.float32)
    x = rng.randint(-9, 10, size=(3, 7, 16)).astype(np.float32)
    want = np.asarray(RT.distance(metric, jnp.asarray(q), jnp.asarray(x)))
    got = TT.distance(metric, torch.as_tensor(q), torch.as_tensor(x)).numpy()
    if metric == "cos":      # sqrt and division: float32 rounding only
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:                    # integer data: every sum is exact
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("constant_column", [False, True])
def test_sq8_quantize_byte_equal(constant_column):
    rng = np.random.RandomState(5)
    x = rng.randn(300, 24).astype(np.float32)
    if constant_column:          # hi == lo: the scale clamps to 1e-8
        x[:, 3] = 0.75
    got = TT.sq8_quantize(torch.as_tensor(x))
    for a, b in zip(got, RT.sq8_quantize(x)):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_recall_at_k_and_stats():
    f = np.array([[1, 2, 3, -1], [5, 6, 7, 8]], np.int32)
    t = np.array([[3, 2, 9, 10], [8, 7, 6, 5]], np.int32)
    want = np.asarray(jax.vmap(lambda a, b: RT.recall_at_k(a, b, 4))(
        jnp.asarray(f), jnp.asarray(t)))
    got = TT.recall_at_k(torch.as_tensor(f), torch.as_tensor(t), 4).numpy()
    np.testing.assert_array_equal(got, want)
    s = TT.SearchStats.zeros((2,), device="cpu")
    s2 = s + s
    assert s2.as_dict() == {k: [0, 0] for k in s.as_dict()}
    assert TT.SearchStats.cat([s, s]).hops.shape == (4,)


def test_search_params_fields_match_reference():
    import dataclasses
    ref = [(f.name, f.default) for f in dataclasses.fields(RT.SearchParams)]
    port = [(f.name, f.default) for f in dataclasses.fields(TT.SearchParams)]
    assert port == ref


def test_device_rule_cpu_store():
    store = TT.VectorStore.build(np.ones((4, 3), np.float32), device="cpu")
    assert store.device.type == "cpu" and store.norms_sq.tolist() == [3.0] * 4
