"""The SQ8 graph tier of the port against the reference: the shadow store,
the `frontier_scan_sq8` kernel's plain version (against the jnp oracle and
the Pallas kernel in interpret mode), and the four `<strategy>_sq8` methods.

Tolerances: kernel distances rtol 1e-5, atol 1e-4 (float32 sums of up to 48
products in another order on values of a few units); on the SQ8-exact
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
from repro_torch.core.types import words_from_uint32
from repro_torch.kernels import ops
from torch_parity import (FIXTURES, assert_close, assert_same, run_both,
                          torch_params)

RTOL, ATOL = 1e-5, 1e-4
SQ8_METHODS = ("sweeping_sq8", "acorn_sq8", "navix_sq8", "iterative_scan_sq8")
P = R.SearchParams(k=10, ef_search=48, beam_width=128, max_hops=512,
                   num_leaves_to_search=12, reorder_factor=4)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _sq8_inputs(seed=5, q=6, c=40, n=300, d=48):
    rng = np.random.RandomState(seed)
    qrows = rng.randint(-127, 128, size=(n, d)).astype(np.int8)
    scale = (rng.rand(d) * 0.02 + 0.001).astype(np.float32)
    mean = (rng.randn(d) * 0.1).astype(np.float32)
    x = qrows.astype(np.float32) * scale + mean
    norms = (x * x).sum(-1)
    queries = (rng.randn(q, d) * 0.5).astype(np.float32)
    ids = rng.randint(-1, n, size=(q, c)).astype(np.int32)
    ids[:, -3:] = -1
    bm = rng.randint(0, 2 ** 32, size=(q, (n + 31) // 32),
                     dtype=np.uint64).astype(np.uint32)
    return queries, qrows, scale, mean, norms, ids, bm


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_frontier_scan_sq8_plain_vs_oracle_and_pallas(metric):
    queries, qrows, scale, mean, norms, ids, bm = _sq8_inputs()
    safe = np.maximum(ids, 0)
    jargs = (jnp.asarray(queries), jnp.asarray(qrows[safe]),
             jnp.asarray(scale), jnp.asarray(mean), jnp.asarray(norms[safe]),
             jnp.asarray(ids), jnp.asarray(bm))
    wd, wp = jref.frontier_scan_sq8_ref(*jargs, metric=metric)
    pd, pp = jops.frontier_scan_sq8(*jargs, metric=metric, use_pallas=True)
    gd, gp = ops.frontier_scan_sq8(
        *(torch.as_tensor(a) for a in (queries, qrows, scale, mean, norms,
                                       ids)), words_from_uint32(bm, "cpu"),
        metric)
    for d_, p_ in ((wd, wp), (pd, pp)):
        _close(gd.numpy(), d_)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(p_))
    pad = ids < 0
    assert np.isinf(gd.numpy()[pad]).all() and not gp.numpy()[pad].any()


@pytest.mark.parametrize("kind", ["exact", "float"])
def test_quantize_store_matches_reference(kind):
    fx = FIXTURES[kind]()
    want = R.quantize_store(fx["jstore"])
    got = T.quantize_store(fx["store"])
    for f in ("q_vectors", "q_scale", "q_mean"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.q_norms_sq.numpy(),
                               np.asarray(want.q_norms_sq), rtol=1e-6)
    if kind == "exact":        # dequantized rows are the integers
        np.testing.assert_array_equal(got.q_norms_sq.numpy(),
                                      np.asarray(want.q_norms_sq))
    assert T.quantize_store(got) is got                  # idempotent


@pytest.mark.parametrize("method", SQ8_METHODS)
def test_sq8_methods_bit_equal_on_sq8_exact_fixture(method):
    fx = FIXTURES["sq8_exact"]()
    for workload in ("med_pos_0.1", "none_0.02"):
        jres, tres = run_both(fx, method, P, workload)
        assert_same(jres, tres)
        assert int(tres.stats.reorder_rows.sum()) > 0     # exact rerank ran


@pytest.mark.parametrize("method", SQ8_METHODS)
def test_sq8_methods_close_on_float_fixture(method):
    jres, tres = run_both(FIXTURES["float"](), method, P)
    assert_close(jres, tres)
    assert tres.plan.params.graph_quant == "sq8"


def test_sq8_without_rerank_matches_reference():
    p = dataclasses.replace(P, sq8_rerank=False)
    jres, tres = run_both(FIXTURES["sq8_exact"](), "sweeping_sq8", p)
    assert_same(jres, tres)
    assert int(tres.stats.reorder_rows.sum()) == 0


def test_sq8_needs_a_shadow():
    fx = FIXTURES["exact"]()
    plain = T.VectorStore(fx["store"].vectors, fx["store"].norms_sq)
    p = torch_params(dataclasses.replace(P, graph_quant="sq8"))
    with pytest.raises(ValueError, match="quantize_store"):
        T.search_batch(fx["graph"], plain, fx["q"],
                       fx["bitmaps"]["med_pos_0.1"], p)
    with pytest.raises(ValueError, match="quantize_store"):
        T.GraphExecutor(fx["graph"], plain, graph_quant="sq8")
    ex = T.make_executor("acorn_sq8", plain, graph=fx["graph"], device="cpu")
    assert ex.store.has_sq8 and ex.name == "acorn_sq8"
