"""Each kernel's plain PyTorch version against the reference's jnp oracle
and its Pallas kernel (interpret mode on the CPU), plus the dispatch rules
of `repro_torch.kernels.ops`.

Tolerance: rtol 1e-5, atol 1e-4 on finite distances (float32 sums of up to
48 products taken in another order; the values are a few units).  Masks,
padding and +inf positions must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.types import words_from_uint32
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-5, 1e-4


def _bitmaps(rng, q, n):
    return rng.randint(0, 2 ** 32, size=(q, (n + 31) // 32),
                       dtype=np.uint64).astype(np.uint32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distance_matrix_plain_vs_oracle_and_pallas(metric):
    rng = np.random.RandomState(0)
    q = rng.randn(9, 48).astype(np.float32)
    x = rng.randn(130, 48).astype(np.float32)
    got = ref.distance_matrix_ref(torch.as_tensor(q), torch.as_tensor(x),
                                  metric).numpy()
    _close(got, jref.distance_matrix_ref(jnp.asarray(q), jnp.asarray(x),
                                         metric))
    _close(got, jops.distance_matrix(jnp.asarray(q), jnp.asarray(x),
                                     metric=metric, use_pallas=True))
    np.testing.assert_array_equal(
        ops.distance_matrix(torch.as_tensor(q), torch.as_tensor(x),
                            metric).numpy(), got)


def _frontier_inputs(seed=1, q=6, c=40, n=300, d=48):
    rng = np.random.RandomState(seed)
    rows = rng.randn(n, d).astype(np.float32)
    norms = (rows * rows).sum(-1)
    queries = rng.randn(q, d).astype(np.float32)
    ids = rng.randint(-1, n, size=(q, c)).astype(np.int32)
    ids[:, -3:] = -1                                  # padding
    bm = _bitmaps(rng, q, n)
    return queries, rows, norms, ids, bm


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_frontier_scan_plain_vs_oracle_and_pallas(metric):
    queries, rows, norms, ids, bm = _frontier_inputs()
    safe = np.maximum(ids, 0)
    jargs = (jnp.asarray(queries), jnp.asarray(rows[safe]),
             jnp.asarray(norms[safe]), jnp.asarray(ids), jnp.asarray(bm))
    wd, wp = jref.frontier_scan_ref(*jargs, metric)
    pd, pp = jops.frontier_scan(*jargs, metric=metric, use_pallas=True)
    gd, gp = ops.frontier_scan(
        torch.as_tensor(queries), torch.as_tensor(rows),
        torch.as_tensor(norms), torch.as_tensor(ids),
        words_from_uint32(bm, "cpu"), metric)
    for d_, p_ in ((wd, wp), (pd, pp)):
        _close(gd.numpy(), d_)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(p_))
    pad = ids < 0
    assert np.isinf(gd.numpy()[pad]).all() and not gp.numpy()[pad].any()


def test_frontier_scan_exact_on_integer_rows():
    # the engine's arithmetic (elementwise product + last-axis sum) is
    # bit-identical to the oracle where every sum is exact
    rng = np.random.RandomState(2)
    rows = rng.randint(-127, 128, size=(200, 32)).astype(np.float32)
    norms = (rows * rows).sum(-1)
    queries = rng.randint(-127, 128, size=(4, 32)).astype(np.float32)
    ids = rng.randint(-1, 200, size=(4, 16)).astype(np.int32)
    bm = _bitmaps(rng, 4, 200)
    safe = np.maximum(ids, 0)
    wd, wp = jref.frontier_scan_ref(
        jnp.asarray(queries), jnp.asarray(rows[safe]),
        jnp.asarray(norms[safe]), jnp.asarray(ids), jnp.asarray(bm))
    gd, gp = ref.frontier_scan_ref(
        torch.as_tensor(queries), torch.as_tensor(rows),
        torch.as_tensor(norms), torch.as_tensor(ids),
        words_from_uint32(bm, "cpu"))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_leaf_scan_batched_plain_vs_oracle_and_pallas(metric):
    rng = np.random.RandomState(3)
    u, c, d, q, n = 5, 24, 48, 7, 500
    tiles = rng.randint(-127, 128, size=(u, c, d)).astype(np.int8)
    rowids = rng.randint(0, n, size=(u, c)).astype(np.int32)
    rowids[:, -4:] = -1
    scale = (rng.rand(d) * 0.02 + 0.001).astype(np.float32)
    mean = (rng.randn(d) * 0.1).astype(np.float32)
    x = tiles.astype(np.float32) * scale + mean
    norms = (x * x).sum(-1)
    queries = rng.randn(q, d).astype(np.float32)
    bm = _bitmaps(rng, q, n)
    jargs = [jnp.asarray(a) for a in (queries, tiles, rowids, scale, mean,
                                      bm, norms)]
    want = jref.leaf_scan_batched_ref(*jargs, metric=metric)
    pallas = jops.leaf_scan_batched(*jargs, metric=metric, use_pallas=True)
    got = ops.leaf_scan_batched(
        torch.as_tensor(queries), torch.as_tensor(tiles),
        torch.as_tensor(rowids), torch.as_tensor(scale),
        torch.as_tensor(mean), words_from_uint32(bm, "cpu"),
        torch.as_tensor(norms), metric).numpy()
    _close(got, want)
    _close(got, pallas)
    assert np.isinf(got[:, :, -4:]).all()        # padded rows


def test_probe_bitmap_ref_matches_oracle():
    rng = np.random.RandomState(4)
    bm = _bitmaps(rng, 1, 256)[0]
    ids = np.array([-1, 0, 31, 32, 63, 255, 100], np.int32)
    want = np.asarray(jref.probe_bitmap_ref(jnp.asarray(bm),
                                            jnp.asarray(ids)))
    got = ref.probe_bitmap_ref(words_from_uint32(bm, "cpu"),
                               torch.as_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_counts_only_kernel_launches():
    # CPU tensors take the plain versions and launch nothing
    ops.reset_launches()
    queries, rows, norms, ids, bm = _frontier_inputs(q=2, c=4)
    ops.frontier_scan(torch.as_tensor(queries), torch.as_tensor(rows),
                      torch.as_tensor(norms), torch.as_tensor(ids),
                      words_from_uint32(bm, "cpu"))
    ops.distance_matrix(torch.as_tensor(queries), torch.as_tensor(rows))
    assert ops.launches() == {k: 0 for k in ops.KERNELS}


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.distance import distance_matrix_cuda
    from repro_torch.kernels.frontier_scan import (
        frontier_scan_cuda, frontier_scan_excl_cuda,
        frontier_scan_excl_sq8_cuda, frontier_scan_sq8_cuda)
    from repro_torch.kernels.leaf_scan import leaf_scan_batched_cuda
    t = torch.zeros(2, 4)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    bm = torch.zeros(2, 1, dtype=torch.int32)
    t8 = torch.zeros(2, 4, dtype=torch.int8)
    v4, tab = torch.zeros(4), torch.zeros(1, 2)
    row, tau = torch.zeros(2, dtype=torch.int32), torch.zeros(2)
    for call in (
            lambda: frontier_scan_sq8_cuda(t, t8, v4, v4, torch.zeros(2),
                                           ids, bm),
            lambda: frontier_scan_excl_cuda(t, t, torch.zeros(2), ids, bm,
                                            tab, row, tau),
            lambda: frontier_scan_excl_sq8_cuda(t, t8, v4, v4,
                                                torch.zeros(2), ids, bm,
                                                tab, row, tau)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="CUDA"):
        distance_matrix_cuda(t, t)
    with pytest.raises(ValueError, match="CUDA"):
        frontier_scan_cuda(t, t, torch.zeros(2), torch.zeros(
            2, 3, dtype=torch.int32), torch.zeros(2, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        leaf_scan_batched_cuda(t, torch.zeros(1, 3, 4, dtype=torch.int8),
                               torch.zeros(1, 3, dtype=torch.int32),
                               torch.zeros(4), torch.zeros(4),
                               torch.zeros(2, 1, dtype=torch.int32),
                               torch.zeros(1, 3))


def test_sources_and_signatures_agree():
    # each C entry point's argument list matches its ctypes signature
    import re
    from repro_torch.kernels import build
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        for fn, sig in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
            assert m, fn
            params = [p.strip() for p in m.group(1).split(",")]
            kinds = "".join("p" if "*" in p else
                            "f" if p.startswith("float") else "i"
                            for p in params)
            assert kinds == sig, (fn, kinds, sig)
