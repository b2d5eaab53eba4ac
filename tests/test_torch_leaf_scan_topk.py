"""Kernels 2.6 (`leaf_scan`) and 2.7 (`topk`) of the port, plain versions,
against the reference's Pallas kernels run in interpret mode on the CPU
(`use_pallas=True`).  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: leaf-scan scores allclose(rtol=1e-5, atol=1e-4) with the +inf
pattern exact (the two contract in another order), and bit-equal on
integer tiles with scale 1, mean 0 and an integer query; top-k values and
indices exact, ties, +-inf and k > n included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.leaf_scan import leaf_scan_cuda
from repro_torch.kernels.topk import topk_cuda

RTOL, ATOL = 1e-5, 1e-4


def _leaf_inputs(seed, nl, c, d, integer=False):
    rng = np.random.RandomState(seed)
    tiles = rng.randint(-127, 128, (nl, c, d)).astype(np.int8)
    rowids = rng.randint(-1, 900, (nl, c)).astype(np.int32)
    bm = rng.randint(0, 2 ** 32, 30, dtype=np.uint64).astype(np.uint32)
    if integer:
        q = rng.randint(-20, 21, d).astype(np.float32)
        scale, mean = np.ones(d, np.float32), np.zeros(d, np.float32)
    else:
        q = rng.randn(d).astype(np.float32)
        scale = (rng.rand(d) * 0.05 + 1e-3).astype(np.float32)
        mean = (rng.randn(d) * 0.3).astype(np.float32)
    return q, tiles, rowids, scale, mean, bm


def _port(args):
    q, tiles, rowids, scale, mean, bm = args
    return (torch.as_tensor(q), torch.as_tensor(tiles),
            torch.as_tensor(rowids), torch.as_tensor(scale),
            torch.as_tensor(mean), torch.as_tensor(bm.view(np.int32)))


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("nl,c,d", [(5, 13, 20), (3, 37, 35), (1, 8, 128)])
def test_leaf_scan_equal_reference_interpret(metric, nl, c, d):
    args = _leaf_inputs(nl * c + d, nl, c, d)
    want = np.asarray(jops.leaf_scan(*args, metric=metric, use_pallas=True))
    got = ops.leaf_scan(*_port(args), metric).numpy()
    np.testing.assert_array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_leaf_scan_bit_equal_on_integers(metric):
    args = _leaf_inputs(9, 4, 21, 24, integer=True)
    want = np.asarray(jops.leaf_scan(*args, metric=metric, use_pallas=True))
    got = ops.leaf_scan(*_port(args), metric).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_leaf_scan_ids_is_the_per_query_scan():
    """The batched plain version: query q against its own leaves of the
    tile table, equal to one single-query scan per query, across the
    boundary of its query blocks."""
    rng = np.random.RandomState(1)
    qn = ref.LEAF_QUERY_BLOCK + 5
    _, tiles, rowids, scale, mean, _ = _port(_leaf_inputs(2, 9, 19, 12))
    q = torch.as_tensor(rng.randn(qn, 12).astype(np.float32))
    leaf_ids = torch.as_tensor(rng.randint(0, 9, (qn, 4)).astype(np.int32))
    bms = torch.as_tensor(rng.randint(-2 ** 31, 2 ** 31, (qn, 30))
                          .astype(np.int32))
    got = ops.leaf_scan_ids(q, leaf_ids, tiles, rowids, scale, mean, bms)
    for i in range(qn):
        lid = leaf_ids[i].long()
        want = ops.leaf_scan(q[i], tiles[lid], rowids[lid], scale, mean,
                             bms[i])
        assert torch.equal(torch.isinf(got[i]), torch.isinf(want))
        fin = torch.isfinite(want)
        assert torch.allclose(got[i][fin], want[fin], rtol=RTOL, atol=ATOL)


def _topk_values(n, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(n).astype(np.float32)
    v[::7] = np.inf
    v[3 % max(n, 1)::11] = -np.inf
    v[10:60] = 0.25                         # a run of ties
    v[-5:] = v[0]
    return v


@pytest.mark.parametrize("n,k", [(100, 10), (2500, 40), (1024, 7),
                                 (1025, 10), (5, 12), (1, 1), (20, 20)])
def test_topk_equal_reference_interpret(n, k):
    v = _topk_values(n, n + k)
    wv, wi = jops.topk_smallest(jnp.asarray(v), k, use_pallas=True)
    gv, gi = ops.topk_smallest(torch.as_tensor(v), k)
    np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
    assert gi.dtype == torch.int32


def test_topk_plain_sentinels():
    v = torch.tensor([3.0, float("inf"), -float("inf"), 3.0, 1.0])
    vals, idx = ops.topk_smallest(v, 7)
    assert vals.tolist()[:4] == [-float("inf"), 1.0, 3.0, 3.0]
    assert idx.tolist() == [2, 4, 0, 3, -1, -1, -1]
    vals, idx = ref.topk_partial_ref(torch.zeros(0), 3)
    assert torch.isinf(vals).all() and idx.tolist() == [-1, -1, -1]


def test_kernels_registered_and_cpu_never_counts():
    assert {"leaf_scan", "topk"} <= set(build.LAUNCHES)
    assert "leaf_scan_f32" in build.SIGNATURES["leaf_scan"]
    assert "topk_f32" in build.SIGNATURES["topk"]
    ops.reset_launches()
    args = _port(_leaf_inputs(3, 2, 9, 8))
    ops.leaf_scan(*args)
    ops.topk_smallest(torch.randn(50), 5)
    assert ops.launches()["leaf_scan"] == ops.launches()["topk"] == 0
    # the CUDA wrappers take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        leaf_scan_cuda(args[0][None], torch.zeros((1, 2), dtype=torch.int32),
                       *args[1:5], args[5][None])
    with pytest.raises(ValueError, match="CUDA"):
        topk_cuda(torch.randn(10), 3)
