"""Kernel 2.8 (`flash_attention`) of the port, plain version, against the
reference's Pallas kernel run in interpret mode on the CPU; and the port's
blocked jnp-path attention (`models.layers.flash_attention`,
`windowed_attention`) against the reference's.  The CUDA kernel is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Inputs are float32 from numpy seeds.  Tolerance: allclose(rtol=1e-5,
atol=1e-5) on outputs of magnitude ~1: the two sides contract and sum in
another order, a few ulp apart.
"""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as jl
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as tl

RTOL, ATOL = 1e-5, 1e-5


def _qkv(seed, b, t, s, h, kv, hd):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, hd).astype(np.float32)
    k = rng.randn(b, s, kv, hd).astype(np.float32)
    v = rng.randn(b, s, kv, hd).astype(np.float32)
    return q, k, v


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# T and S are not block multiples; S != T in two of the shapes; the small
# blocks give several query and key blocks and exercise the causal bound
@pytest.mark.parametrize("t,s", [(37, 37), (37, 53), (45, 21)])
@pytest.mark.parametrize("hd", [32, 80])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_matches_pallas_interpret(causal, g, hd, t, s):
    kv = 2
    q, k, v = _qkv(t * s + hd + g, 2, t, s, kv * g, kv, hd)
    want = flash_attention_pallas(q, k, v, causal=causal, block_q=16,
                                  block_k=8, interpret=True)
    got = ref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), causal=causal,
                                  block_q=16, block_k=8)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_ops_flash_on_cpu_is_the_plain_version_at_default_blocks(causal):
    q, k, v = _qkv(5, 1, 600, 600, 4, 2, 32)
    want = flash_attention_pallas(q, k, v, causal=causal, interpret=True)
    got = ops.flash_attention_fused(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), causal=causal)
    _close(got, want)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=7),
    dict(causal=True, q_offset=9),
    dict(causal=False, kv_len=23),
    dict(causal=True, window=5, q_offset=30, kv_len=40),
])
@pytest.mark.parametrize("g", [1, 4])
def test_blocked_attention_matches_reference(kw, g):
    q, k, v = _qkv(11 + g, 2, 19, 44, 2 * g, 2, 16)
    want = jl.flash_attention(q, k, v, block=8, **kw)
    got = tl.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), block=8, **kw)
    _close(got, want)


@pytest.mark.parametrize("window,block", [(8, 8), (12, 8), (5, 16)])
def test_windowed_attention_matches_reference(window, block):
    q, k, v = _qkv(window + block, 2, 37, 37, 4, 2, 16)
    want = jl.windowed_attention(q, k, v, window, block=block)
    got = tl.windowed_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), window, block=block)
    _close(got, want)
    # the same as the masked blocked attention
    full = tl.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=True, window=window,
                              block=block)
    _close(got, full)


def test_flash_cuda_wrapper_refuses_a_cpu_tensor():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = (torch.as_tensor(a) for a in _qkv(0, 1, 4, 4, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
