"""The flash-attention wrapper's choice of kernel, which is plain Python and
runs without a card: bf16 at the tensor-core widths goes to the `wgmma`
kernel, everything else to the FP32 FMA template, and what neither takes is
refused before anything is built or launched."""
import re

import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (WGMMA_HEAD_DIMS,
                                                 flash_attention_cuda, route)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"),        # the encoder's head width
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 1, "fma"),
    (torch.bfloat16, 32, "fma"),
    (torch.bfloat16, 96, "fma"),
    (torch.bfloat16, 256, "fma"),
    (torch.float32, 64, "fma"),           # f32 keeps FP32 FMA and 1e-5
    (torch.float32, 80, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 256, "fma"),
])
def test_route_by_dtype_and_head_width(dtype, hd, want):
    assert route(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,match", [
    (torch.float16, 80, "dtype"),
    (torch.float64, 64, "dtype"),
    (torch.int8, 64, "dtype"),
    (torch.bfloat16, 0, "head dim"),
    (torch.bfloat16, 257, "head dim"),
    (torch.float32, 300, "head dim"),
])
def test_route_refuses_what_no_kernel_takes(dtype, hd, match):
    with pytest.raises(ValueError, match=match):
        route(dtype, hd)


def test_wrapper_routes_before_it_checks_the_device():
    # a half-precision q is refused for its dtype, a CPU bf16 q at a
    # tensor-core width for its device; neither builds nor counts
    ops.reset_launches()
    q = torch.zeros(1, 4, 2, 80, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q, q, q)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(qb, qb, qb)
    assert ops.routes() == {"flash_attention.wgmma": 0,
                            "flash_attention.fma": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version_and_count_no_route(dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 9, 2, 80, generator=g).to(dtype)
               for _ in range(3))
    ops.reset_launches()
    got = ops.flash_attention_fused(q, k, v, causal=True)
    assert torch.equal(got, ops.ref.flash_attention_ref(q, k, v, True))
    assert ops.launches()["flash_attention"] == 0
    assert set(ops.routes().values()) == {0}


def test_route_tally_resets_with_the_launch_counts():
    build.ROUTES["flash_attention.wgmma"] += 3
    build.LAUNCHES["flash_attention"] += 3
    ops.reset_launches()
    assert ops.routes() == {"flash_attention.wgmma": 0,
                            "flash_attention.fma": 0}
    assert ops.launches()["flash_attention"] == 0


def test_route_counts_under_the_kernel_and_its_route():
    ops.reset_launches()
    build.check(0, "flash_attention", "wgmma")
    build.check(0, "flash_attention", "fma")
    build.check(0, "distance_matrix")
    assert ops.launches()["flash_attention"] == 2
    assert ops.launches()["distance_matrix"] == 1
    assert ops.routes() == {"flash_attention.wgmma": 1,
                            "flash_attention.fma": 1}
    with pytest.raises(RuntimeError, match="error 1"):
        build.check(1, "flash_attention", "wgmma")
    assert ops.routes()["flash_attention.wgmma"] == 1
    ops.reset_launches()


def test_tensor_core_widths_match_the_compiled_instances():
    # the C entry point dispatches exactly the widths the Python rule sends
    src = (build.CSRC / "flash_attention.cu").read_text()
    body = src[src.index('extern "C" int flash_attention_wgmma'):]
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", body))
    assert cases == WGMMA_HEAD_DIMS
