"""The flash-attention CUDA kernels (csrc/flash_attention.cu) and their plain
version."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref as plain  # noqa: F401

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 256
# the head widths the tensor-core kernel is compiled for
WGMMA_HEAD_DIMS = (64, 80, 128)


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that serves q of this dtype and head width: "wgmma" (the
    bf16 tensor-core kernel) for bfloat16 at hd 64, 80 or 128, "fma" (the
    FP32 FMA template) for float32 at any width and for bfloat16 at the
    others.  Raises for what neither kernel takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {dtype} (float32 "
                         "or bfloat16)")
    if hd > MAX_HEAD_DIM or hd < 1:
        raise ValueError(f"flash_attention kernel: head dim {hd} (1 to "
                         f"{MAX_HEAD_DIM})")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, S, KV, hd), one dtype (f32 or bf16),
    contiguous, on one CUDA device -> (B, T, H, hd) in q's dtype: the
    reference's `flash_attention_pallas` (non-causal or causal, query and
    key positions from 0).  `route(q.dtype, hd)` picks the kernel: bf16 at
    hd 64, 80 or 128 runs on the tensor cores (`wgmma`, probabilities
    rounded to bf16 in P.V), everything else on the FP32 FMA template.  A
    launch counts under `flash_attention` and under its route."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    kind = route(q.dtype, hd)
    build.require(q, q.dtype, (b, t, h, hd), "q")
    build.require(k, q.dtype, (b, s, kvh, hd), "k")
    build.require(v, q.dtype, (b, s, kvh, hd), "v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    if kvh < 1 or h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"flash_attention kernel: {h} query heads over "
                         f"{kvh} kv heads")
    if s < 1:
        raise ValueError("flash_attention kernel: no keys")
    if b > 65535 or kvh > 65535 or t * (h // kvh) >= 2 ** 31:
        raise ValueError(f"flash_attention kernel: B={b}, KV={kvh}, "
                         f"T={t} too large")
    out = torch.empty_like(q)
    if b == 0 or t == 0:          # nothing to launch, nothing to count
        return out
    if kind == "wgmma" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention kernel: the tensor-core route "
                         "needs 16-byte aligned q, k and v")
    lib = build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if kind == "wgmma":
        status = lib.flash_attention_wgmma(*ptrs, b, t, s, h, kvh, hd,
                                           int(bool(causal)), stream)
    else:
        status = lib.flash_attention(*ptrs, b, t, s, h, kvh, hd,
                                     int(bool(causal)), _DTYPES[q.dtype],
                                     stream)
    build.check(status, "flash_attention", kind)
    return out
