"""The flash-attention CUDA kernel (csrc/flash_attention.cu) and its plain
version."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref as plain  # noqa: F401

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 256


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, S, KV, hd), one dtype (f32 or bf16),
    contiguous, on one CUDA device -> (B, T, H, hd) in q's dtype: the
    reference's `flash_attention_pallas` (non-causal or causal, query and
    key positions from 0)."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} (float32 "
                         "or bfloat16)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    build.require(q, q.dtype, (b, t, h, hd), "q")
    build.require(k, q.dtype, (b, s, kvh, hd), "k")
    build.require(v, q.dtype, (b, s, kvh, hd), "v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    if hd > MAX_HEAD_DIM or hd < 1:
        raise ValueError(f"flash_attention kernel: head dim {hd} (1 to "
                         f"{MAX_HEAD_DIM})")
    if kvh < 1 or h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"flash_attention kernel: {h} query heads over "
                         f"{kvh} kv heads")
    if s < 1:
        raise ValueError("flash_attention kernel: no keys")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"flash_attention kernel: B={b}, KV={kvh} too large")
    out = torch.empty_like(q)
    if b == 0 or t == 0:          # nothing to launch, nothing to count
        return out
    lib = build.load("flash_attention")
    status = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, s, h,
        kvh, hd, int(bool(causal)), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "flash_attention")
    return out
