"""Int8 error-feedback gradient compression.

The counterpart of the reference's `optim/compression.py`: gradients are
quantized to int8 with a per-tensor scale before they would cross the
data-parallel all-reduce; the quantization residual is carried in an
error-feedback buffer and added back at the next step (EF-SGD).
`ef_compress_grads` is the pure transformation (the round trip the
collective would transport); the trainer applies it when
`grad_compression=True`.  Rounding is half to even, as `jnp.round`, and
the scale divides by a tensor (CUDA divides by a Python scalar as a
product with its rounded reciprocal).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    top = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = top / torch.full((), 127.0, dtype=top.dtype, device=top.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads: Any, error: Any) -> tuple[Any, Any]:
    """Returns (compressed-then-decompressed grads, new error buffers):
    the error buffer keeps what the round trip lost, to be sent again at
    the next step."""

    def one(g, e):
        gf = g.to(torch.float32) + e
        q, s = compress_int8(gf)
        deq = decompress_int8(q, s)
        return deq.to(g.dtype), gf - deq

    with torch.no_grad():
        out = tree_map(one, grads, error)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def init_error_buffers(grads_shape: Any) -> Any:
    """f32 zeros shaped as each leaf, on its device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_shape)
