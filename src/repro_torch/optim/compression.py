"""Int8 error-feedback gradient compression.

The counterpart of the reference's `optim/compression.py`: gradients are
quantized to int8 with a per-tensor scale before they would cross the
data-parallel all-reduce; the quantization residual is carried in an
error-feedback buffer and added back at the next step (EF-SGD).
`ef_compress_grads` is the pure transformation (the round trip the
collective would transport); the trainer applies it when
`grad_compression=True`, across ranks to the gradient summed over the
data ranks, as the reference compresses the global gradient: a leaf
split over a group (`split`) takes its scale from the largest |g| of
every block.  Rounding is half to even, as `jnp.round`, and
the scale divides by a tensor (CUDA divides by a Python scalar as a
product with its rounded reciprocal).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map


def compress_int8(x: torch.Tensor, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the per-tensor scale; with `group`, `x` is one block
    of a tensor split over that process group and the scale is the
    whole tensor's."""
    top = torch.max(torch.abs(x))
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    top = torch.clamp(top, min=1e-12)
    scale = top / torch.full((), 127.0, dtype=top.dtype, device=top.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads: Any, error: Any, split: Any = None
                      ) -> tuple[Any, Any]:
    """Returns (compressed-then-decompressed grads, new error buffers):
    the error buffer keeps what the round trip lost, to be sent again at
    the next step.  `split`: grads' structure, the process group a leaf's
    block is split over, or None."""

    def one(g, e, group=None):
        gf = g.to(torch.float32) + e
        q, s = compress_int8(gf, group)
        deq = decompress_int8(q, s)
        return deq.to(g.dtype), gf - deq

    with torch.no_grad():
        out = tree_map(one, grads, error) if split is None \
            else tree_map(one, grads, error, split)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def init_error_buffers(grads_shape: Any) -> Any:
    """f32 zeros shaped as each leaf, on its device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_shape)
