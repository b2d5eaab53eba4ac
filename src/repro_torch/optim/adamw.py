"""AdamW with a configurable state dtype.

The counterpart of the reference's `optim/adamw.py`.  Params, grads and
states are nested dicts of tensors; the update runs leaf by leaf (one
leaf's f32 temporaries alive at a time, not a whole tree's) and each f32
operation is the reference's, in its order: the clip scale, `b1 ** step`
and `b2 ** step` in f32, `update + decay`, the cast to `state_dtype`.
Every division is by a tensor on the params' device: CUDA divides a
tensor by a Python scalar as a product with the scalar's rounded
reciprocal.

Across the ranks of a process group each rank updates its own block of
every leaf (m and v laid out as the params), and `split` names, a leaf,
the process group its block is split over (None: whole on the rank): the
clip's global norm adds such a leaf's squared norm over its group and
counts a whole leaf once, so it is the norm of the whole gradient, the
same on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"    # bfloat16 halves optimizer memory


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict in sorted-key order (the reference's
    tree order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of nested dicts of one structure, in sorted-key
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=F32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an integer tensor), f32."""
    s = step.to(F32)
    warm = torch.clamp(s / _const(s, max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / _const(s, max(cfg.total_steps - cfg.warmup_steps,
                                       1)), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads: Any, split: Any = None) -> torch.Tensor:
    """sqrt of the leaves' squared norms added in tree order; a leaf split
    over a group (`split`'s leaf at its path) adds its blocks' first."""
    sq = [torch.sum(torch.square(g.to(F32))) for g in tree_leaves(grads)]
    if split is not None:
        import torch.distributed as dist
        for x, group in zip(sq, tree_leaves(split)):
            if group is not None:
                dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    total = 0
    for x in sq:
        total = total + x
    return torch.sqrt(total)


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 donate: bool = False, split: Any = None
                 ) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics).  With `donate` the new
    values are written into the given params and moments (the reference's
    donated buffers) and those trees come back; else new tensors.
    `split` (params' structure: a process group or None a leaf) says
    which leaves are blocks of a larger one (see the module docstring)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads, split)
    scale = torch.clamp(_const(gnorm, cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(F32)
    bc2 = 1.0 - b2 ** step.to(F32)
    sdt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        mf = b1 * m.to(F32)
        mf += (1 - b1) * g
        vf = b2 * v.to(F32)
        gg = (1 - b2) * g
        gg *= g
        vf += gg
        del g, gg
        update = mf / bc1
        den = vf / bc2
        den.sqrt_()
        den += cfg.eps
        update /= den
        del den
        update += cfg.weight_decay * p.to(F32)
        update *= lr
        newp = p.to(F32) - update
        del update
        if not donate:
            return newp.to(p.dtype), mf.to(sdt), vf.to(sdt)
        p.copy_(newp)
        m.copy_(mf)
        v.copy_(vf)
        return p, m, v

    with torch.no_grad():
        out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)   # noqa: E731
    if donate:
        state["step"].copy_(step)
        step = state["step"]
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
