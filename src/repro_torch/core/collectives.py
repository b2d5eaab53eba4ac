"""The shard collectives of the mesh-sharded tiers (DESIGN.md §13).

The reference binds its shard body to a mesh axis and takes `pmin`,
`pmax`, `psum` and `all_gather` from `jax.lax`, under `jax.vmap(...,
axis_name=)` on one device or `shard_map` on a real mesh.  The port writes
the shard body once against this interface, with two implementations:

* `StackedShards` — every shard in this process.  A value that differs by
  shard is a (S, ...) stack, row s the value of shard s; the reductions
  run over the leading dim.  This is the one-card emulation.
* `GroupShards` — one shard per rank of an initialized
  `torch.distributed` process group (gloo on the CPU, NCCL on cards).  A
  rank's values are a (1, ...) stack of its own shard; the reductions are
  `all_reduce(MIN / MAX / SUM)` and `all_gather` over the group.

Either way `local` names the global shard index of each row of the stacks
this process holds, and every reduction returns the same value on every
shard.  The reductions only select or add: `min` / `max` of owner-masked
reads return the owner's untouched value.

Training through a group: `GroupShards.sum` is an autograd function
whose forward is the all-reduce and whose backward is the identity, and
`GroupShards.copy` the other way round (identity forward, all-reduce of
the cotangent backward).  Summed partials y = sum_r p_r(x) of an input x
that every rank holds whole: y and its cotangent c are the same on every
rank, so rank r's partial gets c (the identity), and x's cotangent is
sum_r c dp_r/dx, the all-reduce that `copy` puts in front of the
partials.  That is the reference's `shard_map` transpose: it divides the
cotangent of an output not split over the axis by the axis size, then
transposes `psum` to `psum` (net: the identity), and it sums the
cotangent of an input not split over the axis over it.  An all-reduce in
`sum`'s backward would multiply every gradient behind it by the group
size.  `StackedShards.copy` is the identity: autograd sees every shard.

The layout's gather (`GroupShards.gather`, an autograd function): the
forward puts the ranks' blocks of a leaf together along a dim (each
block broadcast from its rank: gloo moves CUDA tensors only by
`broadcast` and `all_reduce`); the backward returns this rank's block of
the cotangent, all-reduced (SUM) over the group first when the ranks'
cotangents are partials (an FSDP leaf over `data`, whose ranks take
other rows of the batch), as it is when every rank holds the same one
(experts gathered over `model` for the plain combine).

`axis_group(mesh, axes)` is the subgroup of a mesh's process group over
some of its axes: the ranks that share this rank's coordinates on the
other axes (a data row's `model` ranks, a model column's `pod` and
`data` ranks).  `dist.new_group` is collective over the whole group, so
the first call makes every subgroup of that partition, in one order, on
every rank; later calls read the cache.

While a cost counter (`launch.op_cost`) is open, each collective reports
the bytes of its result on one position by kind ("all-gather" for
`all_gather`, "all-reduce" for `sum` / `min` / `max`), and its own local
arithmetic is not charged.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from repro_torch.launch import op_cost


def _reported(kind: str):
    """Report the wrapped collective's result to an open cost counter."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, x, *a, **kw):
            counter = op_cost.ACTIVE
            if counter is None:
                return fn(self, x, *a, **kw)
            with counter.paused():
                out = fn(self, x, *a, **kw)
            counter.collective(kind, out)
            return out
        return call
    return wrap


class StackedShards:
    """All `num_shards` shards in one process: values are (S, ...) stacks."""

    def __init__(self, num_shards: int):
        if int(num_shards) < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.local = tuple(range(self.num_shards))

    @_reported("all-reduce")
    def min(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(0)

    @_reported("all-reduce")
    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0)

    @_reported("all-reduce")
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)

    @_reported("all-gather")
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(S, ...) stack of every shard's value (already all here)."""
        return x

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """`x`, held whole by every shard: autograd already adds the
        shards' cotangents."""
        return x


class _SumRanks(torch.autograd.Function):
    """all_reduce(SUM) over a group; the cotangent passes as it is (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyRanks(torch.autograd.Function):
    """The identity; the cotangent is all-reduced (SUM) over a group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def global_rank(group, rank: int) -> int:
    """The global rank of `group`'s rank `rank`."""
    import torch.distributed as dist
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


class _GatherRanks(torch.autograd.Function):
    """The group's blocks put together along `dim`; the cotangent's block
    of this rank back, summed over the group first when `summed`."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        import torch.distributed as dist
        n, mine = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.dim, ctx.summed, ctx.n, ctx.mine = \
            group, dim, summed, n, mine
        x = x.contiguous()
        blocks = []
        for i in range(n):
            t = x if i == mine else torch.empty_like(x)
            dist.broadcast(t, src=global_rank(group, i), group=group)
            blocks.append(t)
        return torch.cat(blocks, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        if ctx.summed:
            g = g.contiguous().clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g.chunk(ctx.n, ctx.dim)[ctx.mine].contiguous(), None, None, \
            None


class GroupShards:
    """One shard per rank of a torch.distributed process group: values are
    (1, ...) stacks of this rank's shard."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("GroupShards needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self.num_shards = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local = (self.rank,)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist
        y = x[0].contiguous().clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    @_reported("all-reduce")
    def min(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.MIN)

    @_reported("all-reduce")
    def max(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.MAX)

    @_reported("all-reduce")
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' values added; differentiable (identity backward)."""
        return _SumRanks.apply(x[0], self.group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """`x`, held whole by every rank, as the input of per-rank
        partials: its cotangent is all-reduced over the group."""
        return _CopyRanks.apply(x, self.group)

    @_reported("all-gather")
    def gather(self, x: torch.Tensor, dim: int, summed: bool = True
               ) -> torch.Tensor:
        """Every rank's block of a value put together along `dim`, in rank
        order; differentiable (see the module docstring): `summed` when
        the ranks' cotangents are partials to add."""
        return _GatherRanks.apply(x, self.group, dim, summed)

    @_reported("all-gather")
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(S, ...) stack of every rank's (1, ...) value, in rank order.
        Booleans travel as int32."""
        import torch.distributed as dist
        src = x.to(torch.int32) if x.dtype == torch.bool else x
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.num_shards)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, 0)
        return out.to(torch.bool) if x.dtype == torch.bool else out


_SUBGROUPS: dict = {}


def _world_pg(group):
    """The process group object behind `group` (the default one for
    None / WORLD): the cache key that a re-initialized group changes."""
    import torch.distributed as dist
    if group is None or group is dist.group.WORLD:
        return dist.distributed_c10d._get_default_group()
    return group


def axis_groups(mesh) -> None:
    """Every subgroup partition of `mesh.group` (each non-empty set of its
    axes), made now in one order on every rank: a partition made later on
    one rank's code path alone would wait in `dist.new_group` for the
    others."""
    for r in range(1, len(mesh.axis_names) + 1):
        for axes in itertools.combinations(mesh.axis_names, r):
            axis_group(mesh, axes)


def axis_group(mesh, axes) -> object | None:
    """This rank's subgroup of `mesh.group` over `axes` (names of the
    mesh; ones it lacks are ignored): None when they hold one position.
    Ranks are numbered row-major over the mesh's shape, and a subgroup
    lists its ranks in that order, so a rank's rank in it is its
    coordinate along `axes` (row-major)."""
    import torch.distributed as dist
    names = mesh.axis_names
    shape = mesh.devices.shape
    inside = [i for i, a in enumerate(names) if a in axes]
    size = int(np.prod([shape[i] for i in inside]))
    if size == 1:
        return None
    if size == int(np.prod(shape)):
        return mesh.group
    pg = _world_pg(mesh.group)
    key = (id(pg), shape, names, tuple(inside))
    hit = _SUBGROUPS.get(key)
    if hit is None or hit[0] is not pg:
        ranks = np.arange(int(np.prod(shape))).reshape(shape)
        outside = [i for i in range(len(names)) if i not in inside]
        made = {}
        # every rank makes every subgroup of the partition, in one order
        for at in itertools.product(*(range(shape[i]) for i in outside)):
            idx = [slice(None)] * len(names)
            for i, c in zip(outside, at):
                idx[i] = c
            members = sorted(int(r) for r in ranks[tuple(idx)].reshape(-1))
            if mesh.group not in (None, dist.group.WORLD):
                members = [dist.get_global_rank(mesh.group, r)
                           for r in members]
            made[at] = dist.new_group(members)
        hit = _SUBGROUPS[key] = (pg, made, outside)
    _, made, outside = hit
    coord = np.unravel_index(dist.get_rank(mesh.group), shape)
    return made[tuple(int(coord[i]) for i in outside)]
