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
"""
from __future__ import annotations

import torch


class StackedShards:
    """All `num_shards` shards in one process: values are (S, ...) stacks."""

    def __init__(self, num_shards: int):
        if int(num_shards) < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.local = tuple(range(self.num_shards))

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(0)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(S, ...) stack of every shard's value (already all here)."""
        return x


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

    def min(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.MIN)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.MAX)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(x, dist.ReduceOp.SUM)

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
