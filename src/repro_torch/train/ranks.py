"""Training and serving across the ranks of a process group.

A mesh from `launch.mesh.make_mesh` made while a `torch.distributed`
process group with one rank a position is initialized carries that group:
`build_model(cfg, mesh)`, `make_train_step`, `Trainer` and `ServeEngine`
then run one rank a position, as the reference runs one device a position
of its mesh.  `RankLayout` holds what they share:

  * the layout (`launch.sharding.rank_specs`): with the EP combine a MoE's
    experts split over `model`, every other leaf whole on every rank;
    the optimizer state laid out as the params;
  * the batch split over the `pod` and `data` ranks by `batch_specs`;
  * gradients summed over a rank's data ranks (its model column), after
    the backward and before compression and the optimizer;
  * `split`: the process group each leaf's block is split over, for the
    clip's global norm and the int8 scale;
  * the checkpoint gather: rank 0 rebuilds the global tree from every
    rank's blocks (`launch.sharding.gather`) and writes the reference's
    bytes.

Transport: gloo takes CUDA tensors for `all_reduce` and `broadcast`
only, so every other collective here (`gather`, `all_gather`) moves host
tensors explicitly.  NCCL refuses two ranks on one card; on one card the
ranks use gloo.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import axis_group
from repro_torch.launch.mesh import batch_axes
from repro_torch.launch.sharding import (NamedSharding, P, batch_specs,
                                         map_leaves, rank_specs, to_named)
from repro_torch.launch.sharding import gather as gather_blocks
from repro_torch.optim.adamw import tree_leaves


def _dist():
    import torch.distributed as dist
    return dist


def _global(group, rank: int) -> int:
    """The global rank of `group`'s rank `rank`."""
    dist = _dist()
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


class RankLayout:
    """The layout and collectives of `cfg` on the ranks of `mesh.group`."""

    def __init__(self, cfg: ArchConfig, mesh):
        if mesh is None or mesh.group is None:
            raise ValueError("RankLayout needs a mesh with a process group "
                             "attached")
        dist = _dist()
        self.cfg, self.mesh = cfg, mesh
        self.rank = dist.get_rank(mesh.group)
        self.data_group = axis_group(mesh, batch_axes(mesh))
        self._axis_groups: dict = {}

    # -- layout -----------------------------------------------------------

    def specs(self, tree: Any) -> Any:
        return rank_specs(self.cfg, tree, self.mesh)

    def shardings(self, tree: Any) -> Any:
        """A NamedSharding a leaf: `restore_checkpoint(shardings=)`."""
        return to_named(self.specs(tree), self.mesh)

    def place(self, tree: Any) -> Any:
        """This rank's block of every leaf of a global tree, on its
        device."""
        return map_leaves(lambda _, leaf, spec: NamedSharding(
            self.mesh, spec).place(leaf), tree, self.specs(tree))

    def _group(self, spec: P):
        names = tuple(n for a in spec if a is not None
                      for n in (a if isinstance(a, tuple) else (a,)))
        if names not in self._axis_groups:
            self._axis_groups[names] = axis_group(self.mesh, names) \
                if names else None
        return self._axis_groups[names]

    def whole(self, tree: Any) -> Any:
        """Every leaf of a tree of this rank's blocks whole, on every rank:
        a split leaf's blocks are broadcast over its group (gloo
        broadcasts CUDA tensors) and put together along the split dim."""
        dist = _dist()

        def one(_, leaf, spec):
            group = self._group(spec)
            if group is None:
                return leaf
            mine = dist.get_rank(group)
            blocks = []
            for i in range(dist.get_world_size(group)):
                t = leaf.clone() if i == mine else torch.empty_like(leaf)
                dist.broadcast(t, src=_global(group, i), group=group)
                blocks.append(t)
            dim = next(i for i, a in enumerate(spec) if a is not None)
            return torch.cat(blocks, dim)

        return map_leaves(one, tree, self.specs(tree))

    def split(self, tree: Any) -> Any:
        """The process group each leaf's block is split over (None: the
        leaf is whole here), in `tree`'s structure."""
        return map_leaves(lambda _, __, spec: self._group(spec), tree,
                    self.specs(tree))

    # -- the batch --------------------------------------------------------

    def batch(self, batch: dict, microbatched: bool = False) -> dict:
        """This rank's rows of a global batch (numpy arrays or tensors) on
        its device, split over the `pod` and `data` ranks by
        `batch_specs`; `microbatched` leaves carry a leading
        (microbatches, ...) dim, which stays whole."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v)
            one = t[0] if microbatched else t
            spec = batch_specs(self.cfg, {k: one}, self.mesh)[k]
            if microbatched:
                spec = P(None, *spec)
            out[k] = NamedSharding(self.mesh, spec).place(t)
        return out

    def reduce(self, grads: Any) -> Any:
        """Every leaf summed over this rank's data ranks, in place."""
        if self.data_group is not None:
            dist = _dist()
            for g in tree_leaves(grads):
                dist.all_reduce(g, op=dist.ReduceOp.SUM,
                                group=self.data_group)
        return grads

    def rows(self, local: np.ndarray) -> np.ndarray:
        """The global batch's rows from every data rank's `local` rows (the
        same shape on each), in the batch's order, through the host."""
        if self.data_group is None:
            return local
        dist = _dist()
        t = torch.as_tensor(np.ascontiguousarray(local))
        parts = [torch.empty_like(t) for _ in range(
            dist.get_world_size(self.data_group))]
        dist.all_gather(parts, t, group=self.data_group)
        return torch.cat(parts, 0).numpy()

    def all_true(self, flag: bool) -> bool:
        """`flag` and every other data rank's, through the host."""
        if self.data_group is None:
            return flag
        dist = _dist()
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.data_group)
        return bool(t[0])

    # -- checkpoints ------------------------------------------------------

    @property
    def writer(self) -> bool:
        """Rank 0 of the mesh's group writes the checkpoints."""
        return self.rank == 0

    def _root(self) -> int:
        return _global(self.mesh.group, 0)

    def gather(self, tree: Any) -> Optional[Any]:
        """The global tree on rank 0 (host tensors), None on the others:
        each split leaf's blocks travel as bytes through the host
        (`dist.gather`) and `launch.sharding.gather` puts them together;
        a whole leaf is rank 0's own."""
        dist = _dist()
        world = dist.get_world_size(self.mesh.group)
        named = self.shardings(tree)

        def one(_, leaf, shd):
            host = leaf.detach().cpu().contiguous()
            if self._group(shd.spec) is None:
                return host if self.writer else None
            raw = host.reshape(-1).view(torch.uint8)
            parts = [torch.empty_like(raw) for _ in range(world)] \
                if self.writer else None
            dist.gather(raw, parts, dst=self._root(), group=self.mesh.group)
            if not self.writer:
                return None
            blocks = [p.view(host.dtype).reshape(host.shape) for p in parts]
            return gather_blocks(blocks, shd)

        out = map_leaves(one, tree, named)
        return out if self.writer else None

    def broadcast_int(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's `value` (None travels as -1) on every rank."""
        dist = _dist()
        t = torch.tensor([-1 if value is None else int(value)],
                         dtype=torch.int64)
        dist.broadcast(t, src=self._root(), group=self.mesh.group)
        return None if int(t[0]) < 0 else int(t[0])


def layout(bundle) -> Optional[RankLayout]:
    """The bundle's RankLayout when its mesh has a process group, else
    None (one process: the reference's single device, or a mesh run
    stacked)."""
    mesh = getattr(bundle, "mesh", None)
    if mesh is None or mesh.group is None:
        return None
    return RankLayout(bundle.cfg, mesh)

