"""Training and serving across the ranks of a process group.

A mesh from `launch.mesh.make_mesh` made while a `torch.distributed`
process group with one rank a position is initialized carries that group:
`build_model(cfg, mesh)`, `make_train_step`, `Trainer` and `ServeEngine`
then run one rank a position, as the reference runs one device a position
of its mesh.  `RankLayout` holds what they share:

  * the layout (`launch.sharding.rank_specs`): every leaf is the block
    its fitted partition spec gives a rank, as the reference's
    `param_specs` place it (heads, ffn hidden dim and vocab over `model`,
    a MoE's experts over `model`, with fsdp the d_model dims over
    `data`); the optimizer state laid out as the params;
  * the batch split over the `pod` and `data` ranks by `batch_specs`,
    and under the `sp` scheme its positions over `model`;
  * what each leaf's gradient is summed over.  In the backward, over
    `model` where every model rank holds the whole leaf but computes a
    part (`GroupShards.copy`: the input of a split product, wk / wv read
    by kv head), and over `data` where the leaf splits over `data` (the
    FSDP gather's backward); then `reduce` adds it over the batch axes
    (`pod`, `data`, and under `sp` `model`) that the leaf does not split
    over, before
    compression and the optimizer.  So every rank's gradient is its
    block of the global gradient, each term added once;
  * `split`: the process group each leaf's block is split over, for the
    clip's global norm and the int8 scale;
  * the checkpoint gather: rank 0 rebuilds the global tree from every
    rank's blocks (`launch.sharding.gather`) and writes the reference's
    bytes.

Every subgroup partition of the mesh is made when a layout is (and by
`build_model`), in one order on every rank (`core.collectives.
axis_groups`).

Transport: gloo takes CUDA tensors for `all_reduce` and `broadcast`
only, so every other collective here (`gather`, `all_gather`) moves host
tensors explicitly.  NCCL refuses two ranks on one card; on one card the
ranks use gloo.
"""
from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import flatten_with_path
from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import (GroupShards, axis_group,
                                          axis_groups, global_rank)
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.launch.sharding import (NamedSharding, P, batch_specs,
                                         entry_axes, map_leaves, rank_specs,
                                         to_named)
from repro_torch.launch.sharding import gather as gather_blocks
from repro_torch.models.api import build_model


def _dist():
    import torch.distributed as dist
    return dist


class RankLayout:
    """The layout and collectives of `cfg` on the ranks of `mesh.group`."""

    def __init__(self, cfg: ArchConfig, mesh):
        if mesh is None or mesh.group is None:
            raise ValueError("RankLayout needs a mesh with a process group "
                             "attached")
        dist = _dist()
        self.cfg, self.mesh = cfg, mesh
        self.rank = dist.get_rank(mesh.group)
        axis_groups(mesh)
        self.data_group = axis_group(mesh, batch_axes(mesh))
        self._shapes = {path: tuple(leaf.shape) for path, leaf in
                        flatten_with_path(build_model(cfg).init(0, "meta"))}

    # -- layout -----------------------------------------------------------

    def specs(self, tree: Any) -> Any:
        """The layout of a tree of global leaves or of this rank's blocks:
        each leaf's spec is fitted to the global shape of the param it is
        laid out as (the params, the moments and error buffers under
        their prefixes), which a block's shape cannot tell (3 of 6
        experts, or 3 whole ones?)."""
        def shape(path, leaf):
            key = _PREFIXES.sub("", path)
            return torch.empty(self._shapes.get(key, tuple(leaf.shape)),
                               device="meta")
        return rank_specs(self.cfg, map_leaves(shape, tree), self.mesh)

    def shardings(self, tree: Any) -> Any:
        """A NamedSharding a leaf: `restore_checkpoint(shardings=)`."""
        return to_named(self.specs(tree), self.mesh)

    def place(self, tree: Any) -> Any:
        """This rank's block of every leaf of a global tree, on its
        device."""
        return map_leaves(lambda _, leaf, spec: NamedSharding(
            self.mesh, spec).place(leaf), tree, self.specs(tree))

    def _axes(self, spec: P) -> tuple:
        """The mesh's axes that `spec` names, in the mesh's order."""
        names = {n for a in spec for n in entry_axes(a)}
        return tuple(a for a in self.mesh.axis_names if a in names)

    def _group(self, spec: P):
        axes = self._axes(spec)
        return axis_group(self.mesh, axes) if axes else None

    def whole(self, tree: Any) -> Any:
        """Every leaf of a tree of this rank's blocks whole, on every rank:
        a split leaf's blocks are broadcast over its group (gloo
        broadcasts CUDA tensors) and put together as
        `launch.sharding.gather` puts a mesh's blocks, on the mesh of the
        axes it splits over (one dim or several)."""
        dist = _dist()

        def one(_, leaf, spec):
            group = self._group(spec)
            if group is None:
                return leaf
            mine = dist.get_rank(group)
            blocks = []
            for i in range(dist.get_world_size(group)):
                t = leaf.clone() if i == mine else torch.empty_like(leaf)
                dist.broadcast(t, src=global_rank(group, i), group=group)
                blocks.append(t)
            axes = self._axes(spec)
            sub = Mesh(np.empty(tuple(self.mesh.shape[a] for a in axes),
                                dtype=object), axes)
            return gather_blocks(blocks, NamedSharding(sub, spec))

        return map_leaves(one, tree, self.specs(tree))

    def without_fsdp(self, tree: Any) -> Any:
        """A tree of this rank's blocks with every leaf that splits over
        `data` (fsdp; every dense weight under the `sp` scheme) gathered
        over it, out of autograd: the blocks a serving engine holds,
        which the models' blocks take as they are."""
        group = axis_group(self.mesh, ("data",))
        if group is None:
            return tree
        data = GroupShards(group)

        def one(_, leaf, spec):
            with torch.no_grad():
                for dim, a in enumerate(spec):
                    if "data" in entry_axes(a):
                        leaf = data.gather(leaf, dim)
            return leaf

        return map_leaves(one, tree, self.specs(tree))

    def split(self, tree: Any) -> Any:
        """The process group each leaf's block is split over (None: the
        leaf is whole here), in `tree`'s structure."""
        return map_leaves(lambda _, __, spec: self._group(spec), tree,
                    self.specs(tree))

    # -- the batch --------------------------------------------------------

    def batch(self, batch: dict, microbatched: bool = False,
              positions: bool = True) -> dict:
        """This rank's rows of a global batch (numpy arrays or tensors) on
        its device, split over the `pod` and `data` ranks by
        `batch_specs`; under the `sp` scheme every (B, T, ...) leaf's
        positions split over `model` too (`batch_specs(...,
        shard_seq=True)`; `positions=False` keeps them whole, as a
        decode step takes them); `microbatched` leaves carry a leading
        (microbatches, ...) dim, which stays whole."""
        seq = positions and self.sp
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v)
            one = t[0] if microbatched else t
            spec = batch_specs(self.cfg, {k: one}, self.mesh,
                               shard_seq=seq)[k]
            if seq and one.dim() >= 2 and spec[1] != "model":
                raise ValueError(f"{k}: {tuple(one.shape)} does not split "
                                 f"its positions over `model` ({spec})")
            if microbatched:
                spec = P(None, *spec)
            out[k] = NamedSharding(self.mesh, spec).place(t)
        return out

    @property
    def sp(self) -> bool:
        """Whether the ranks split the sequence over `model` (the `sp`
        scheme on a `model` axis of more than one)."""
        return self.cfg.sharding_scheme == "sp" \
            and self.mesh.shape.get("model", 1) > 1

    def reduce(self, grads: Any) -> Any:
        """Every leaf summed, in place, over this rank's ranks on the batch
        axes that the leaf does not split over (under `sp` over `model`
        too, whose ranks hold other positions): an fsdp leaf's gradient
        came summed over `data` from the gather's backward."""
        dist = _dist()
        axes = batch_axes(self.mesh) + (("model",) if self.sp else ())

        def one(_, g, spec):
            named = self._axes(spec)
            group = axis_group(self.mesh, tuple(a for a in axes
                                                if a not in named))
            if group is not None:
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
            return g

        if axis_group(self.mesh, axes) is not None:
            map_leaves(one, grads, self.specs(grads))
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
        return global_rank(self.mesh.group, 0)

    def gather(self, tree: Any) -> Optional[Any]:
        """The global tree on rank 0 (host tensors), None on the others:
        each split leaf's blocks travel as bytes through the host
        (`dist.gather`) and `launch.sharding.gather` puts them together;
        a whole leaf is rank 0's own."""
        dist = _dist()
        world = dist.get_world_size(self.mesh.group)
        named = self.shardings(tree)

        def one(_, leaf, shd):
            if self._group(shd.spec) is None:
                return (leaf.detach().cpu().contiguous() if self.writer
                        else None)
            host = leaf.detach().cpu().contiguous()
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


_PREFIXES = re.compile(r"^(\['(params|opt|adamw|ef_error|m|v)'\])+")


def layout(bundle) -> Optional[RankLayout]:
    """The bundle's RankLayout when its mesh has a process group, else
    None (one process: the reference's single device, or a mesh run
    stacked)."""
    mesh = getattr(bundle, "mesh", None)
    if mesh is None or mesh.group is None:
        return None
    return RankLayout(bundle.cfg, mesh)

