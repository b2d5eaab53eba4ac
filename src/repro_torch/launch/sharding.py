"""Parameter / activation partition rules (DP / TP / EP / FSDP / SP) and
the placement of a tree on a mesh.

The counterpart of the reference's `launch/sharding.py`.  Rules are
(path-regex -> PartitionSpec template) pairs; templates name the TRAILING
dims of a leaf (scan / stack dims are left-padded with None).  With
`cfg.fsdp` the weights additionally shard over the data axis (ZeRO-style:
the optimizer state inherits the same specs, so m / v are fully
sharded).  Paths are the reference's `keystr` strings (`['layers']
['attn']['wq']`, `[0]`), as `checkpoint.store.flatten_with_path` spells
them, so every rule matches what it matches there.

GQA caveat: kv-head counts (often 8) don't divide the 16-way model axis;
kv projections / caches stay replicated across `model` (Megatron GQA-TP
semantics) while q / o shard.  `fit_spec` asks only that a dim divide, so
q / o columns split over `model` even where a rank's share is not whole
heads (llama3.2-3b's 24 heads over 16: 192 columns, 1.5 heads a rank)
or not whole GQA groups; `rank_heads` says which, and the blocks on
ranks (`models.layers.attention_weights`) gather q over `model` where
the heads are cut.

`PartitionSpec` is a small tuple-like record of axis entries (None, a
name, or a tuple of names); `NamedSharding` pairs one with a
`launch.mesh.Mesh`.  `NamedSharding.place` lays a global value out on the
mesh: whole on the positions' device when the mesh runs its positions
stacked in this process (no process group), else this rank's block, cut
by the spec at the rank's mesh coordinate; `gather` puts the blocks of
every position back together.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.store import flatten_with_path, unflatten
from repro_torch.configs.base import ArchConfig


class PartitionSpec:
    """Axis entries of a leaf's dims, leading dims first: None
    (replicated), an axis name, or a tuple of names (the dim split over
    their product, the first name outermost).  Iterates, indexes and
    compares as the tuple of its entries."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(tuple(p) if isinstance(p, list) else p
                            for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + repr(self._parts)


P = PartitionSpec


def _rules(cfg: ArchConfig, data_axis, model_axis) -> list[tuple[str, P]]:
    if cfg.sharding_scheme == "sp":
        # sequence-parallel activations: weights FSDP over data, no TP dims
        d, m = data_axis, None
    else:
        d = data_axis if cfg.fsdp else None
        m = model_axis
    return [
        # embeddings / head
        (r"embed.*\btok\b", P(m, d)),
        (r"embed.*unembed", P(d, m)),
        (r"\bhead\b", P(d, None)),
        (r"adapter", P(d, None)),
        # attention
        (r"attn.*\bwq\b|shared_attn.*\bwq\b", P(d, m)),
        (r"attn.*\bwk\b|shared_attn.*\bwk\b", P(d, None)),
        (r"attn.*\bwv\b|shared_attn.*\bwv\b", P(d, None)),
        (r"attn.*\bwo\b|shared_attn.*\bwo\b", P(m, d)),
        # MoE (leading E dim shards over model = EP)
        (r"ffn.*router", P(None, None)),
        (r"ffn.*\bwg\b|ffn.*\bwu\b", _moe_spec(cfg, m, d, up=True)),
        (r"ffn.*\bwd\b", _moe_spec(cfg, m, d, up=False)),
        # dense MLP / rwkv cmix / shared mlp
        (r"(mlp|cmix).*\bwk\b", P(d, m)),
        (r"(mlp|cmix).*\bwv\b", P(m, d)),
        (r"cmix.*\bwr\b", P(d, None)),
        # rwkv tmix
        (r"tmix.*\bw[rkvg]\b", P(d, m)),
        (r"tmix.*\bwo\b", P(m, d)),
        (r"tmix.*lora_a", P(d, None)),
        (r"tmix.*wlora_a", P(d, None)),
        # mamba
        (r"in_proj", P(d, m)),
        (r"out_proj", P(m, d)),
        # catch-alls
        (r"norm|mu\b|w0|\bu\b|ln_w|a_log|d_skip|dt_bias|conv|mask_embed"
         r"|lora_b|wlora_b", P()),
    ]


def _moe_spec(cfg: ArchConfig, m, d, up: bool) -> P:
    if cfg.family != "moe":
        return P(d, m) if up else P(m, d)
    # experts always shard over `model` (EP), including under the SP
    # scheme, where dense weights are FSDP-only
    return P("model", d, None) if up else P("model", None, d)


def _dense_fallback(cfg: ArchConfig, ndim: int, data_axis, model_axis) -> P:
    return P(*([None] * ndim))


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def fit_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop axis names whose size doesn't divide the dim (a layout needs
    exact divisibility) or that the mesh doesn't have."""
    sizes = _axis_sizes(mesh)

    def fit(dim: int, a):
        names = a if isinstance(a, (tuple, list)) else (a,)
        kept = []
        prod = 1
        for n in names:
            if n is None or n not in sizes:
                continue
            if dim % (prod * sizes[n]) == 0:
                kept.append(n)
                prod *= sizes[n]
        if not kept:
            return None
        return tuple(kept) if len(kept) > 1 else kept[0]

    tpl = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return P(*[fit(d, a) for d, a in zip(shape, tpl)])


def spec_for_path(cfg: ArchConfig, path: str, ndim: int, data_axis,
                  model_axis) -> P:
    for pat, spec in _rules(cfg, data_axis, model_axis):
        if re.search(pat, path):
            tpl = tuple(spec)
            if len(tpl) > ndim:
                tpl = tpl[len(tpl) - ndim:]
            pad = ndim - len(tpl)
            return P(*([None] * pad + list(tpl)))
    return _dense_fallback(cfg, ndim, data_axis, model_axis)


def map_leaves(fn, tree: Any, *rest: Any) -> Any:
    """`fn(path, leaf, *the leaves of `rest` at that path)` for every leaf,
    in `tree`'s structure (`rest`: trees of the same structure)."""
    others = [[leaf for _, leaf in flatten_with_path(r)] for r in rest]
    return unflatten(tree, [fn(path, leaf, *(o[i] for o in others))
                            for i, (path, leaf)
                            in enumerate(flatten_with_path(tree))])


def param_specs(cfg: ArchConfig, params_shape: Any, mesh=None) -> Any:
    """PartitionSpec tree matching a params (shape) tree: any leaf with a
    `.shape` (a meta tensor from `bundle.init(key, "meta")`)."""
    def one(name, leaf):
        spec = spec_for_path(cfg, name, len(leaf.shape), "data", "model")
        return spec if mesh is None else fit_spec(spec, leaf.shape, mesh)
    return map_leaves(one, params_shape)


def opt_specs(cfg: ArchConfig, opt_shape: Any, pspecs: Any,
              mesh=None) -> Any:
    """Optimizer state: m / v inherit the weight specs; scalars
    replicate.  `pspecs` is unused, as in the reference."""
    def one(name, leaf):
        if re.search(r"\bstep\b", name):
            return P()
        # strip the leading ['m']/['v']/['adamw']/['ef_error'] wrappers and
        # look the rest up in the param rules
        stripped = re.sub(r"^\['(adamw|ef_error)'\]", "", name)
        stripped = re.sub(r"^\['(m|v)'\]", "", stripped)
        spec = spec_for_path(cfg, stripped, len(leaf.shape), "data", "model")
        return spec if mesh is None else fit_spec(spec, leaf.shape, mesh)
    return map_leaves(one, opt_shape)


def entry_axes(entry) -> tuple:
    """The axis names of one entry of a spec (None, a name or a tuple)."""
    return () if entry is None else (tuple(entry) if isinstance(
        entry, (tuple, list)) else (entry,))


class HeadSplit(NamedTuple):
    """`model` rank r's share of attention when q / o split over `model`:
    its q columns [c0, c1) (of wq, and the rows of wo), the q heads
    [q0, q1) they touch, the kv heads [kv0, kv1) those q heads read,
    whether the columns are `whole` heads, and whether, besides, the q
    heads read their kv heads in flash attention's grouping (q head i of
    the rank's reads kv head i // ((q1 - q0) / (kv1 - kv0)) of its
    range: `grouped`)."""

    c0: int
    c1: int
    q0: int
    q1: int
    kv0: int
    kv1: int
    whole: bool
    grouped: bool


def rank_heads(cfg: ArchConfig, s: int, r: int) -> HeadSplit:
    """The q columns [r H hd / S, (r + 1) H hd / S) that `fit_spec` gives
    `model` rank `r` of `s`, the heads they touch and the kv heads those
    read (GQA groups of H / KV), and whether they are whole heads and
    whole groups in order (`HeadSplit`)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    if (h * hd) % s:
        raise ValueError(f"{cfg.name}: {h * hd} q columns do not split over "
                         f"a model axis of {s}")
    per = h * hd // s
    c0, c1 = r * per, (r + 1) * per
    q0, q1 = c0 // hd, -(-c1 // hd)
    g = h // kv
    kv0, kv1 = q0 // g, (q1 - 1) // g + 1
    whole = c0 % hd == 0 and c1 % hd == 0
    nq, nk = q1 - q0, kv1 - kv0
    grouped = whole and nq % nk == 0 and all(
        (q0 + i) // g - kv0 == i // (nq // nk) for i in range(nq))
    return HeadSplit(c0, c1, q0, q1, kv0, kv1, whole, grouped)


def check_rank_layout(cfg: ArchConfig) -> None:
    """What the ranks do not port is refused here.  Every scheme and
    family runs on ranks: with `tp` the fitted specs split heads, the
    ffn hidden dim and the vocab over `model`; with `sp` the dense
    weights have no `model` dim (FSDP over `data`, whatever `cfg.fsdp`
    says), a MoE's experts still split over `model`, and a rank holds
    its positions of the sequence (`models.layers`: K / V gathered over
    `model`, SSM states and token shifts handed across the ranks'
    boundaries)."""
    if cfg.sharding_scheme not in ("tp", "sp"):
        raise ValueError(f"{cfg.name}: unknown sharding scheme "
                         f"{cfg.sharding_scheme!r}")


def rank_specs(cfg: ArchConfig, tree: Any, mesh) -> Any:
    """How a tree sits on the ranks of a process group, one rank a mesh
    position: every leaf (params, the AdamW moments, the int8 error
    buffers, each under whatever prefix) takes its fitted partition spec,
    `fit_spec(spec_for_path(...))`, the spec `param_specs` / `opt_specs`
    give it; scalars replicate.  So with the `tp`
    scheme q / o columns, the ffn hidden dim and the vocab split over
    `model` where they divide it (whole heads or not, see `rank_heads`),
    RWKV6's r / k / v / g / o and channel-mix columns and Mamba2's
    in_proj columns and out_proj rows too, a MoE's experts over `model`
    (EP), and with `cfg.fsdp` the d_model dims over `data` too.  With
    the `sp` scheme no dense leaf splits over `model` and the d_model
    dims split over `data` whatever `cfg.fsdp` says; a MoE's experts
    split over `model` (and `data`), and the batch's positions split
    over `model` (`train.ranks.RankLayout.batch`).

    A leaf's gradient on a rank is its block's: summed over `model` where
    every model rank holds the whole leaf but uses a part (wk / wv by kv
    head) or a partial (`GroupShards.copy`), over `data` by the FSDP
    gather's backward where the leaf splits over `data`, and over the
    batch axes it does not split over by `train.ranks.RankLayout.reduce`
    (under `sp` over `model` too, whose ranks take other positions).
    """
    check_rank_layout(cfg)
    return map_leaves(lambda path, leaf: fit_spec(spec_for_path(
        cfg, path, len(leaf.shape), "data", "model"), leaf.shape, mesh),
        tree)


def batch_specs(cfg: ArchConfig, batch_shape: Any, mesh,
                shard_seq: bool = False) -> Any:
    """Input batch: batch dim over (pod, data); optionally SP on seq."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bspec = baxes if baxes else None

    def one(path, leaf):
        ndim = len(leaf.shape)
        if leaf.shape[0] == 1:          # long_500k batch=1: replicate batch
            rest = [None] * (ndim - 1)
            if shard_seq and ndim >= 2:
                rest[0] = "data"
            return P(None, *rest)
        rest = [None] * (ndim - 1)
        if shard_seq and ndim >= 2:
            rest[0] = "model"           # SP: seq over model axis
        return P(bspec, *rest)

    return map_leaves(lambda p, l: fit_spec(one(p, l), l.shape, mesh),
                       batch_shape)


def cache_specs(cfg: ArchConfig, cache_shape: Any, mesh) -> Any:
    """KV caches: (layers/groups..., B, S, kv, hd): batch over (pod,data);
    kv heads replicated (GQA-TP); SSM states batch-sharded."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def one(name, leaf):
        shape = leaf.shape
        ndim = len(shape)
        # caches are built as (stack..., B, ...): the number of leading
        # stack dims is ndim - the leaf's per-batch rank
        if re.search(r"attn_k|attn_v|local_k|local_v|global_k|global_v",
                     name):
            # (g[, per], B, S, kv, hd)
            lead = ndim - 4
            spec = [None] * lead + [baxes, None, None, None]
            return P(*spec)
        if re.search(r"\bk\b|\bv\b", name) and ndim == 5:
            return P(None, baxes, None, None, None)
        if re.search(r"wkv", name):      # (L, B, H, C, C)
            return P(None, baxes, "model", None, None)
        if re.search(r"ssm", name):      # (..., B, H, P, N)
            lead = ndim - 4
            return P(*([None] * lead + [baxes, "model", None, None]))
        if re.search(r"x_prev|conv", name):
            lead = ndim - 3
            return P(*([None] * lead + [baxes, None, None]))
        return P(*([None] * ndim))

    return map_leaves(lambda p, l: fit_spec(one(p, l), l.shape, mesh),
                       cache_shape)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: how a global value is laid out on it."""

    mesh: Any
    spec: PartitionSpec

    def _dims(self, ndim: int) -> list[tuple[str, ...]]:
        """Each dim's axis names (outermost first)."""
        sizes = _axis_sizes(self.mesh)
        ents = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        if len(ents) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"value's {ndim} dims")
        out = []
        for a in ents:
            names = entry_axes(a)
            for n in names:
                if n not in sizes:
                    raise ValueError(f"axis {n!r} of {self.spec} is not an "
                                     f"axis of the mesh {self.mesh.shape}")
            out.append(names)
        return out

    def slices(self, shape: Sequence[int], coord: Sequence[int]
               ) -> tuple[slice, ...]:
        """The block of a global value of `shape` that the position at
        mesh coordinate `coord` holds."""
        sizes = _axis_sizes(self.mesh)
        at = dict(zip(self.mesh.axis_names, (int(c) for c in coord)))
        out = []
        for dim, names in zip(shape, self._dims(len(shape))):
            count, idx = 1, 0
            for n in names:
                count *= sizes[n]
                idx = idx * sizes[n] + at[n]
            if dim % count:
                raise ValueError(f"dim {dim} does not split over "
                                 f"{names} ({count} blocks)")
            step = dim // count
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def _coord(self) -> tuple[int, ...]:
        """This process's mesh coordinate: its rank's in the mesh's group."""
        import torch.distributed as dist
        rank = dist.get_rank(self.mesh.group)
        return tuple(int(c) for c in np.unravel_index(
            rank, self.mesh.devices.shape))

    def place(self, value: torch.Tensor) -> torch.Tensor:
        """`value` (the global value) laid out on the mesh: whole on the
        first position's device when the mesh has no process group (its
        positions run stacked in this process, as `StackedShards` holds a
        value), else this rank's block on its position's device."""
        if self.mesh.group is None:
            self._dims(value.dim())               # names checked all the same
            return value.to(self.mesh.devices.flat[0])
        c = self._coord()
        block = value[self.slices(value.shape, c)]
        return block.contiguous().to(self.mesh.devices[c])


def gather(blocks: Sequence[torch.Tensor], sharding: NamedSharding
           ) -> torch.Tensor:
    """The global value from every position's block, in rank order (row
    major over the mesh's shape); replicated blocks overlap."""
    grid = sharding.mesh.devices.shape
    if len(blocks) != int(np.prod(grid)):
        raise ValueError(f"{len(blocks)} blocks for a mesh of {grid}")
    first = blocks[0]
    sizes = _axis_sizes(sharding.mesh)
    shape = [b * int(np.prod([sizes[n] for n in names])) for b, names in
             zip(first.shape, sharding._dims(first.dim()))]
    out = first.new_empty(shape)
    for rank, block in enumerate(blocks):
        c = np.unravel_index(rank, grid)
        out[sharding.slices(shape, c)] = block.to(out.device)
    return out


def to_named(specs: Any, mesh) -> Any:
    """The NamedSharding of every spec of a tree."""
    return map_leaves(lambda _, s: NamedSharding(mesh, s), specs)


def per_position_bytes(shapes: Any, specs: Any, mesh) -> int:
    """Bytes one mesh position holds of a tree laid out by `specs` (the
    same structure): each leaf's bytes over the product of its spec's
    axis sizes.  Arithmetic on the shapes, not a measurement."""
    sizes = _axis_sizes(mesh)
    total = 0
    for (_, leaf), (_, spec) in zip(flatten_with_path(shapes),
                                    flatten_with_path(specs)):
        split = 1
        for a in spec:
            for n in entry_axes(a):
                split *= sizes[n]
        total += leaf.numel() * leaf.element_size() // split
    return total
