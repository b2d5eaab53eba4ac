"""Sharded views of the graph and storage tiers (DESIGN.md §13).

The mesh-sharded frontier engine partitions every row-indexed tier (the
full-precision heap and its norms, the SQ8 shadow, the adjacency of every
level) by contiguous row range over S shards: shard s owns global rows
[s * local_n, (s + 1) * local_n), local_n = ceil(n / S), the last block
zero / -1 padded.  A view presents the global geometry (`n`, `dim`,
`num_levels`, so visited maps, traces and budgets keep their one-device
sizes) while holding only the blocks of the shards in this process:
every block leaf carries a leading stack dim, one row per held shard, and
`shards` names them.  The reference derives a shard's offset from
`lax.axis_index`; the port has no axis index, so a view carries its shard
indices and `offset(i) = shards[i] * local_n`.

`core.graph_search` dispatches every row read on these views: a read of
global row g resolves on the shard that owns it, and in `collective` mode
the shard collectives (`core.collectives`) select the owner's untouched
value (non-owners give +inf / INT32_MIN), so the read is bit-equal to the
one-device read.  With `collective=False` a one-shard view describes the
shard's induced subgraph: remote reads come back masked (+inf distances,
-1 neighbors), the traversal mode of the drift loop between beam
exchanges (`core.distributed`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class ShardStore:
    """The row-range blocks of a `VectorStore` (+ SQ8 shadow) held here.

    `vectors` (s, local_n, d) f32 and `norms_sq` (s, local_n), or None on
    an SQ8-only view; `q_vectors` (s, local_n, d) int8 and `q_norms_sq`
    (s, local_n); `q_scale` / `q_mean` (d,) are global, replicated."""

    vectors: Optional[torch.Tensor]
    norms_sq: Optional[torch.Tensor]
    shards: tuple[int, ...]
    n_total: int
    coll: object                       # core.collectives implementation
    metric: str = "l2"
    collective: bool = True
    q_vectors: Optional[torch.Tensor] = None
    q_scale: Optional[torch.Tensor] = None
    q_mean: Optional[torch.Tensor] = None
    q_norms_sq: Optional[torch.Tensor] = None

    def _block(self) -> torch.Tensor:
        return self.vectors if self.vectors is not None else self.q_vectors

    @property
    def n(self) -> int:
        return self.n_total

    @property
    def dim(self) -> int:
        return self._block().shape[-1]

    @property
    def local_n(self) -> int:
        return self._block().shape[1]

    @property
    def device(self) -> torch.device:
        return self._block().device

    @property
    def has_sq8(self) -> bool:
        return self.q_vectors is not None

    def offset(self, i: int) -> int:
        """First global row of the i-th held block."""
        return self.shards[i] * self.local_n

    def select(self, i: int, collective: bool) -> "ShardStore":
        """A one-shard view of the i-th held block."""
        def one(t):
            return None if t is None else t[i:i + 1]
        return dataclasses.replace(
            self, vectors=one(self.vectors), norms_sq=one(self.norms_sq),
            q_vectors=one(self.q_vectors), q_norms_sq=one(self.q_norms_sq),
            shards=(self.shards[i],), collective=collective)


@dataclasses.dataclass(frozen=True)
class ShardGraph:
    """The row-range blocks of an `HNSWGraph` held here.

    `neighbors` is (L, s, local_n, deg) int32 (the level first, so that
    when S divides n it is a reshape of the graph's (L, n, deg) table, no
    copy); its values are GLOBAL row ids, -1 padded.  `entry_point` is the
    global entry; `local_entry[i]` the i-th held shard's own highest-level
    node (global id, -1 on an all-padding shard), the seed the drift loop
    zooms in from."""

    neighbors: torch.Tensor
    entry_point: int
    local_entry: tuple[int, ...]
    shards: tuple[int, ...]
    n_total: int
    coll: object
    m: int = 16
    collective: bool = True

    @property
    def n(self) -> int:
        return self.n_total

    @property
    def num_levels(self) -> int:
        return self.neighbors.shape[0]

    @property
    def local_n(self) -> int:
        return self.neighbors.shape[2]

    def offset(self, i: int) -> int:
        return self.shards[i] * self.local_n

    def select(self, i: int, collective: bool,
               local_entry: bool = False) -> "ShardGraph":
        """A one-shard view of the i-th held block; `local_entry` makes its
        zoom-in start from the shard's own entry."""
        return dataclasses.replace(
            self, neighbors=self.neighbors[:, i:i + 1],
            local_entry=(self.local_entry[i],), shards=(self.shards[i],),
            collective=collective,
            entry_point=self.local_entry[i] if local_entry
            else self.entry_point)
