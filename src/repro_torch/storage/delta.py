"""LSM-style mutable delta tier: append-only rows and tombstone bitmaps.

Every build-time index (graph, ScaNN, SQ8 shadow) is immutable; live
mutation lands here instead:

  * inserts append rows to a capacity-padded, unindexed segment, scanned
    exactly by `core.executor.DeltaExecutor` and merged into every base
    executor's top-k (core/mutable.py);
  * deletes set bits in a tombstone bitmap over the global id space
    [0, capacity), in the word layout of the filter bitmaps, so composing
    "live" into a query is one AND-NOT over words and a deleted row
    vanishes from every strategy without touching an index.

The host state (numpy) is the durable truth and is byte-equal to the
reference's after the same calls.  With a `device`, each class also keeps
a mirror on it for search: the delta rows (`DeltaTier.device_vectors`)
and the tombstone words as bit-reinterpreted int32
(`Tombstones.device_words`), refreshed on every mutation, so the search
path composes and scans without a trip through the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def _words(n: int) -> int:
    return (n + 31) // 32


@dataclasses.dataclass
class DeltaTier:
    """Append-only mutable segment over global ids
    [base_n, base_n + count).

    vectors beyond `count` are zero (never scored: the scan reads the
    first `count` rows).  `version` increments on every mutation."""

    base_n: int
    capacity: int                 # max delta rows before compaction MUST run
    dim: int
    count: int = 0
    version: int = 0
    vectors: np.ndarray = None    # (capacity, dim) f32
    inserted_bytes: int = 0       # cumulative logical payload (write-amp)
    device: Any = None            # mirror the rows here when set
    device_vectors: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.capacity <= 0:
            raise ValueError(f"delta capacity must be > 0, got "
                             f"{self.capacity}")
        if self.vectors is None:
            self.vectors = np.zeros((self.capacity, self.dim), np.float32)
        if self.vectors.shape != (self.capacity, self.dim):
            raise ValueError(
                f"delta vectors shape {self.vectors.shape} != "
                f"{(self.capacity, self.dim)}")
        if self.device is not None:
            self.device_vectors = torch.as_tensor(
                self.vectors, device=torch.device(self.device)).clone()

    @property
    def fill(self) -> float:
        return self.count / self.capacity

    def append(self, rows: np.ndarray) -> np.ndarray:
        """Append rows; returns their global ids.  Raises when the tier
        is full: the caller must compact first (`MutableIndex.insert`
        auto-compacts)."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected (m, {self.dim}) rows, got "
                             f"{rows.shape}")
        m = rows.shape[0]
        if self.count + m > self.capacity:
            raise DeltaFull(
                f"delta tier full: {self.count}+{m} > {self.capacity}")
        self.vectors[self.count: self.count + m] = rows
        if self.device_vectors is not None:
            self.device_vectors[self.count: self.count + m] = \
                torch.as_tensor(rows, device=self.device_vectors.device)
        ids = self.base_n + self.count + np.arange(m, dtype=np.int64)
        self.count += m
        self.version += 1
        self.inserted_bytes += int(rows.nbytes)
        return ids

    def local_of(self, global_ids: np.ndarray) -> np.ndarray:
        return np.asarray(global_ids, np.int64) - self.base_n

    def reset(self, base_n: int) -> None:
        """Empty the tier after compaction folded it into the base at the
        new `base_n` (rows keep their global ids)."""
        self.base_n = base_n
        self.count = 0
        self.version += 1
        self.vectors[:] = 0.0
        if self.device_vectors is not None:
            self.device_vectors.zero_()


class DeltaFull(RuntimeError):
    """The delta tier hit capacity; compaction must fold it first."""


class Tombstones:
    """Packed delete bitmap over the global id space [0, capacity).

    The uint32 word layout of the filter bitmaps, so filter AND NOT
    tombstone is the whole delete story for every executor: a deleted
    row's filter bit is cleared before any index probes it.  With a
    `device`, `device_words` mirrors `words` as int32 on it."""

    def __init__(self, capacity: int,
                 words: np.ndarray | None = None, device=None):
        self.capacity = capacity
        if words is None:
            self.words = np.zeros(_words(capacity), np.uint32)
        else:
            words = np.asarray(words, np.uint32)
            if words.shape != (_words(capacity),):
                raise ValueError(
                    f"tombstone words shape {words.shape} != "
                    f"({_words(capacity)},)")
            self.words = words.copy()
        self.version = 0
        self.device = None if device is None else torch.device(device)
        self.device_words: Optional[torch.Tensor] = None
        self._refresh()

    def _refresh(self) -> None:
        if self.device is not None:
            self.device_words = torch.as_tensor(
                self.words.view(np.int32).copy(), device=self.device)

    @property
    def count(self) -> int:
        return int(np.unpackbits(
            self.words.view(np.uint8), bitorder="little").sum())

    def mark(self, ids: np.ndarray) -> int:
        """Tombstone `ids`; returns how many were newly dead (repeat
        deletes are idempotent)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return 0
        if (ids < 0).any() or (ids >= self.capacity).any():
            raise ValueError(f"delete ids out of range [0, "
                             f"{self.capacity})")
        before = self.count
        w = ids >> 5
        b = (np.uint32(1) << (ids & 31).astype(np.uint32))
        np.bitwise_or.at(self.words, w, b)
        self.version += 1
        self._refresh()
        return self.count - before

    def is_dead(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        return ((self.words[ids >> 5] >> (ids & 31).astype(np.uint32))
                & np.uint32(1)).astype(bool)

    def live_mask(self, filter_words: np.ndarray) -> np.ndarray:
        """Compose deletes into packed filter bitmaps: filter AND NOT
        dead.  `filter_words` (..., W') may be narrower than the tombstone
        span; only the overlapping words are masked, and the input is
        never mutated.  On the device: `types.bitmap_andnot(words,
        device_words)`."""
        fw = np.asarray(filter_words, np.uint32)
        w = min(fw.shape[-1], self.words.shape[0])
        out = fw.copy()
        out[..., :w] &= ~self.words[:w]
        return out

    def dead_ids(self) -> np.ndarray:
        bits = np.unpackbits(self.words.view(np.uint8), bitorder="little")
        return np.nonzero(bits[: self.capacity])[0].astype(np.int64)
