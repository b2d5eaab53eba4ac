"""Page geometry: the one owner of how objects map onto 8 KB pages.

Full-precision vector rows live on heap pages, SQ8 shadow rows on a dense
shadow heap, quantized ScaNN posting lists on leaf pages and HNSW adjacency
entries on index pages.  An object never straddles a page boundary it does
not have to: a row that fits in a page occupies exactly one page, a larger
row `ceil(bytes / PAGE_BYTES)` pages of its own.  So the logical page
touches per object equal the per-object constants the Table-6 counters
charge, and the layouts also pin which pages those are, which the buffer
pool needs.

Host-side numpy; nothing here touches a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAGE_BYTES = 8192
HEAP_PAGE_BYTES = PAGE_BYTES


def heap_pages_per_vector(dim: int) -> int:
    """Heap pages touched per full-precision (4 bytes/dim) vector fetch."""
    return max(1, -(-dim * 4 // PAGE_BYTES))


def quant_heap_pages_per_vector(dim: int) -> int:
    """Heap pages touched per SQ8 (1 byte/dim) vector fetch."""
    return max(1, -(-dim // PAGE_BYTES))


def scann_pages_per_leaf(cap: int, dp: int) -> int:
    """Quantized-leaf pages per ScaNN leaf: (C, dp) int8 tile on 8 KB pages."""
    return max(1, -(-cap * dp // PAGE_BYTES))


@dataclasses.dataclass(frozen=True)
class HeapLayout:
    """Vector rows on 8 KB heap pages: `rows_per_page` rows per page when a
    row fits, else `pages_per_row` consecutive pages per row.
    `value_bytes` is 4 for the full-precision heap, 1 for the SQ8 shadow
    heap (4x denser)."""

    n: int
    dim: int
    value_bytes: int = 4

    @property
    def row_bytes(self) -> int:
        return self.dim * self.value_bytes

    @property
    def pages_per_row(self) -> int:
        return max(1, -(-self.row_bytes // PAGE_BYTES))

    @property
    def rows_per_page(self) -> int:
        if self.pages_per_row > 1:
            return 1
        return max(1, PAGE_BYTES // self.row_bytes)

    @property
    def num_pages(self) -> int:
        if self.pages_per_row > 1:
            return self.n * self.pages_per_row
        return -(-self.n // self.rows_per_page)

    def pages_for_rows(self, rows: np.ndarray) -> np.ndarray:
        """Page ids touched fetching `rows`, in fetch order
        (`pages_per_row` consecutive pages per row)."""
        rows = np.asarray(rows, np.int64)
        ppr = self.pages_per_row
        if ppr == 1:
            return rows // self.rows_per_page
        return (rows[:, None] * ppr + np.arange(ppr)).reshape(-1)


@dataclasses.dataclass(frozen=True)
class ScannLeafLayout:
    """Quantized ScaNN posting lists: each leaf's (C, dp) int8 tile on
    `pages_per_leaf` consecutive index pages."""

    num_leaves: int
    cap: int
    dp: int

    @property
    def pages_per_leaf(self) -> int:
        return scann_pages_per_leaf(self.cap, self.dp)

    @property
    def num_pages(self) -> int:
        return self.num_leaves * self.pages_per_leaf

    def pages_for_leaves(self, leaves: np.ndarray) -> np.ndarray:
        """Page ids touched opening `leaves`, in open order."""
        leaves = np.asarray(leaves, np.int64)
        ppl = self.pages_per_leaf
        return (leaves[:, None] * ppl + np.arange(ppl)).reshape(-1)


@dataclasses.dataclass(frozen=True)
class GraphAdjacencyLayout:
    """HNSW element tuples on index pages, `nodes_per_page` per 8 KB page;
    one node touch is one logical index-page access."""

    n: int
    degree: int                    # level-0 neighbor count (2M)

    @property
    def entry_bytes(self) -> int:
        # neighbor ids (int32) + a tuple header
        return self.degree * 4 + 64

    @property
    def nodes_per_page(self) -> int:
        return max(1, PAGE_BYTES // self.entry_bytes)

    @property
    def num_pages(self) -> int:
        return -(-self.n // self.nodes_per_page)

    def pages_for_nodes(self, nodes: np.ndarray) -> np.ndarray:
        """Page ids of `nodes`' adjacency entries, one per node touch."""
        return np.asarray(nodes, np.int64) // self.nodes_per_page
