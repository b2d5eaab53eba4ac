"""Page geometry: how many 8 KB pages one object touch costs.

The counters of the paper's Table 6 charge pages per object: a
full-precision heap row, an SQ8 shadow row, a ScaNN leaf tile.  These
formulas are the whole of the storage layer that the search path needs;
the buffer pool and its layouts are a later slice of the port.

Pure numpy-free integer arithmetic; nothing here touches a device.
"""
from __future__ import annotations

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
