"""Storage geometry of the port (page counts per object touch)."""
from repro_torch.storage.pages import (HEAP_PAGE_BYTES, PAGE_BYTES,
                                       heap_pages_per_vector,
                                       quant_heap_pages_per_vector,
                                       scann_pages_per_leaf)

__all__ = ["HEAP_PAGE_BYTES", "PAGE_BYTES", "heap_pages_per_vector",
           "quant_heap_pages_per_vector", "scann_pages_per_leaf"]
