"""Paged storage engine of the port: page layouts, the buffer pool, fault
injection and per-batch accounting of the search traces; the mutable
index's delta tier, tombstones and write-ahead log."""
from repro_torch.storage.pages import (HEAP_PAGE_BYTES, PAGE_BYTES,
                                       GraphAdjacencyLayout, HeapLayout,
                                       ScannLeafLayout, heap_pages_per_vector,
                                       quant_heap_pages_per_vector,
                                       scann_pages_per_leaf)
from repro_torch.storage.bufferpool import (POLICIES, BufferPool,
                                            BufferPoolState, PoolCounters)
from repro_torch.storage.faults import FaultInjector, FaultPlan
from repro_torch.storage.engine import (SEGMENTS, TRACE_UNTOUCHED,
                                        StorageEngine, StorageStats,
                                        make_storage_engine,
                                        merge_storage_stats,
                                        ordered_touches)
from repro_torch.storage.delta import DeltaFull, DeltaTier, Tombstones
from repro_torch.storage.wal import (REC_CHECKPOINT, REC_COMPACT,
                                     REC_DELETE, REC_INSERT, WalCorruption,
                                     WalRecord, WalSyncError, WalTornWrite,
                                     WriteAheadLog, crc32c, iter_records)

__all__ = ["HEAP_PAGE_BYTES", "PAGE_BYTES", "GraphAdjacencyLayout",
           "HeapLayout", "ScannLeafLayout", "heap_pages_per_vector",
           "quant_heap_pages_per_vector", "scann_pages_per_leaf",
           "POLICIES", "BufferPool", "BufferPoolState", "PoolCounters",
           "FaultInjector", "FaultPlan", "SEGMENTS", "TRACE_UNTOUCHED",
           "StorageEngine", "StorageStats", "make_storage_engine",
           "merge_storage_stats", "ordered_touches",
           "DeltaFull", "DeltaTier", "Tombstones",
           "REC_CHECKPOINT", "REC_COMPACT", "REC_DELETE", "REC_INSERT",
           "WalCorruption", "WalRecord", "WalSyncError", "WalTornWrite",
           "WriteAheadLog", "crc32c", "iter_records"]
