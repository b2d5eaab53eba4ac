"""Core filter-agnostic FVS library of the port."""
from repro_torch.core.types import (METRIC_COS, METRIC_IP, METRIC_L2,
                                    AnytimeInfo, SearchParams, SearchResult,
                                    SearchStats, VectorStore, bitmap_andnot,
                                    bitmap_popcount, bitset_mark,
                                    bitset_words, bitset_zeros, distance,
                                    heap_pages_per_vector, merge_topk,
                                    pack_bitmap, pack_bool_bitmap,
                                    probe_batch, probe_bitmap,
                                    quant_heap_pages_per_vector,
                                    recall_at_k, resolve_device,
                                    sq8_quantize, to_device,
                                    topk_smallest, unpack_bitmap,
                                    words_from_uint32,
                                    words_to_uint32)
from repro_torch.core.workload import (CORRELATIONS, WorkloadSpec,
                                       full_distances,
                                       generate_bitmaps,
                                       generate_passing_rows)
from repro_torch.core.bruteforce import (filtered_knn, filtered_knn_partial,
                                         knn)
from repro_torch.core.hnsw import HNSWGraph, build_graph, build_graph_blocked
from repro_torch.core.graph_search import search_batch
from repro_torch.core.scann import (ScannIndex, build_scann,
                                    leaves_within_budget, scann_search_batch)
from repro_torch.core.costmodel import (LIBRARY, SYSTEM, CostConstants,
                                        budget_cycle_weights,
                                        component_cycles, cycle_breakdown,
                                        evaluate_anytime, linear_cycles,
                                        stats_table_row)
from repro_torch.core.executor import (PORTED_METHODS, BruteForceExecutor,
                                       Executor, GraphExecutor,
                                       ScannExecutor, SearchPlan,
                                       make_executor)

__all__ = [
    "METRIC_COS", "METRIC_IP", "METRIC_L2", "AnytimeInfo", "SearchParams",
    "SearchResult", "SearchStats", "VectorStore", "bitmap_andnot",
    "bitmap_popcount", "bitset_mark", "bitset_words", "bitset_zeros",
    "distance", "heap_pages_per_vector", "merge_topk", "pack_bitmap",
    "pack_bool_bitmap", "probe_batch", "probe_bitmap",
    "quant_heap_pages_per_vector", "recall_at_k", "resolve_device",
    "check_store_device", "sq8_quantize", "to_device", "topk_smallest",
    "unpack_bitmap", "words_from_uint32", "words_to_uint32", "CORRELATIONS",
    "WorkloadSpec", "full_distances", "generate_bitmaps",
    "generate_passing_rows", "filtered_knn", "filtered_knn_partial", "knn",
    "HNSWGraph", "build_graph", "build_graph_blocked", "search_batch",
    "ScannIndex", "build_scann", "leaves_within_budget", "scann_search_batch",
    "LIBRARY", "SYSTEM", "CostConstants", "budget_cycle_weights",
    "component_cycles", "cycle_breakdown", "evaluate_anytime",
    "linear_cycles", "stats_table_row", "PORTED_METHODS",
    "BruteForceExecutor", "Executor", "GraphExecutor", "ScannExecutor",
    "SearchPlan", "make_executor",
]
