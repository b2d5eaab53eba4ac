#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card and
check it, end to end.

    python3 chip_smoke.py                 # the full run, one card
    python3 chip_smoke.py --n 100000 --queries 200 --phases main,kernels
    python3 chip_smoke.py --phases lm --lm-frames 2048   # model serving
    python3 chip_smoke.py --phases main,serve            # the serving path

Phases:
  device    the card's name and power limit; the kernels' build time
  parity    a 20,000 x 128 clustered store, indexes, SQ8 shadow, families,
            exclusion radii and partitions built once on the card; every
            method runs on CPU tensors (the plain versions) and on CUDA
            tensors (the kernels): recall@10 within 0.01, the mean of each of
            the seven Table-6 counters within 1 %, the same planner choice;
            the legacy engines too, and with a storage engine attached on
            each side, equal StorageStats; the ScaNN index is built twice
            on the card and must be the same bytes; then a cos store of
            the same shape with its graph and SQ8 shadow: the graph
            methods on the card and the CPU (the frontier scans have no cos
            kernel, so the card runs their plain versions and counts no
            launch, as the reference runs its oracle)
  main      the main path at full size: a SIFT1M-shaped store (1M x 128,
            1,000 queries), build_graph_blocked and build_scann on the card,
            two workloads, the quickstart's six methods; then the second
            slice's path: quantize_store, a 4-family workload (selectivity
            0.02) with its exclusion radii and partitioned graphs built on
            the card, the *_sq8, *_excl and partitioned methods and the
            adaptive planner on both menus, all through
            make_executor(...).search; then the third slice's path: the paged
            storage engine (LRU pool of half the pages) behind the
            executors, each method cold and then warm, and the legacy
            engines (scann_vmapped through the leaf_scan kernel, the vmapped
            graph engine) beside the batched ones.  Kernel launch counts are
            reset just before each of the three paths and read just after.
            Then the paper step (no kernel): Table 2's row (LID, LRC, the
            distance-versus-filter cost), the modeled QPS of every search
            on A and B, the measured miss penalty of every storage run and
            the 9 x 5 workload grid, every cell's bitmaps holding
            max(1, round(sel * n)) rows each
  serve     (after main, on its store, SQ8 shadow, graph, index and
            workload A; kernel launches counted from 0) the stepped
            frontier driver against main's one-shot searches bit for bit
            (five strategies, chunks of 8; per-lane deadlines against the
            static one); 1,000 requests at t=0 through serve_queue(fifo, 64)
            and ContinuousServer(64, 8) in both modes, bit-equal, with wall,
            QPS, ticks, slot utilization and the queries a frontier launch
            serves; benchmarks/bench_serving.py's open-loop trace (1,000
            requests at 0.7 x capacity) in both modes: p50 / p99 ticks,
            goodput; the degradation ladder under tests/test_robustness.py's
            fault plan, served twice, deterministic, every serving rung's
            kernels launched (128 requests: the Python pool replay);
            deadline admission (a 0.4 x floor request
            rejected) and the dispatch shapes over many deadline buckets;
            retrieval-augmented generation with granite-8b's smoke LM and
            the adaptive planner over the 1M store
  kernels   each kernel against its plain version on the card at the main
            path's shapes, with its device time (torch.profiler), the plain
            version's, one PyTorch library call's, the least time the card
            could take, and the time per call with the host's work (CUDA
            events around back-to-back calls); leaf_scan on the main
            path's (Q, nl) opened-leaf block with its group sizes, bit-equal
            from run to run and under a permutation of the queries; the
            exclusion pair's keep
            exactly the rule on its own distances, and no padded id kept
            at margin 0 (0 * inf is NaN); flash_attention at the
            encoder's shape, (2, 8192, 16, 80) bf16, through the tensor-core
            route under a relative-L2 limit that two broken kernels (the
            last 128 keys cut, the scale dropped) must fail, with SDPA as
            the library call; a causal and a GQA bf16 case, and an f32 case
            through the FP32 FMA template
  lm        model serving at full width, after the search path's data is
            freed: smoke-size models on the CPU and the card (the hubert
            prefill through the kernel, granite-8b and gemma3-12b greedy
            tokens); hubert-xlarge's prefill of 2 x 8,192 frames with every
            layer through the flash kernel (48 launches a prefill, all on
            the tensor-core route, held against the same prefill through
            the plain version and the jnp-path prefill); granite-8b's
            ServeEngine, 4 prompts x 128 tokens + 32 greedy (no flash
            launch).  The kernel's launches on this path fill its `kernels`
            row
  profile   (only when named in --phases) one search per method under
            torch.profiler: the device's busy share and its top kernels

The line before the last is the `kernels` JSON record; the last line is
`{"ok": true, "device": {...}}`.  Any failed check ends the run with a
non-zero exit and no result.  Without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.measure import (cuda_ms, device_ms,  # noqa: E402
                                 device_us_by_name, rel_l2)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, FP32 outside
# the tensor cores, and bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

METHODS = ("sweeping", "acorn", "navix", "iterative_scan", "scann",
           "bruteforce")
GRAPH_METHODS = METHODS[:4]
SQ8_METHODS = tuple(f"{m}_sq8" for m in GRAPH_METHODS)
# the legacy graph engine's methods (graph_exec_mode="vmapped")
VMAPPED_METHODS = ("sweeping", "acorn", "navix", "iterative_scan",
                   "sweeping_sq8")
# the kernels of a search path; `topk` is the reference's
# kernels.ops.topk_smallest, which no search path calls
PATH_KERNELS = ("frontier_scan", "distance_matrix", "leaf_scan_batched",
                "frontier_scan_sq8", "frontier_scan_excl",
                "frontier_scan_excl_sq8", "leaf_scan")
# the family workload of benchmarks/bench_filtercost.py: 4 clustered
# predicate families at selectivity 0.02, exclusion margin 0.3
FAMILY_SEL, NUM_FAMILIES, EXCL_MARGIN = 0.02, 4, 0.3
PARITY_FAMILY_SEL = 0.05
# the planner's 8-candidate menu (benchmarks/fig_planner.py's MENU)
MENU8 = ("bruteforce", "scann", "sweeping", "sweeping_sq8", "navix",
         "iterative_scan", "sweeping_excl", "partitioned")
COUNTERS = ("distance_comps", "filter_checks", "hops", "page_accesses_index",
            "page_accesses_heap", "tmap_lookups", "reorder_rows")

PARITY_N, PARITY_QUERIES = 20_000, 200

# kernel-vs-plain tolerance on finite distances: both sum ~128 float32
# products in different orders; ||q||^2 + ||x||^2 is a few units here, so a
# few ulp of it is ~1e-6 and 1e-4 leaves ample room without hiding a bug
# (a wrong row or term is off by O(0.1))
RTOL, ATOL = 1e-5, 1e-4

# flash attention, kernel vs plain.  The FP32 FMA route: f32 within
# (1e-5, 1e-5) (sums in another order).  The tensor-core route rounds each
# probability to bf16 before P.V (at most 2^-8 relative, ~1.6e-3 rms); the
# output, an average over the keys, moves by about that much, and rounding
# both outputs to bf16 (ulp ~5.6e-3 relative) makes it one-ulp flips, ~2.7e-3
# relative L2 in all (tests/test_torch_cuda.py measured 1.8e-3 to 2.5e-3).
# Limit 1e-2 over the output and 5e-2 over each (position, head) row: a
# kernel missing the last 128 of 8192 keys reads ~0.1, one without the
# 1/sqrt(hd) scale O(1); both controls run beside the kernel
FLASH_F32_TOL = (1e-5, 1e-5)
FLASH_WGMMA_REL_L2, FLASH_WGMMA_ROW_REL_L2 = 1e-2, 5e-2


# the keys of each kernel's record in the `kernels` JSON line
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def sync(dev="cuda"):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def bound(nbytes: float, flops: float, peak_ops: float = PEAK_FP32_PER_S
          ) -> tuple[float, str]:
    """Least time (ms) on an H100 SXM for this work, and what sets it:
    `peak_ops` is the card's peak rate for the inputs' type."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak_ops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def main_params():
    from repro_torch.core import SearchParams
    return SearchParams(k=10, ef_search=96, beam_width=512, max_hops=2048,
                        num_leaves_to_search=40, reorder_factor=4,
                        scann_query_block=64, exclusion_margin=EXCL_MARGIN)


def counter_means(res) -> dict[str, float]:
    from repro_torch.core import stats_table_row
    return stats_table_row(res.stats)


# ---------------------------------------------------------------------------
# parity: the same inputs through the plain versions (CPU) and the kernels
# ---------------------------------------------------------------------------

def phase_parity(n: int, nq: int, report: dict, dev="cuda") -> None:
    import torch
    from repro_torch.core import (WorkloadSpec, assign_family_bitmaps,
                                  build_exclusion, build_graph_blocked,
                                  build_graph_partitioned, build_scann,
                                  filtered_knn, generate_bitmaps,
                                  generate_families, make_executor,
                                  quantize_store, recall_at_k, to_device)
    from repro_torch.data import DatasetSpec, make_dataset
    from repro_torch.storage import make_storage_engine

    print(f"== parity: {n} x 128 store, {nq} queries, CPU vs card ==",
          flush=True)
    t0 = time.perf_counter()
    store, queries = make_dataset(DatasetSpec("parity", n, 128, "l2",
                                              clusters=128),
                                  num_queries=nq, seed=1, device=dev)
    graph = build_graph_blocked(store, m=16, ef_construction=32, seed=0,
                                device=dev)
    scann = build_scann(store, num_leaves=round(2 * math.sqrt(n)), levels=2,
                        seed=0, device=dev)
    # the card's k-means is deterministic: a second build is the same index
    again = build_scann(store, num_leaves=round(2 * math.sqrt(n)), levels=2,
                        seed=0, device=dev)
    same = {f: bool(torch.equal(getattr(scann, f), getattr(again, f)))
            for f in ("leaf_rowids", "leaf_centroids", "leaf_tiles",
                      "branch_centroids", "branch_leaves")}
    print(f"   scann built twice on the {dev}: byte-identical {same}",
          flush=True)
    check(all(same.values()), f"parity: two ScaNN builds differ: {same}")
    del again
    bitmaps = generate_bitmaps(store, queries, WorkloadSpec(0.10, "med_pos"),
                               seed=2, device=dev)
    # the second slice's artifacts, built once on the card and copied
    qstore = quantize_store(store)
    cpu_q = quantize_store(to_device(store, "cpu"))
    for f in ("q_vectors", "q_scale", "q_mean"):
        check(bool(torch.equal(getattr(qstore, f).cpu(), getattr(cpu_q, f))),
              f"parity quantize_store: {f} differs between card and CPU")
    fams = generate_families(store, PARITY_FAMILY_SEL,
                             num_families=NUM_FAMILIES, seed=0, device=dev)
    fbm, _ = assign_family_bitmaps(fams, nq, seed=1)
    excl = build_exclusion(store, families=fams, device=dev)
    parts = build_graph_partitioned(qstore, fams, m=16, ef_construction=32,
                                    seed=0, device=dev)
    sides = {
        "card": (qstore, graph, scann, queries, excl, parts),
        "cpu": (to_device(qstore, "cpu"), to_device(graph, "cpu"),
                to_device(scann, "cpu"), queries.cpu(),
                to_device(excl, "cpu"), parts.to("cpu")),
    }
    workloads = {"A": (bitmaps, filtered_knn(to_device(store, "cpu"),
                                             queries.cpu(), bitmaps.cpu(),
                                             10)[1]),
                 "F": (fbm, filtered_knn(to_device(store, "cpu"),
                                         queries.cpu(), fbm.cpu(), 10)[1])}
    print(f"   setup {time.perf_counter() - t0:.1f} s", flush=True)
    p = main_params()
    vm = dataclasses.replace(p, graph_exec_mode="vmapped")
    pq = dataclasses.replace(p, scann_page_accounting="per_query")
    # (label, method, workload, planner menu, params, with storage)
    cases = [(m, m, "A", None, p, False) for m in METHODS + SQ8_METHODS] + [
        (m, m, "F", None, p, False) for m in (
            "sweeping_excl", "sweeping_excl_sq8", "partitioned",
            "partitioned_sq8")] + [
        ("adaptive", "adaptive", "A", None, p, False),
        ("adaptive[menu8]", "adaptive", "F", MENU8, p, False),
        ("scann_vmapped", "scann_vmapped", "A", None, p, False)] + [
        (f"{m}[vmapped]", m, "A", None, vm, False) for m in VMAPPED_METHODS
    ] + [(f"{m}[storage]", m, "A", None, p, True) for m in (
        "sweeping", "sweeping_sq8", "iterative_scan", "bruteforce",
        "scann", "adaptive")] + [
        ("scann[storage,per_query]", "scann", "A", None, pq, True),
        ("partitioned[storage]", "partitioned", "F", None, p, True)]
    rows = {"scann_rebuild_identical": same}
    for label, method, wl, menu, pp, with_storage in cases:
        bm_card, truth = workloads[wl]
        kw = {} if menu is None else {"planner_candidates": menu}
        got = {}
        for side, (st, g, sc, q, ex, pg) in sides.items():
            bm = bm_card if side == "card" else bm_card.cpu()
            if with_storage:
                kw["storage"] = make_storage_engine(st, sc, g,
                                                    capacity_frac=0.5)
            t0 = time.perf_counter()
            res = make_executor(method, st, graph=g, index=sc, exclusion=ex,
                                partitions=pg, device=st.device,
                                **kw).search(q, bm, pp)
            sync(st.device)
            got[side] = (res, float(recall_at_k(res.ids.cpu(), truth,
                                                10).mean()),
                         counter_means(res), time.perf_counter() - t0)
        (rcpu, rc, cc, tc), (rcard, rg, cg, tg) = got["cpu"], got["card"]
        sc_, sg = rcpu.plan.strategy, rcard.plan.strategy
        worst = max(abs(cg[k] - cc[k]) / max(abs(cc[k]), 1e-9)
                    if cc[k] or cg[k] else 0.0 for k in COUNTERS)
        # exact agreement is reported beside the tolerances checked
        ids_diff = int((rcard.ids.cpu() != rcpu.ids).sum())
        dists_diff = int((rcard.dists.cpu() != rcpu.dists).sum())
        stats_diff = sum(int((getattr(rcard.stats, k).cpu()
                              != getattr(rcpu.stats, k)).sum())
                         for k in COUNTERS)
        print(f"   {label:26s} {wl} recall cpu {rc:.4f} card {rg:.4f} | "
              f"worst counter drift {worst:.5f} | differing ids {ids_diff} "
              f"dists {dists_diff} counters {stats_diff} | plan {sg} | cpu "
              f"{tc:.1f} s card {tg:.2f} s", flush=True)
        row = {"recall_cpu": rc, "recall_card": rg, "counters_cpu": cc,
               "counters_card": cg, "worst_counter_drift": worst,
               "ids_differing": ids_diff, "dists_differing": dists_diff,
               "counters_differing": stats_diff,
               "plan_cpu": sc_, "plan_card": sg}
        if with_storage:
            a, b = rcpu.storage.as_dict(), rcard.storage.as_dict()
            row["storage_equal"] = a == b
            row["storage_card"] = {k: b[k] for k in (
                "logical", "hits", "misses", "evictions", "unique")}
            print(f"   {'':26s} StorageStats equal: {a == b}; card "
                  f"{row['storage_card']}", flush=True)
            check(a == b, f"parity {label}: StorageStats differ")
        rows[f"{label}/{wl}"] = row
        check(abs(rc - rg) <= 0.01, f"parity {label}: recall {rc} vs {rg}")
        check(worst <= 0.01, f"parity {label}: counters drift {worst}")
        check(sc_ == sg, f"parity {label}: planner chose {sg} on the card, "
              f"{sc_} on the CPU")
    report["parity"] = rows
    cos_graph_parity(n, nq, report, dev)


def cos_graph_parity(n: int, nq: int, report: dict, dev="cuda") -> None:
    """A cos store's graph search on the card and the CPU: recall@10
    within 0.01 and each counter's mean within 1 %, as the parity rows; no
    kernel launch on the card (cos routes to the plain frontier scans)."""
    from repro_torch.core import (WorkloadSpec, build_graph_blocked,
                                  filtered_knn, generate_bitmaps,
                                  make_executor, quantize_store, recall_at_k,
                                  to_device)
    from repro_torch.data import DatasetSpec, make_dataset
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    store, queries = make_dataset(DatasetSpec("parity_cos", n, 128, "cos",
                                              clusters=128),
                                  num_queries=nq, seed=3, device=dev)
    store = quantize_store(store)
    graph = build_graph_blocked(store, m=16, ef_construction=32, seed=0,
                                device=dev)
    bm = generate_bitmaps(store, queries, WorkloadSpec(0.10, "med_pos"),
                          seed=4, device=dev)
    cpu = (to_device(store, "cpu"), to_device(graph, "cpu"))
    truth = filtered_knn(cpu[0], queries.cpu(), bm.cpu(), 10)[1]
    print(f"== parity, cos: {n} x 128 store, {nq} queries, setup "
          f"{time.perf_counter() - t0:.1f} s ==", flush=True)
    p = main_params()
    rows = {}
    for method in GRAPH_METHODS + ("sweeping_sq8",):
        ops.reset_launches()
        t0 = time.perf_counter()
        card = make_executor(method, store, graph=graph,
                             device=dev).search(queries, bm, p)
        sync(dev)
        tg = time.perf_counter() - t0
        launched = {k: v for k, v in ops.launches().items() if v}
        t0 = time.perf_counter()
        host = make_executor(method, cpu[0], graph=cpu[1],
                             device="cpu").search(queries.cpu(), bm.cpu(), p)
        tc = time.perf_counter() - t0
        rg = float(recall_at_k(card.ids.cpu(), truth, 10).mean())
        rc = float(recall_at_k(host.ids, truth, 10).mean())
        cg, cc = counter_means(card), counter_means(host)
        worst = max(abs(cg[k] - cc[k]) / max(abs(cc[k]), 1e-9)
                    if cc[k] or cg[k] else 0.0 for k in COUNTERS)
        ids_diff = int((card.ids.cpu() != host.ids).sum())
        print(f"   {method + '[cos]':26s} recall cpu {rc:.4f} card {rg:.4f} "
              f"| worst counter drift {worst:.5f} | differing ids "
              f"{ids_diff} | launches {launched} | cpu {tc:.1f} s card "
              f"{tg:.2f} s", flush=True)
        rows[method] = {"recall_cpu": rc, "recall_card": rg,
                        "worst_counter_drift": worst,
                        "ids_differing": ids_diff, "launches": launched}
        check(abs(rc - rg) <= 0.01, f"parity cos {method}: recall {rc} vs "
              f"{rg}")
        check(worst <= 0.01, f"parity cos {method}: counters drift {worst}")
        if dev == "cuda":
            check(not launched, f"parity cos {method}: kernels launched "
                  f"{launched}")
    report["parity_cos"] = rows


# ---------------------------------------------------------------------------
# main path at full size
# ---------------------------------------------------------------------------

def _search_row(ex, method: str, label: str, queries, bm, truth, p,
                dev, results: list, kept: dict | None = None) -> dict:
    """One search through an executor, timed and checked; prints and
    appends its row (recall, the seven counters, Mcycles, wall, QPS and the
    kernel launches it caused).  `kept` receives the SearchResult under
    (label, method)."""
    import torch
    from repro_torch.core import (SYSTEM, cycle_breakdown, modeled_qps,
                                  recall_at_k)
    from repro_torch.kernels import ops
    before = ops.launches()
    sync(dev)
    t0 = time.perf_counter()
    res = ex.search(queries, bm, p)
    sync(dev)
    wall = time.perf_counter() - t0
    after = ops.launches()
    delta = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    rec = float(recall_at_k(res.ids, truth, p.k).mean())
    row = counter_means(res)
    quant = res.plan.params.graph_quant
    cyc = cycle_breakdown(res.stats, ex.store.dim, SYSTEM,
                          graph_quant=quant)["total"] / 1e6
    nq = queries.shape[0]
    ids = res.ids
    check(tuple(ids.shape) == (nq, p.k), f"{method}: ids shape")
    check(bool(torch.isfinite(res.dists[ids >= 0]).all()),
          f"{method}: non-finite distance for a returned id")
    plan = res.plan.strategy
    print(f"   {label:14s} {method:18s} recall {rec:.4f} "
          f"dc {row['distance_comps']:.1f} fc {row['filter_checks']:.1f} "
          f"hops {row['hops']:.1f} pai {row['page_accesses_index']:.1f} "
          f"pah {row['page_accesses_heap']:.1f} tm {row['tmap_lookups']:.1f}"
          f" rr {row['reorder_rows']:.1f} Mcycles {cyc:.4f} wall {wall:.3f}"
          f" s QPS {nq / wall:.1f} launches {delta}"
          + (f" | chose {plan} predicted Mcycles "
             + str({k: round(v / 1e6, 4)
                    for k, v in res.plan.predicted_cycles.items()})
             if res.plan.predicted_cycles else ""), flush=True)
    out = {"workload": label, "method": method, "recall": rec,
           "counters": row, "mcycles": cyc, "wall_s": wall,
           "qps": nq / wall, "launches": delta, "plan": plan,
           "modeled_qps": modeled_qps(res.stats, ex.store.dim, SYSTEM)}
    if res.plan.predicted_cycles:
        out["predicted_cycles"] = dict(res.plan.predicted_cycles)
    results.append(out)
    if kept is not None:
        kept[(label, method)] = res
    return out


def phase_main(n: int, nq: int, report: dict, dev="cuda") -> dict:
    import torch
    from repro_torch.core import (WorkloadSpec, build_graph_blocked,
                                  build_scann, filtered_knn,
                                  generate_bitmaps, make_executor)
    from repro_torch.data import DatasetSpec, make_dataset
    from repro_torch.kernels import ops

    print(f"== main path: SIFT1M-shaped {n} x 128, {nq} queries ==",
          flush=True)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store, queries = make_dataset(DatasetSpec("sift1m", n, 128, "l2",
                                              clusters=128),
                                  num_queries=nq, seed=0, device=dev)
    sync(dev)
    builds = {"dataset_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    graph = build_graph_blocked(store, m=16, ef_construction=32, seed=0,
                                device=dev)
    sync(dev)
    builds["graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scann = build_scann(store, num_leaves=2000, levels=2, seed=0,
                        device=dev)
    sync(dev)
    builds["scann_s"] = time.perf_counter() - t0
    sizes = {
        "store_bytes": store.vectors.numel() * 4 + store.n * 4,
        "graph_bytes": graph.neighbors.numel() * 4,
        "leaf_tiles_bytes": scann.leaf_tiles.numel(),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()
        if dev == "cuda" else 0,
    }
    print(f"   builds: dataset {builds['dataset_s']:.1f} s, graph "
          f"{builds['graph_s']:.1f} s ({graph.num_levels} levels), scann "
          f"{builds['scann_s']:.1f} s (2000 leaves, capacity "
          f"{scann.leaf_tiles.shape[1]})", flush=True)
    print(f"   device memory: store {sizes['store_bytes'] / 2**30:.3f} GiB, "
          f"graph {sizes['graph_bytes'] / 2**30:.3f} GiB, leaf tiles "
          f"{sizes['leaf_tiles_bytes'] / 2**30:.3f} GiB, peak allocated "
          f"{sizes['max_memory_allocated_bytes'] / 2**30:.3f} GiB",
          flush=True)

    p = main_params()
    workloads = (WorkloadSpec(0.10, "med_pos"), WorkloadSpec(0.01, "none"))
    inputs = []
    for i, ws in enumerate(workloads):
        t0 = time.perf_counter()
        bm = generate_bitmaps(store, queries, ws, seed=10 + i, device=dev)
        _, truth = filtered_knn(store, queries, bm, p.k)
        sync(dev)
        inputs.append((f"{ws.selectivity} {ws.correlation}", bm, truth))
        print(f"   workload sel={ws.selectivity} {ws.correlation}: bitmaps "
              f"+ ground truth {time.perf_counter() - t0:.1f} s", flush=True)

    # the first slice's path: the quickstart's six methods
    ops.reset_launches()
    results = []
    oneshot = {}
    for label, bm, truth in inputs:
        for method in METHODS:
            ex = make_executor(method, store, graph=graph, index=scann,
                               device=dev)
            r = _search_row(ex, method, label, queries, bm, truth, p, dev,
                            results, oneshot)
            if method in GRAPH_METHODS:
                check(r["launches"].get("frontier_scan", 0) > 0,
                      f"{method} never launched frontier_scan")
            if method == "scann":
                check(r["launches"].get("distance_matrix", 0) > 0
                      and r["launches"].get("leaf_scan_batched", 0) > 0,
                      "scann did not launch its kernels")
            if method == "bruteforce":
                check(r["recall"] == 1.0,
                      f"bruteforce recall {r['recall']} != 1.0")
    counts1 = ops.launches()
    print(f"   launches on the first slice's path: {counts1}", flush=True)
    for k in ("frontier_scan", "distance_matrix", "leaf_scan_batched"):
        check(counts1[k] > 0, f"kernel {k} was not launched on its path")
    report["main"] = {"n": n, "queries": nq, "builds": builds,
                      "sizes": sizes, "results": results,
                      "launches_slice1": counts1}
    ctx = {"store": store, "graph": graph, "scann": scann,
           "queries": queries, "bitmaps": inputs[0][1], "inputs": inputs,
           "oneshot": oneshot}
    counts2 = main_slice2(ctx, report, dev)
    counts3 = main_slice3(ctx, report, dev)
    counts = {k: counts1[k] + counts2[k] + counts3[k] for k in counts1}
    print(f"   launches on the main path: {counts}", flush=True)
    for k in PATH_KERNELS:
        check(counts[k] > 0, f"kernel {k} was not launched on the main path")
    report["main"]["launches"] = counts
    ctx["launches"] = counts
    family_witness(ctx, report, dev)
    paper_step(ctx, report, dev)
    return ctx


def main_slice2(ctx: dict, report: dict, dev="cuda") -> dict:
    """The second slice's path on the main path's store, graph and index:
    the SQ8 tier, the family workload with exclusion radii and partitioned
    graphs built on the card, and the adaptive planner.  Returns the kernel
    launches of this path alone."""
    import torch
    from repro_torch.core import (assign_family_bitmaps, build_exclusion,
                                  build_graph_partitioned, filtered_knn,
                                  generate_families, make_executor,
                                  quantize_store)
    from repro_torch.kernels import ops

    store, graph, scann = ctx["store"], ctx["graph"], ctx["scann"]
    queries, (wa, wb) = ctx["queries"], ctx["inputs"]
    nq, n = queries.shape[0], store.n
    p = main_params()
    builds = report["main"]["builds"]
    t0 = time.perf_counter()
    qstore = quantize_store(store)
    sync(dev)
    builds["quantize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fams = generate_families(store, FAMILY_SEL, num_families=NUM_FAMILIES,
                             seed=0, device=dev)
    fbm, _ = assign_family_bitmaps(fams, nq, seed=1)
    _, ftruth = filtered_knn(store, queries, fbm, p.k)
    sync(dev)
    builds["families_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    excl = build_exclusion(store, families=fams, device=dev)
    sync(dev)
    builds["exclusion_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = build_graph_partitioned(qstore, fams, m=16, ef_construction=64,
                                    seed=0, device=dev)
    sync(dev)
    builds["partitions_s"] = time.perf_counter() - t0
    part_rows = [int(pt.rows.numel()) for pt in parts.partitions]
    print(f"   second slice builds: quantize_store {builds['quantize_s']:.2f}"
          f" s, families + ground truth {builds['families_s']:.1f} s, "
          f"build_exclusion {builds['exclusion_s']:.1f} s (radius table "
          f"{tuple(excl.radii.shape)}), build_graph_partitioned "
          f"{builds['partitions_s']:.1f} s ({part_rows} rows)", flush=True)
    wf = (f"fam {FAMILY_SEL}", fbm, ftruth)
    kw = dict(graph=graph, index=scann, exclusion=excl, partitions=parts,
              device=dev)
    cases = [(m, w) for w in (wa, wb) for m in SQ8_METHODS]
    cases += [(m, wf) for m in ("sweeping", "sweeping_excl",
                                "sweeping_excl_sq8", "partitioned",
                                "partitioned_sq8")]
    cases += [("sweeping_excl", wb), ("adaptive", wa), ("adaptive", wb),
              ("adaptive[menu8]", wf)]
    resident = torch.cuda.memory_allocated() if dev == "cuda" else 0
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    results = report["main"]["results"]
    for method, (label, bm, truth) in cases:
        name, menu = (method[:-7], MENU8) if method.endswith("[menu8]") \
            else (method, None)
        ex = make_executor(name, qstore, **kw, **(
            {"planner_candidates": menu} if menu else {}))
        r = _search_row(ex, method, label, queries, bm, truth, p, dev,
                        results, ctx["oneshot"])
        if name.endswith("_sq8"):
            key = "frontier_scan_excl_sq8" if "excl" in name \
                else "frontier_scan_sq8"
            check(r["launches"].get(key, 0) > 0,
                  f"{method} never launched {key}")
        if name == "sweeping_excl":
            check(r["launches"].get("frontier_scan_excl", 0) > 0,
                  f"{method} never launched frontier_scan_excl")
    counts = ops.launches()
    print(f"   launches on the second slice's path: {counts}", flush=True)
    for k in ("frontier_scan", "frontier_scan_sq8", "frontier_scan_excl",
              "frontier_scan_excl_sq8"):
        check(counts[k] > 0, f"kernel {k} was not launched on its path")
    mem = {"resident_bytes": resident}
    if dev == "cuda":
        peak = torch.cuda.max_memory_allocated()
        mem.update(peak_bytes=peak, transient_bytes=peak - resident,
                   radius_table_bytes=excl.radii.numel() * 4,
                   q_by_n_f32_bytes=nq * n * 4)
        print(f"   device memory over the second slice's searches: resident "
              f"{resident / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB "
              f"(transient {(peak - resident) / 2**30:.3f} GiB; the radius "
              f"table is {excl.radii.numel() * 4 / 2**20:.1f} MiB, a (Q, n) "
              f"f32 radius block would be {nq * n * 4 / 2**30:.2f} GiB)",
              flush=True)
        check(peak - resident < nq * n * 4,
              "the searches allocated as much as a (Q, n) radius block")
    report["main"].update(launches_slice2=counts, memory_slice2=mem,
                          partition_rows=part_rows)
    ctx.update(qstore=qstore, excl=excl, parts=parts, family=wf)
    return counts


@contextlib.contextmanager
def _timed_accounting(engine, dev="cuda"):
    """Time the host side of a search with storage, summing seconds into
    the dict it yields: "account", the engine's accounting entry points
    whole; "order", the part of them that orders the traces on the card
    and copies the ordered id lists to the host (`ordered_touches`,
    `passing_rows`); "replay", the Python pool replay (`_replay`).  What
    is left of "account" builds the page streams from the ids."""
    from repro_torch.storage import engine as engine_mod

    spent = dict.fromkeys(("account", "order", "replay"), 0.0)

    def timer(fn, key):
        def timed(*a, **k):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[key] += time.perf_counter() - t0
            return out
        return timed

    patched = [(engine_mod, name, getattr(engine_mod, name))
               for name in ("ordered_touches", "passing_rows")]
    for mod, name, fn in patched:
        setattr(mod, name, timer(fn, "order"))
    for name in ("account_graph", "account_scann", "account_seqscan"):
        setattr(engine, name, timer(getattr(engine, name), "account"))
    engine._replay = timer(engine._replay, "replay")
    try:
        yield spent
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        for name in ("account_graph", "account_scann", "account_seqscan",
                     "_replay"):
            delattr(engine, name)


def _same_result(a, b) -> bool:
    import torch
    return bool(torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
                and all(torch.equal(getattr(a.stats, k), getattr(b.stats, k))
                        for k in COUNTERS))


def main_slice3(ctx: dict, report: dict, dev="cuda") -> dict:
    """The third slice's path on the main path's store and indexes: the
    paged storage engine behind the executors, then the legacy engines.
    Returns the kernel launches of this path alone."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    t0 = time.perf_counter()
    storage_path(ctx, report, dev)
    t_storage = time.perf_counter() - t0
    legacy_path(ctx, report, dev)
    counts = ops.launches()
    print(f"   launches on the third slice's path: {counts} (storage "
          f"{t_storage:.1f} s)", flush=True)
    check(counts["leaf_scan"] > 0, "kernel leaf_scan was not launched on "
          "its path")
    report["main"].update(launches_slice3=counts, storage_s=t_storage)
    return counts


def storage_path(ctx: dict, report: dict, dev="cuda") -> None:
    """Every method with the paged storage engine attached (LRU, half the
    pages), cold and then warm on the same batch: StorageStats per
    segment, the seconds of the search, of ordering the traces and of the
    pool replay, results equal to the same search without storage,
    measured pages against the counters."""
    from repro_torch.storage import make_storage_engine

    qstore, graph, scann = ctx["qstore"], ctx["graph"], ctx["scann"]
    queries, (wa, wb), wf = ctx["queries"], ctx["inputs"], ctx["family"]
    p = main_params()
    engine = make_storage_engine(qstore, scann, graph, capacity_frac=0.5,
                                 policy="lru")
    segs = {k: hi - lo for k, (lo, hi) in engine.segment_ranges().items()}
    print(f"   storage engine: {engine.total_pages} pages {segs}, LRU pool "
          f"of {engine.pool.capacity}", flush=True)
    pq = dataclasses.replace(p, scann_page_accounting="per_query")
    cases = [("sweeping", wa, p), ("sweeping_sq8", wa, p), ("navix", wa, p),
             ("iterative_scan", wa, p), ("scann[per_query]", wa, pq),
             ("scann[batch]", wa, p), ("bruteforce", wb, p),
             ("partitioned", wf, p), ("adaptive", wa, p)]
    kw = dict(graph=graph, index=scann, partitions=ctx["parts"], device=dev)
    rows = []
    kept = ctx.setdefault("storage_stats", [])
    with _timed_accounting(engine, dev) as spent:
        for case in cases:
            rows += _storage_case(engine, case, spent, qstore, queries, kw,
                                  p, dev, kept)
    report["main"]["storage"] = {"segments": segs,
                                 "capacity": engine.pool.capacity,
                                 "rows": rows}


def _storage_case(engine, case, spent, qstore, queries, kw, p, dev, kept):
    """One method with storage, cold and then warm: its two report rows;
    each run's (label, mode, StorageStats) goes onto `kept`.
    A row splits the wall into the search ("search_s"), the ordering of
    the traces on the card with the copy to the host ("order_s"), the
    page streams built from the ids ("streams_s") and the pool replay
    ("replay_s")."""
    import numpy as np
    from repro_torch.core import make_executor, recall_at_k

    label, (wl, bm, truth), pp = case
    method = label.split("[")[0]
    plain = make_executor(method, qstore, **kw).search(queries, bm, pp)
    ex = make_executor(method, qstore, storage=engine, **kw)
    engine.reset_cold()
    rows = []
    for mode in ("cold", "warm"):
        for key in spent:
            spent[key] = 0.0
        sync(dev)
        t0 = time.perf_counter()
        res = ex.search(queries, bm, pp)
        sync(dev)
        wall = time.perf_counter() - t0
        st = res.storage
        chosen = res.plan.strategy
        if method == "adaptive":
            # the planner prices the pool's residency: compare with the
            # chosen method's own search
            plain = make_executor(chosen, qstore, **kw).search(queries, bm,
                                                               pp)
            same = bool((plain.ids == res.ids).all()
                        and (plain.dists == res.dists).all())
        else:
            same = _same_result(plain, res)
        check(same, f"storage {label} {mode}: results differ from the "
              "search without storage")
        heap_a = res.stats.page_accesses_heap.cpu().numpy()
        idx_a = res.stats.page_accesses_index.cpu().numpy()
        if method in ("scann", "bruteforce"):
            check(np.array_equal(st.heap_pages, heap_a)
                  and (method == "bruteforce"
                       or np.array_equal(st.index_pages, idx_a)),
                  f"storage {label}: measured pages != analytic")
        elif method in ("sweeping", "sweeping_sq8", "navix",
                        "iterative_scan") or chosen in GRAPH_METHODS:
            check(bool((st.heap_pages <= heap_a).all()
                       and (st.index_pages <= idx_a).all()),
                  f"storage {label}: measured pages > analytic")
        kept.append((label, mode, st))
        per_seg = {seg: (st.logical[seg], st.hits[seg], st.misses[seg])
                   for seg in st.logical}
        row = {"method": label, "workload": wl, "mode": mode,
               "plan": chosen, "wall_s": wall,
               "search_s": wall - spent["account"],
               "order_s": spent["order"],
               "streams_s": spent["account"] - spent["order"]
               - spent["replay"],
               "replay_s": spent["replay"], "hit_rate": st.hit_rate,
               "unique_fraction": st.unique_fraction(),
               "evictions": st.evictions, "segments": per_seg,
               "logical_total": st.logical_total,
               "miss_total": st.miss_total,
               "measured_heap_pages": float(st.heap_pages.mean()),
               "analytic_heap_pages": float(heap_a.mean()),
               "measured_index_pages": float(st.index_pages.mean()),
               "analytic_index_pages": float(idx_a.mean()),
               "recall": float(recall_at_k(res.ids, truth, p.k).mean())}
        rows.append(row)
        print(f"   storage {label:17s} {mode} {wl:12s} "
              + (f"chose {chosen} " if method == "adaptive" else "")
              + f"hit rate {st.hit_rate:.4f} unique "
              f"{row['unique_fraction']:.4f} evictions {st.evictions} | "
              f"per segment (logical, hits, misses) {per_seg} | wall "
              f"{wall:.3f} s = search {row['search_s']:.3f} + order on the "
              f"card and copy {row['order_s']:.3f} + page streams "
              f"{row['streams_s']:.3f} + pool replay {row['replay_s']:.3f} s"
              f" ({st.logical_total} accesses)", flush=True)
    return rows


def legacy_path(ctx: dict, report: dict, dev="cuda") -> None:
    """The legacy engines beside the batched ones on workload A: ScaNN's
    per-query path (the leaf_scan kernel) against the batched pipeline
    with per-query page accounting, and the vmapped graph engine against
    the frontier engine: recall, differing ids and counters, QPS."""
    from repro_torch.core import make_executor, recall_at_k

    qstore, graph, scann = ctx["qstore"], ctx["graph"], ctx["scann"]
    queries = ctx["queries"]
    _, bm, truth = ctx["inputs"][0]
    nq = queries.shape[0]
    p = main_params()
    pairs = [("scann", dataclasses.replace(p, scann_page_accounting=
                                           "per_query"),
              "scann_vmapped", None)]
    pairs += [(m, p, m, dataclasses.replace(p, graph_exec_mode="vmapped"))
              for m in VMAPPED_METHODS]
    rows = []
    for base, pb, legacy, pl in pairs:
        out = {}
        for name, pp in ((base, pb), (legacy, pl or pb)):
            ex = make_executor(name, qstore, graph=graph, index=scann,
                               device=dev)
            sync(dev)
            t0 = time.perf_counter()
            res = ex.search(queries, bm, pp)
            sync(dev)
            out[name if pl is None else
                ("vmapped" if pp is pl else "frontier")] = (
                res, time.perf_counter() - t0)
        (a, ta), (b, tb) = out.values()
        ids_diff = int((a.ids != b.ids).sum())
        q_diff = {k: int((getattr(a.stats, k) != getattr(b.stats, k)).sum())
                  for k in COUNTERS}
        ra = float(recall_at_k(a.ids, truth, p.k).mean())
        rb = float(recall_at_k(b.ids, truth, p.k).mean())
        ma, mb = counter_means(a), counter_means(b)
        row = {"method": legacy if pl is None else f"{base}[vmapped]",
               "baseline": base if pl is None else f"{base}[frontier]",
               "recall": rb, "recall_baseline": ra,
               "ids_differing": ids_diff, "queries_differing": q_diff,
               "counters": mb, "counters_baseline": ma,
               "qps": nq / tb, "qps_baseline": nq / ta}
        rows.append(row)
        print(f"   legacy {row['method']:22s} recall {rb:.4f} (baseline "
              f"{ra:.4f}) | ids differing {ids_diff} of {a.ids.numel()} | "
              f"queries with a differing counter {q_diff} | QPS {nq / tb:.1f}"
              f" vs {row['baseline']} {nq / ta:.1f}", flush=True)
        check(abs(ra - rb) <= 0.02, f"legacy {row['method']}: recall {rb} "
              f"vs {ra}")
        for k in COUNTERS:
            check(abs(mb[k] - ma[k]) <= 0.02 * max(abs(ma[k]), 1.0),
                  f"legacy {row['method']}: {k} mean {mb[k]} vs {ma[k]}")
        if pl is None:
            check(q_diff["hops"] == 0 and q_diff["page_accesses_index"] == 0,
                  "scann_vmapped: leaves or leaf pages differ from the "
                  "batched pipeline's per-query accounting")
    report["main"]["legacy"] = rows


def family_witness(ctx: dict, report: dict, dev="cuda") -> None:
    """Why recall is low on the family workload, measured: where the
    queries lie against each family's ball (the rows nearest its centre
    row), `partitioned` at larger ef_search on the same queries (a sound
    subgraph approaches recall 1), and `partitioned` at the main ef on
    queries drawn inside the balls (midpoints of two rows of the query's
    family)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import (filtered_knn, full_distances,
                                  make_executor, recall_at_k, unpack_bitmap)

    store, queries, parts = ctx["qstore"], ctx["queries"], ctx["parts"]
    _, fbm, ftruth = ctx["family"]
    n, nq = store.n, queries.shape[0]
    p = main_params()
    # each partition's centre row: generate_families(seed=0) draws the
    # centres in family order, and the tag "fam{f}_s..." names f
    drawn = np.random.RandomState(0).choice(n, size=NUM_FAMILIES,
                                            replace=False)
    centres = torch.as_tensor([int(drawn[int(pt.tag[3:pt.tag.index("_")])])
                               for pt in parts.partitions], device=dev)
    member = unpack_bitmap(torch.stack([pt.bitmap
                                        for pt in parts.partitions]), n)
    fi = torch.arange(len(parts.partitions), device=dev)
    check(bool(member[fi, centres].all()),
          "witness: a centre row is not in its own family")
    dc = full_distances(store, store.vectors[centres])           # (F, n)
    radius = torch.where(member, dc, torch.zeros_like(dc)).amax(1).sqrt()
    fam_of_q = parts.match(fbm).long()
    check(bool((fam_of_q >= 0).all()), "witness: a query matched no family")
    q_to_c = (queries - store.vectors[centres[fam_of_q]]).pow(2).sum(1)
    ratio = q_to_c.sqrt() / radius[fam_of_q]
    outside = float((ratio > 1).float().mean())
    print(f"   witness F: family ball radii {radius.cpu().numpy().round(3)}; "
          f"query-to-centre / radius median {float(ratio.median()):.3f} "
          f"(min {float(ratio.min()):.3f}); {outside:.3f} of queries lie "
          f"outside their family's ball", flush=True)
    out = {"radius": radius.tolist(), "ratio_median": float(ratio.median()),
           "ratio_min": float(ratio.min()), "outside_share": outside,
           "ef_sweep": []}
    ex = make_executor("partitioned", store, partitions=parts, device=dev)
    for ef in (p.ef_search, 384, 1536):
        pe = dataclasses.replace(p, ef_search=ef,
                                 beam_width=max(ef, p.beam_width),
                                 max_hops=4096)
        t0 = time.perf_counter()
        res = ex.search(queries, fbm, pe)
        sync(dev)
        rec = float(recall_at_k(res.ids, ftruth, p.k).mean())
        hops = float(res.stats.hops.float().mean())
        print(f"   witness F: partitioned ef_search {ef} recall {rec:.4f} "
              f"hops {hops:.1f} wall {time.perf_counter() - t0:.2f} s",
              flush=True)
        out["ef_sweep"].append({"ef_search": ef, "recall": rec,
                                "hops": hops})
    check(out["ef_sweep"][-1]["recall"] >= out["ef_sweep"][0]["recall"],
          "witness: partitioned recall fell as ef_search rose")
    # queries inside the balls: midpoints of two random rows of the
    # query's family, with that family's bitmap
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    sizes = torch.as_tensor([pt.rows.numel() for pt in parts.partitions],
                            device=dev)
    offsets = torch.cumsum(sizes, 0) - sizes
    all_rows = torch.cat([pt.rows.long() for pt in parts.partitions])
    pick = (torch.rand((nq, 2), generator=gen, device=dev)
            * sizes[fam_of_q][:, None]).long() + offsets[fam_of_q][:, None]
    ends = store.vectors[all_rows[pick]]                        # (Q, 2, d)
    inside = 0.5 * (ends[:, 0] + ends[:, 1])
    _, itruth = filtered_knn(store, inside, fbm, p.k)
    res = ex.search(inside, fbm, p)
    sync(dev)
    rec_in = float(recall_at_k(res.ids, itruth, p.k).mean())
    print(f"   witness F: partitioned ef_search {p.ef_search} on {nq} "
          f"queries inside their family's ball: recall {rec_in:.4f}",
          flush=True)
    out["inside_recall"] = rec_in
    report["main"]["family_witness"] = out


def paper_step(ctx: dict, report: dict, dev="cuda") -> None:
    """The library half of the paper's tables on the main path's store and
    queries: Table 2's row (LID, LRC, the distance-versus-filter cost), the
    modeled QPS (SYSTEM, 16 threads) of every search on A and B, the
    measured miss penalty of every storage run, and the 9 x 5 workload grid
    with its seconds; every grid cell's bitmaps hold max(1, round(sel * n))
    rows each."""
    import torch
    from repro_torch.core import (SYSTEM, bitmap_popcount, generate_grid,
                                  measured_miss_penalty)
    from repro_torch.core.hardness import (dist_filter_relative_cost,
                                           lid_mle, lrc)

    store, queries = ctx["store"], ctx["queries"]
    nq = queries.shape[0]
    out = report["main"]["paper"] = {}
    secs = out["seconds"] = {}

    def timed(key, fn, *a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        v = fn(*a, **kw)
        sync(dev)
        secs[key] = time.perf_counter() - t0
        return v

    row = out["table2"] = {
        "n": store.n, "dim": store.dim,
        "lid": timed("lid", lid_mle, store, queries, device=dev),
        "lrc": timed("lrc", lrc, store, queries, device=dev),
        "dist_filter_rel_cost": timed("dist_filter_rel_cost",
                                      dist_filter_relative_cost, store.dim,
                                      device=dev)}
    print(f"   paper: Table 2 row n={store.n} d={store.dim}: LID "
          f"{row['lid']:.4f} ({secs['lid']:.2f} s), LRC {row['lrc']:.4f} "
          f"({secs['lrc']:.2f} s), dist-filter relative cost "
          f"{row['dist_filter_rel_cost']:.4f} "
          f"({secs['dist_filter_rel_cost']:.2f} s)", flush=True)
    check(math.isfinite(row["lid"]) and row["lid"] > 0,
          f"paper: LID {row['lid']}")
    check(0.0 <= row["lrc"] <= 1.0, f"paper: LRC {row['lrc']}")
    check(math.isfinite(row["dist_filter_rel_cost"])
          and row["dist_filter_rel_cost"] > 0,
          f"paper: dist-filter cost {row['dist_filter_rel_cost']}")

    labels = [label for label, _, _ in ctx["inputs"]]
    qps = out["modeled_qps"] = {}
    for r in report["main"]["results"]:
        if r["workload"] in labels:
            v = qps[f"{r['method']} {r['workload']}"] = r["modeled_qps"]
            check(math.isfinite(v) and v > 0,
                  f"paper: modeled QPS of {r['method']} on {r['workload']}"
                  f" is {v}")
    print("   paper: modeled QPS (SYSTEM, 16 threads) "
          + ", ".join(f"{k} {v:.1f}" for k, v in qps.items()), flush=True)

    pen = out["miss_penalty"] = {}
    for label, mode, st in ctx["storage_stats"]:
        v = pen[f"{label} {mode}"] = measured_miss_penalty(st, nq, SYSTEM)
        check(math.isfinite(v) and v >= 0,
              f"paper: miss penalty of {label} {mode} is {v}")
    print("   paper: measured miss penalty, cycles a query (SYSTEM) "
          + ", ".join(f"{k} {v:.1f}" for k, v in pen.items()), flush=True)

    grid = timed("grid", generate_grid, store, queries, device=dev)
    out["grid"] = {"queries": nq, "cells": len(grid)}
    check(len(grid) == 45, f"paper: the grid has {len(grid)} cells")
    for (sel, corr), bm in grid.items():
        pop = bitmap_popcount(bm)
        want = max(1, round(sel * store.n))
        check(tuple(bm.shape) == (nq, (store.n + 31) // 32)
              and bool((pop == want).all()),
              f"paper: grid cell ({sel}, {corr}) popcounts "
              f"{int(pop.min())}..{int(pop.max())}, want {want}")
    del grid
    if dev == "cuda":
        torch.cuda.empty_cache()
    print(f"   paper: generate_grid 9 x 5 cells on {nq} queries: "
          f"{secs['grid']:.2f} s, every row of every cell exact", flush=True)


# ---------------------------------------------------------------------------
# serve: the stepped frontier driver, continuous batching and the
# retrieval-augmented server on the main path's 1M store
# ---------------------------------------------------------------------------

# the slot pool: 64 lanes stepped 8 supersteps a tick
SERVE_WIDTH, SERVE_HOP_CHUNK = 64, 8
SERVE_STEPPED = ("sweeping", "acorn", "navix", "iterative_scan",
                 "sweeping_sq8")
# the open-loop mix of benchmarks/bench_serving.py: 80 % background
# requests at selectivity 0.5 (uncorrelated), 20 % in hot-topic bursts of
# 4 at selectivity 0.02 (positively correlated), Poisson arrivals (seed 7)
# at 0.7 x the pool's capacity, SLO 1.5 x the straggler's service ticks
STRAGGLER_FRAC, BURST_LEN, SEL_FAST, SEL_SLOW = 0.2, 4, 0.5, 0.02
TRACE_LOAD, TRACE_SEED, TRACE_REQUESTS = 0.7, 7, 1000
# tests/test_robustness.py's chaos plan, on a pool of a quarter of the
# pages.  128 requests, not 1,000: at 1M nearly every request faults down
# the ladder, ~0.3 s a request, 629 s for two runs of 1,000 on an H100
# (PERF.md, PR 20)
LADDER_FAULTS = dict(seed=13, read_fail_prob=0.12, max_retries=1,
                     latency_spike_prob=0.05)
LADDER_REQUESTS = 128
ADMISSION_REQUESTS = 256


@contextlib.contextmanager
def _expanded_lanes():
    """Count each base superstep and the lanes it expanded (the lanes whose
    candidates reach its frontier launch: the step of `hops`), kept on
    the card and summed once at the end."""
    from repro_torch.core import graph_search as G
    acc = {"supersteps": 0, "lanes": []}
    orig = G._base_superstep

    def counted(graph, store, queries, bitmaps, params, ef_result, s, *a,
                **kw):
        out = orig(graph, store, queries, bitmaps, params, ef_result, s,
                   *a, **kw)
        acc["supersteps"] += 1
        acc["lanes"].append((out.st.hops - s.st.hops).sum())
        return out

    G._base_superstep = counted
    try:
        yield acc
    finally:
        G._base_superstep = orig


def _lanes_per_step(acc) -> float:
    import torch
    if not acc["lanes"]:
        return 0.0
    return float(torch.stack(acc["lanes"]).sum()) / acc["supersteps"]


def _query_server(ex, p, queries):
    """A server whose prompt i embeds to query i (token row [i])."""
    import numpy as np
    from repro_torch.serving import RetrievalAugmentedServer
    return RetrievalAugmentedServer(
        None, None, ex, p, doc_tokens=np.zeros((ex.store.n, 1), np.int32),
        chunk_len=1, embed_fn=lambda pr, tok: queries[tok[:, 0]])


def _same_search(a, b) -> bool:
    """(dists, ids, stats) of two searches equal bit for bit."""
    import torch
    return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and all(torch.equal(getattr(a[2], k), getattr(b[2], k))
                        for k in COUNTERS))


def _stepped(graph, store, queries, bm, p, deadlines=None):
    from repro_torch.core import graph_search as G
    state = G.frontier_init(graph, store, queries, bm, p,
                            deadlines=deadlines)
    while not bool(state.done.all()):
        state = G.step_supersteps(graph, store, state, p, SERVE_HOP_CHUNK,
                                  dynamic_deadline=deadlines is not None)
    return G.frontier_finalize(graph, store, state, p)[:3]


def serve_stepped(ctx: dict, out: dict, dev="cuda") -> None:
    """frontier_init + step_supersteps(8) to done + frontier_finalize over
    workload A's 1,000 queries equals main's one-shot search bit for bit,
    for five strategies; a sweeping run with per-lane dynamic deadlines
    equals the static deadline_cycles."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.core import (linear_cycles, make_executor,
                                  search_batch)
    graph, queries = ctx["graph"], ctx["queries"]
    label, bm, _ = ctx["inputs"][0]
    p = main_params()
    rows = out["stepped"] = {}
    for method in SERVE_STEPPED:
        store = ctx["qstore"] if method.endswith("_sq8") else ctx["store"]
        ex = make_executor(method, store, graph=graph, device=dev)
        want = ctx["oneshot"][(label, method)]
        sync(dev)
        t0 = time.perf_counter()
        got = _stepped(graph, store, queries, bm, ex.resolve_params(p))
        sync(dev)
        wall = time.perf_counter() - t0
        same = _same_search(got, (want.dists, want.ids, want.stats))
        rows[method] = {"wall_s": wall, "one_shot_wall_s": next(
            r["wall_s"] for r in ctx["results"]
            if r["workload"] == label and r["method"] == method),
            "bit_equal": same}
        print(f"   serve: stepped {method:15s} A, {queries.shape[0]} "
              f"queries, chunks of {SERVE_HOP_CHUNK}: {wall:.3f} s (one-shot "
              f"{rows[method]['one_shot_wall_s']:.3f} s), ids, dists and "
              f"7 counters bit-equal: {same}", flush=True)
        check(same, f"serve: stepped {method} differs from the one-shot "
              "search")
    ex = make_executor("sweeping", ctx["store"], graph=graph, device=dev)
    rp = ex.resolve_params(p)
    cyc = linear_cycles(ctx["oneshot"][(label, "sweeping")].stats,
                        ctx["store"].dim)
    dl = float(np.float32(np.median(cyc)))
    want = search_batch(graph, ctx["store"], queries, bm,
                        dc.replace(rp, deadline_cycles=dl))
    got = _stepped(graph, ctx["store"], queries, bm, rp,
                   deadlines=np.full(queries.shape[0], dl, np.float32))
    stopped = int((linear_cycles(want[2], ctx["store"].dim) >= dl).sum())
    same = _same_search(got, want)
    rows["sweeping_dynamic_deadline"] = {"deadline_cycles": dl,
                                         "lanes_at_deadline": stopped,
                                         "bit_equal": same}
    print(f"   serve: stepped sweeping with per-lane deadlines {dl:.1f} "
          f"cycles ({stopped} of {queries.shape[0]} lanes reach it) equals "
          f"the static deadline_cycles: {same}", flush=True)
    check(same and 0 < stopped < queries.shape[0],
          "serve: dynamic deadlines differ from the static deadline")


def serve_fifo(ctx: dict, out: dict, dev="cuda") -> None:
    """1,000 sweeping requests at t=0: serve_queue(fifo, 64) against
    ContinuousServer(64, 8) in both modes, ids and dists bit-equal."""
    import numpy as np
    from repro_torch.core import GraphExecutor
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousServer, Request, \
        results_in_order
    store, graph, queries = ctx["store"], ctx["graph"], ctx["queries"]
    bm = ctx["inputs"][0][1]
    p = main_params()
    nq = queries.shape[0]
    ex = GraphExecutor(graph, store, strategy="sweeping")
    rows = out["fifo"] = {}

    def run(name, fn):
        before = ops.launches()["frontier_scan"]
        with _expanded_lanes() as acc:
            sync(dev)
            t0 = time.perf_counter()
            r = fn()
            sync(dev)
            wall = time.perf_counter() - t0
        row = {"wall_s": wall, "qps": nq / wall,
               "frontier_scan_launches": ops.launches()["frontier_scan"]
               - before, "supersteps": acc["supersteps"],
               "queries_per_launch": _lanes_per_step(acc)}
        rows[name] = row
        return r, row

    (res, _), row = run("serve_queue", lambda: _query_server(
        ex, p, queries).serve_queue(np.arange(nq)[:, None], bm,
                                    batch_size=SERVE_WIDTH, policy="fifo"))
    print(f"   serve: serve_queue(fifo, {SERVE_WIDTH}) {nq} requests "
          f"{row['wall_s']:.3f} s = {row['qps']:.1f} QPS, "
          f"{row['frontier_scan_launches']} frontier_scan launches, "
          f"{row['queries_per_launch']:.2f} queries a launch", flush=True)
    for mode in ("continuous", "batch"):
        srv = ContinuousServer(ex, p, width=SERVE_WIDTH,
                               hop_chunk=SERVE_HOP_CHUNK)
        reqs = [Request(rid=i, query=queries[i], bitmap=bm[i])
                for i in range(nq)]
        (recs, info), row = run(mode, lambda: srv.serve(reqs, mode=mode))
        ids, dists = results_in_order(recs, nq, p.k)
        same = bool((ids == res.ids).all()
                    and (dists.view(np.int32)
                         == res.dists.view(np.int32)).all())
        row.update(ticks=info["ticks"], step_ticks=info["step_ticks"],
                   slot_utilization=info["slot_utilization"],
                   compiles=info["compiles"], bit_equal=same)
        print(f"   serve: ContinuousServer({SERVE_WIDTH}, "
              f"{SERVE_HOP_CHUNK}) {mode:10s} {row['wall_s']:.3f} s = "
              f"{row['qps']:.1f} QPS, ticks {info['ticks']} (stepped "
              f"{info['step_ticks']}), slot utilization "
              f"{info['slot_utilization']:.4f}, "
              f"{row['frontier_scan_launches']} frontier_scan launches, "
              f"{row['queries_per_launch']:.2f} queries a launch, "
              f"compiles {info['compiles']}; equal to serve_queue: {same}",
              flush=True)
        check(same, f"serve: {mode} batching differs from serve_queue")


def _trace(queries, bm_fast, bm_slow, n: int, load: float, seed: int):
    """benchmarks/bench_serving.py's make_trace: Poisson arrivals at
    `load` requests a tick; a share STRAGGLER_FRAC of them in bursts of
    BURST_LEN repeating one query with its selectivity-0.02 predicate."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.RandomState(seed)
    arrivals = np.floor(np.cumsum(
        rng.exponential(1.0 / load, n))).astype(np.int64)
    nq = queries.shape[0]
    reqs, slow = [], []
    i = 0
    while i < n:
        if rng.rand() < STRAGGLER_FRAC / BURST_LEN:
            hot = rng.randint(nq)
            for _ in range(min(BURST_LEN, n - i)):
                reqs.append(Request(rid=i, query=queries[hot],
                                    bitmap=bm_slow[hot],
                                    arrival=int(arrivals[i])))
                slow.append(i)
                i += 1
        else:
            qi = rng.randint(nq)
            reqs.append(Request(rid=i, query=queries[qi],
                                bitmap=bm_fast[qi],
                                arrival=int(arrivals[i])))
            i += 1
    return reqs, slow


def serve_open_loop(ctx: dict, out: dict, dev="cuda") -> None:
    """The open-loop trace through both modes: p50 / p99 latency ticks,
    goodput within the SLO, utilization, wall; per-request ids equal
    between the modes."""
    import numpy as np
    from repro_torch.core import GraphExecutor, WorkloadSpec, \
        generate_bitmaps
    from repro_torch.serving import ContinuousServer, Request
    store, graph, queries = ctx["store"], ctx["graph"], ctx["queries"]
    p = main_params()
    ex = GraphExecutor(graph, store, strategy="sweeping")
    bm_fast = generate_bitmaps(store, queries, WorkloadSpec(SEL_FAST, "none"),
                               seed=1, device=dev)
    bm_slow = generate_bitmaps(store, queries,
                               WorkloadSpec(SEL_SLOW, "high_pos"), seed=2,
                               device=dev)
    service = []
    w = min(SERVE_WIDTH, queries.shape[0])
    for bm in (bm_fast, bm_slow):         # bench_serving._service_estimate
        reqs = [Request(rid=i, query=queries[i], bitmap=bm[i])
                for i in range(w)]
        recs, _ = ContinuousServer(ex, p, width=SERVE_WIDTH,
                                   hop_chunk=SERVE_HOP_CHUNK).serve(reqs)
        service.append(float(np.mean([recs[i]["latency_ticks"]
                                      for i in range(w)])))
    s_fast, s_slow = service
    s_mean = (1 - STRAGGLER_FRAC) * s_fast + STRAGGLER_FRAC * s_slow
    capacity = SERVE_WIDTH / s_mean
    load = TRACE_LOAD * capacity
    slo = 1.5 * s_slow
    reqs, slow = _trace(queries, bm_fast, bm_slow, TRACE_REQUESTS, load,
                        TRACE_SEED)
    row = out["open_loop"] = {
        "service_ticks": {"fast": s_fast, "slow": s_slow, "mean": s_mean},
        "capacity_req_per_tick": capacity, "offered_load": load,
        "slo_ticks": slo, "requests": TRACE_REQUESTS,
        "stragglers": len(slow)}
    print(f"   serve: open loop, {TRACE_REQUESTS} requests ({len(slow)} in "
          f"bursts at sel {SEL_SLOW} high_pos): service ticks fast {s_fast:.2f}"
          f" slow {s_slow:.2f}, capacity {capacity:.4f} a tick, offered "
          f"{load:.4f} a tick ({TRACE_LOAD} x), SLO {slo:.1f} ticks",
          flush=True)
    got = {}
    for mode in ("continuous", "batch"):
        srv = ContinuousServer(ex, p, width=SERVE_WIDTH,
                               hop_chunk=SERVE_HOP_CHUNK)
        with _expanded_lanes() as acc:
            sync(dev)
            t0 = time.perf_counter()
            recs, info = srv.serve(reqs, mode=mode)
            sync(dev)
            wall = time.perf_counter() - t0
        lat = np.array([recs[i]["latency_ticks"]
                        for i in range(TRACE_REQUESTS)], np.float64)
        good = sum(1 for i in range(TRACE_REQUESTS)
                   if (recs[i]["ids"] >= 0).any() and lat[i] <= slo)
        got[mode] = np.stack([recs[i]["ids"] for i in range(TRACE_REQUESTS)])
        m = row[mode] = {
            "p50_ticks": float(np.percentile(lat, 50)),
            "p99_ticks": float(np.percentile(lat, 99)),
            "mean_ticks": float(lat.mean()),
            "goodput": good / TRACE_REQUESTS,
            "slot_utilization": info["slot_utilization"],
            "ticks": info["ticks"], "step_ticks": info["step_ticks"],
            "compiles": info["compiles"], "wall_s": wall,
            "qps": TRACE_REQUESTS / wall,
            "queries_per_launch": _lanes_per_step(acc)}
        print(f"   serve: open loop {mode:10s} p50 {m['p50_ticks']:.1f} p99 "
              f"{m['p99_ticks']:.1f} mean {m['mean_ticks']:.2f} ticks, "
              f"goodput {m['goodput']:.4f}, slot utilization "
              f"{m['slot_utilization']:.4f}, ticks {m['ticks']}, "
              f"{m['queries_per_launch']:.2f} queries a launch, wall "
              f"{wall:.3f} s", flush=True)
    row["p99_ratio_batch_over_continuous"] = \
        row["batch"]["p99_ticks"] / max(row["continuous"]["p99_ticks"], 1e-9)
    check(bool((got["continuous"] == got["batch"]).all()),
          "serve: open-loop ids differ between the modes")


def serve_ladder(ctx: dict, out: dict, dev="cuda") -> None:
    """The degradation ladder under seeded storage faults, LADDER_REQUESTS
    of workload A's requests served twice:
    failed reads happen, every request has k results or is flagged
    degraded, the two runs agree, and every rung that served a request
    launched its kernels."""
    import collections
    import dataclasses as dc
    import numpy as np
    from repro_torch.core import GraphExecutor, ScannExecutor
    from repro_torch.kernels import ops
    from repro_torch.serving import LadderRung, default_ladder
    from repro_torch.storage import FaultPlan, make_storage_engine
    qstore, graph, scann = ctx["qstore"], ctx["graph"], ctx["scann"]
    nq = min(LADDER_REQUESTS, ctx["queries"].shape[0])
    queries, bm = ctx["queries"][:nq], ctx["inputs"][0][1][:nq]
    p = main_params()
    rung_kernels = {"primary": ("frontier_scan",),
                    "sq8_norerank": ("frontier_scan_sq8",),
                    "scann_lite": ("distance_matrix", "leaf_scan_batched"),
                    "partial_scan": ()}
    runs = []
    for _ in range(2):
        eng = make_storage_engine(qstore, scann, graph, capacity_frac=0.25,
                                  faults=FaultPlan(**LADDER_FAULTS))
        gex = GraphExecutor(graph, qstore, strategy="sweeping", storage=eng)
        ladder = default_ladder(gex)
        ladder.insert(2, LadderRung(
            "scann_lite", ScannExecutor(scann, qstore, storage=eng),
            lambda r: dc.replace(r, num_leaves_to_search=max(
                1, r.num_leaves_to_search // 2))))
        before = ops.launches()
        with _timed_accounting(eng, dev) as spent:
            sync(dev)
            t0 = time.perf_counter()
            res, info = _query_server(gex, p, queries).serve_queue(
                np.arange(nq)[:, None], bm, batch_size=SERVE_WIDTH,
                policy="fifo", ladder=ladder)
            sync(dev)
            wall = time.perf_counter() - t0
        after = ops.launches()
        runs.append((res, info, wall, {k: after[k] - before[k]
                                       for k in after}, dict(spent)))
    (res, info, wall, launches, spent), (res2, info2, wall2, _, _) = runs
    rungs = dict(collections.Counter(info["rung"].tolist()))
    full = (res.ids >= 0).all(1)
    out["ladder"] = {
        "requests": nq, "ladder": info["ladder"], "rungs": rungs,
        "wall_s": [wall, wall2], "retried": int(info["retried"].sum()),
        "faulted": int(info["faulted"].sum()),
        "degraded": int(info["degraded"].sum()),
        "pool_failed_reads": info["pool_failed_reads"],
        "pool_retries": info["pool_retries"],
        "pool_spikes": info["pool_spikes"],
        "pool_hit_rate": info["pool_hit_rate"], "compiles": info["compiles"],
        "launches": {k: v for k, v in launches.items() if v},
        "accounting_s": spent}
    print(f"   serve: ladder under faults {LADDER_FAULTS}, pool of a quarter"
          f" of the pages, {nq} requests fifo {SERVE_WIDTH}: rungs {rungs}, "
          f"retried {out['ladder']['retried']}, degraded "
          f"{out['ladder']['degraded']}, failed reads "
          f"{info['pool_failed_reads']}, retries {info['pool_retries']}, "
          f"spikes {info['pool_spikes']}, hit rate "
          f"{info['pool_hit_rate']:.4f}, wall {wall:.2f} s and {wall2:.2f} s"
          f" (first run: storage accounting {spent['account']:.2f} s, of "
          f"which ordering the traces {spent['order']:.2f} s and the pool "
          f"replay with its fault draws {spent['replay']:.2f} s); launches "
          f"{out['ladder']['launches']}", flush=True)
    check(info["pool_failed_reads"] > 0, "serve: the fault plan failed no "
          "read")
    check(bool((full | info["degraded"]).all()),
          "serve: a request has fewer than k results and no degraded flag")
    check(bool((res.ids == res2.ids).all()) and all(
        bool((info[k] == info2[k]).all())
        for k in ("rung", "retried", "faulted")),
        "serve: the ladder is not deterministic under one fault plan")
    for rung in rungs:
        for k in rung_kernels.get(rung, ()):
            check(launches[k] > 0, f"serve: rung {rung} served requests "
                  f"without launching {k}")


def serve_admission(ctx: dict, out: dict, dev="cuda") -> None:
    """Deadline admission: 50 x the admission floor for every request but
    one at 0.4 x, which is rejected with ids -1; a ContinuousServer over
    distinct deadline buckets keeps its dispatch shapes at the
    reference's bound (6)."""
    import numpy as np
    from repro_torch.core import GraphExecutor
    from repro_torch.serving import (ContinuousServer, Request,
                                     admission_floor, bucket_deadline)
    store, graph, queries = ctx["store"], ctx["graph"], ctx["queries"]
    bm = ctx["inputs"][0][1]
    p = main_params()
    n = min(ADMISSION_REQUESTS, queries.shape[0])
    ex = GraphExecutor(graph, store, strategy="sweeping")
    floor = admission_floor(store, p)
    dls = np.full(n, 50 * floor)
    dls[0] = 0.4 * floor
    t0 = time.perf_counter()
    res, info = _query_server(ex, p, queries).serve_queue(
        np.arange(n)[:, None], bm[:n], batch_size=SERVE_WIDTH,
        policy="fifo", deadlines=dls)
    wall = time.perf_counter() - t0
    check(not info["admitted"][0] and bool((res.ids[0] == -1).all())
          and bool(info["admitted"][1:].all()),
          "serve: the sub-floor deadline was not rejected alone")
    cdl = [floor * (2.0 + i) for i in range(n)]
    buckets = len({bucket_deadline(d) for d in cdl})
    t1 = time.perf_counter()
    recs, cinfo = ContinuousServer(ex, p, width=SERVE_WIDTH,
                                   hop_chunk=SERVE_HOP_CHUNK).serve(
        [Request(rid=i, query=queries[i], bitmap=bm[i],
                 deadline_cycles=cdl[i]) for i in range(n)])
    cwall = time.perf_counter() - t1
    out["admission"] = {"floor_cycles": floor, "requests": n,
                        "rejected": [int(i) for i in
                                     np.flatnonzero(~info["admitted"])],
                        "serve_queue_compiles": info["compiles"],
                        "serve_queue_wall_s": wall,
                        "continuous_buckets": buckets,
                        "continuous_compiles": cinfo["compiles"],
                        "continuous_wall_s": cwall}
    print(f"   serve: admission floor {floor:.1f} cycles; serve_queue "
          f"rejected {out['admission']['rejected']} (0.4 x floor) of {n}, "
          f"compiles {info['compiles']}, {wall:.2f} s; ContinuousServer over "
          f"{buckets} deadline buckets: compiles {cinfo['compiles']}, "
          f"{cwall:.2f} s", flush=True)
    check(buckets >= 5 and cinfo["compiles"] <= 6,
          f"serve: {cinfo['compiles']} dispatch shapes over {buckets} "
          "deadline buckets")
    check(all(recs[i]["retire_tick"] >= 0 for i in range(n)),
          "serve: a deadline request was not served")


def serve_rag(ctx: dict, out: dict, dev="cuda") -> None:
    """Retrieval-augmented generation: granite-8b's smoke LM on the card,
    the adaptive planner over the 1M store, (1M, 8) document tokens; 4
    prompts x 32 tokens retrieve under selectivity-0.2 bitmaps (every id
    must pass its filter), then ServeEngine generates 16 tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core import (SearchParams, WorkloadSpec,
                                  generate_bitmaps, make_executor,
                                  probe_batch)
    from repro_torch.models import build_model
    from repro_torch.serving import RetrievalAugmentedServer, ServeEngine
    store = ctx["qstore"]
    cfg = smoke_config("granite-8b")
    bundle = build_model(cfg)
    params = bundle.init(0, dev)
    ex = make_executor("adaptive", store, graph=ctx["graph"],
                       index=ctx["scann"], device=dev)
    rng = np.random.RandomState(0)
    docs = rng.randint(0, cfg.vocab, (store.n, 8)).astype(np.int32)
    sp = SearchParams(k=4, num_leaves_to_search=16)
    srv = RetrievalAugmentedServer(bundle, params, ex, sp, docs, chunk_len=8)
    prompts = rng.randint(0, cfg.vocab, (4, 32)).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(0)
    bm = generate_bitmaps(store, torch.randn(4, store.dim, generator=gen,
                                             device=dev),
                          WorkloadSpec(0.2, "none"), seed=3, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    res = srv.retrieve(prompts, bm)
    sync(dev)
    retrieve_s = time.perf_counter() - t0
    ids = torch.as_tensor(res.ids, device=dev).to(torch.int64)
    passing = bool(probe_batch(bm, ids.clamp(min=0))[ids >= 0].all())
    check(passing and bool((ids >= 0).all()),
          "serve: a retrieved id fails its filter, or fewer than k came")
    check(res.tokens.shape == (4, 4 * 8 + 32), "serve: augmented prompts "
          f"have shape {res.tokens.shape}")
    engine = ServeEngine(bundle, params, max_seq=res.tokens.shape[1] + 16,
                         batch_size=4, device=dev)
    t0 = time.perf_counter()
    toks = engine.generate(res.tokens, 16)
    sync(dev)
    generate_s = time.perf_counter() - t0
    check(toks.shape == (4, 16) and bool((toks >= 0).all()
                                         and (toks < cfg.vocab).all()),
          f"serve: generated {toks.shape}")
    out["rag"] = {"config": "granite-8b (smoke)", "strategy": res.strategy,
                  "retrieve_s": retrieve_s, "generate_s": generate_s,
                  "prompt_len": int(res.tokens.shape[1]),
                  "first_ids": res.ids[0].tolist()}
    print(f"   serve: RAG granite-8b smoke LM, 4 x 32-token prompts, "
          f"planner chose {res.strategy}: retrieve {retrieve_s:.3f} s (ids "
          f"pass their filters), augmented prompts {res.tokens.shape}, "
          f"generate 16 tokens {generate_s:.3f} s", flush=True)


def phase_serve(ctx: dict, report: dict, dev="cuda") -> None:
    """The serving path on main's context, its kernel launches counted
    from 0: stepped search, FIFO equivalence, the open-loop trace, the
    fault ladder, admission and retrieval-augmented generation."""
    from repro_torch.kernels import ops
    print("== serve: the stepped frontier driver, continuous batching and "
          "the retrieval server on the 1M store ==", flush=True)
    out = report["serve"] = {}
    secs = out["seconds"] = {}
    ctx["results"] = report["main"]["results"]
    ops.reset_launches()
    for name, fn in (("stepped", serve_stepped), ("fifo", serve_fifo),
                     ("open_loop", serve_open_loop),
                     ("ladder", serve_ladder),
                     ("admission", serve_admission), ("rag", serve_rag)):
        t0 = time.perf_counter()
        fn(ctx, out, dev)
        secs[name] = time.perf_counter() - t0
    counts = ops.launches()
    out["launches"] = counts
    print(f"   launches on the serving path: {counts}; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    for k in ("frontier_scan", "frontier_scan_sq8", "distance_matrix",
              "leaf_scan_batched"):
        check(counts[k] > 0, f"kernel {k} was not launched on the serving "
              "path")


# ---------------------------------------------------------------------------
# kernels against their plain versions, with times and bounds
# ---------------------------------------------------------------------------

def _compare(name, got, want, exact_masks=()):
    import torch
    for g, w in exact_masks:
        check(bool(torch.equal(g, w)), f"{name}: masks differ")
    fin = torch.isfinite(want)
    check(bool(torch.equal(fin, torch.isfinite(got))),
          f"{name}: +inf positions differ")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    check(bool(torch.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)),
          f"{name}: max abs error {err}")
    return err


def phase_kernels(ctx: dict, report: dict) -> list[dict]:
    import torch
    from repro_torch.core.scann import (_select_leaves, _unique_pad,
                                        project_query)
    from repro_torch.kernels import ref
    from repro_torch.kernels.distance import distance_matrix_cuda
    from repro_torch.kernels.leaf_scan import leaf_scan_batched_cuda

    print("== kernels: each against its plain version on the card ==",
          flush=True)
    store, graph, scann = ctx["store"], ctx["graph"], ctx["scann"]
    queries, bitmaps = ctx["queries"], ctx["bitmaps"]
    p = main_params()
    d = store.dim

    # the frontier kernels: (Q, deg) 1-hop candidate blocks of the graph;
    # eight different blocks in turn, so the gathered rows (~130 MB in f32)
    # do not stay in the 50 MB L2 from one launch to the next
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qn = queries.shape[0]

    def hop():
        return graph.neighbors[0, torch.randint(store.n, (qn,), generator=gen,
                                                device="cuda")]

    blocks = [hop().contiguous() for _ in range(8)]
    # the 2-hop chunks (frontier_chunk2 = 64): two neighbor lists a query
    blocks2 = [torch.cat([hop(), hop()], 1).contiguous() for _ in range(8)]
    out = frontier_kernel_rows(ctx, blocks, blocks2)

    # distance_matrix: one query block against the 2000 leaf centroids
    qb = queries[:p.scann_query_block]
    qp = project_query(scann, qb).contiguous()
    cents = scann.leaf_centroids
    got = distance_matrix_cuda(qp, cents, scann.metric)
    err = _compare("distance_matrix", got,
                   ref.distance_matrix_ref(qp, cents, scann.metric))
    kern = lambda: distance_matrix_cuda(qp, cents, scann.metric)  # noqa: E731
    ms, call_ms = device_ms(kern), cuda_ms(kern)
    plain_ms = device_ms(lambda: ref.distance_matrix_ref(qp, cents,
                                                         scann.metric))
    base = (qp * qp).sum(1, keepdim=True) + (cents * cents).sum(1)[None, :]
    lib_ms = device_ms(lambda: torch.addmm(base, qp, cents.T, beta=1,
                                           alpha=-2))
    nq_b, nc = qp.shape[0], cents.shape[0]
    b_ms, b_by = bound((nq_b * d + nc * d + nq_b * nc) * 4,
                       2 * nq_b * nc * d + 2 * (nq_b + nc) * d)
    out.append({"name": "distance_matrix", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/distance.cu",
                "replaces": "src/repro/kernels/distance.py:44",
                "launches": ctx["launches"]["distance_matrix"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "call_ms": call_ms, "shape": f"Q={nq_b} N={nc} d={d}"})

    # leaf_scan_batched: the first query block's union of opened leaves
    L = scann.leaf_tiles.shape[0]
    nl = min(p.num_leaves_to_search, L)
    leaves, _ = _select_leaves(scann, qp, nl)
    uleaves, _, _ = _unique_pad(leaves.reshape(-1), L)
    tiles = scann.leaf_tiles[uleaves].contiguous()
    rowids = scann.leaf_rowids[uleaves].contiguous()
    norms = scann.row_norms_sq[uleaves].contiguous()
    bmq = bitmaps[:nq_b].contiguous()
    args = (qp, tiles, rowids, scann.scale, scann.mean, bmq, norms,
            scann.metric)
    got = leaf_scan_batched_cuda(*args)
    err = _compare("leaf_scan_batched", got, ref.leaf_scan_batched_ref(*args))
    ms = device_ms(lambda: leaf_scan_batched_cuda(*args), iters=20)
    call_ms = cuda_ms(lambda: leaf_scan_batched_cuda(*args))
    plain_ms = device_ms(lambda: ref.leaf_scan_batched_ref(*args), iters=5)
    u, c, _ = tiles.shape
    lib_ms = device_ms(lambda: torch.matmul(
        qp, (tiles.to(torch.float32) * scann.scale + scann.mean)
        .reshape(u * c, d).T), iters=5)
    valid = rowids >= 0
    n_valid = int(valid.sum())
    words = int(torch.unique(rowids[valid] >> 5).numel())
    # queries, scale/mean and every row id in once; the valid rows' int8
    # codes and norms; each query's bitmap words over those rows; (Q, U, C)
    # scores out, padded rows (+inf) too.  Flops the function needs: q.x
    # per (query, valid row), 2 a term; each valid row dequantized once, 2
    # a term
    nbytes = (nq_b * d * 4 + 2 * d * 4 + u * c * 4 + n_valid * (d + 4)
              + nq_b * words * 4 + nq_b * u * c * 4)
    flops = 2 * nq_b * n_valid * d + 2 * n_valid * d
    b_ms, b_by = bound(nbytes, flops)
    out.append({"name": "leaf_scan_batched", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/leaf_scan.cu",
                "replaces": "src/repro/kernels/leaf_scan.py:152",
                "launches": ctx["launches"]["leaf_scan_batched"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "call_ms": call_ms, "shape": f"Q={nq_b} U={u} C={c} d={d}",
                "valid_rows": n_valid})
    out += slice3_kernel_rows(ctx)
    for k in out:
        print_kernel_row(k)
    report["kernels"] = out
    return out


def print_kernel_row(k: dict) -> None:
    print(f"   {k['name']:22s} {k['shape']:28s} kernel {k['ms']:.4f} ms"
          f" plain {k['plain_ms']:.4f} ms library {k['library_ms']:.4f}"
          f" ms bound {k['bound_ms']:.4f} ms ({k['bound_by']}) | "
          f"per call with the host's work {k['call_ms']:.4f} ms | "
          f"max|err| {k['max_abs_err']:.3g} launches {k['launches']}",
          flush=True)


def _leaf_groups(leaves, n_leaves: int) -> dict:
    """How the (Q, nl) opened-leaf block groups by leaf: the leaf_scan
    kernel scores each leaf once against its group, 32 queries a chunk."""
    import torch
    counts = torch.bincount(leaves.reshape(-1).long(), minlength=n_leaves)
    g = counts[counts > 0]
    slots = int(g.sum())
    chunks = int(((g + 31) // 32).sum())
    return {"leaves": int(g.numel()), "mean": float(g.double().mean()),
            "median": int(g.median()), "max": int(g.max()),
            "share_ge_32": float(g[g >= 32].sum()) / slots,
            "share_ge_64": float(g[g >= 64].sum()) / slots,
            "chunks": chunks, "lane_fill": slots / (32 * chunks)}


def slice3_kernel_rows(ctx: dict) -> list[dict]:
    """leaf_scan on the whole batch's (Q, nl) opened-leaf block, as the
    scann_vmapped path launches it, and topk on one query's flattened
    per-query scores (n = nl * C, k = k * reorder_factor, the selection
    scann.py:273 makes) and on one query's 1M distances (k = 10)."""
    import torch
    from repro_torch.core import full_distances
    from repro_torch.core.scann import _select_leaves, project_query
    from repro_torch.kernels import ref
    from repro_torch.kernels.leaf_scan import leaf_scan_cuda
    from repro_torch.kernels.topk import topk_cuda

    scann, store = ctx["scann"], ctx["store"]
    queries, bitmaps = ctx["queries"], ctx["bitmaps"]
    p = main_params()
    qn, d = queries.shape
    L, C, dp = scann.leaf_tiles.shape
    nl = min(p.num_leaves_to_search, L)
    qp = project_query(scann, queries).contiguous()
    leaves, _ = _select_leaves(scann, qp, nl)
    leaves = leaves.to(torch.int32).contiguous()
    args = (qp, leaves, scann.leaf_tiles, scann.leaf_rowids, scann.scale,
            scann.mean, bitmaps, scann.metric)
    got = leaf_scan_cuda(*args)
    want = ref.leaf_scan_ids_ref(*args)
    err = _compare("leaf_scan", got, want)
    groups = _leaf_groups(leaves, L)
    print(f"   leaf_scan groups (slots a leaf): {groups['leaves']} leaves, "
          f"mean {groups['mean']:.2f}, median {groups['median']}, max "
          f"{groups['max']}; share of slots in groups >= 32: "
          f"{groups['share_ge_32']:.4f}, >= 64: {groups['share_ge_64']:.4f};"
          f" {groups['chunks']} chunks of <= 32 queries, query lanes "
          f"filled {groups['lane_fill']:.4f}", flush=True)
    # each score's arithmetic depends on (query, slot, row) alone: the same
    # bits from run to run and for the queries in another order
    check(bool(torch.equal(leaf_scan_cuda(*args), got)),
          "leaf_scan: two runs differ")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    perm = torch.randperm(qn, device="cuda", generator=gen)
    back = torch.empty_like(got)
    back[perm] = leaf_scan_cuda(qp[perm].contiguous(),
                                leaves[perm].contiguous(), *args[2:6],
                                bitmaps[perm].contiguous(), scann.metric)
    check(bool(torch.equal(back, got)),
          "leaf_scan: scores for a shuffled query order differ")
    print("   leaf_scan: bit-equal from run to run and under a permutation "
          "of the queries", flush=True)
    kern = lambda: leaf_scan_cuda(*args)  # noqa: E731
    ms, call_ms = device_ms(kern, iters=10), cuda_ms(kern, iters=10)
    plain_ms = device_ms(lambda: ref.leaf_scan_ids_ref(*args), iters=2,
                         warmup=1)

    def library():
        # dequantize + torch.bmm, 64 queries at a time
        for s in range(0, qn, 64):
            x = ref.dequantize(scann.leaf_tiles[leaves[s:s + 64].long()],
                               scann.scale, scann.mean)
            b, n_l = x.shape[:2]
            torch.bmm(x.reshape(b, n_l * C, dp), qp[s:s + 64, :, None])
    lib_ms = device_ms(library, iters=2, warmup=1)
    rows = scann.leaf_rowids[leaves.long()]                  # (Q, nl, C)
    n_valid = int((rows >= 0).sum())
    uniq = torch.unique(leaves)
    distinct_valid = int((scann.leaf_rowids[uniq.long()] >= 0).sum())
    # queries and the leaf-id block in; each distinct tile with its rowids
    # once; scale and mean; one bitmap word per valid row; (Q, nl, C) out.
    # Flops the function needs: q.x per (query, valid row), 2 a term;
    # dequantizing a row and its ||x||^2 once per distinct valid row, 2 a
    # term each; ||q||^2 once per query
    nbytes = (qn * dp * 4 + qn * nl * 4 + int(uniq.numel()) * C * (dp + 4)
              + 2 * dp * 4 + n_valid * 4 + qn * nl * C * 4)
    b_ms, b_by = bound(nbytes, 2 * n_valid * dp + 4 * distinct_valid * dp
                       + 2 * qn * dp)
    out = [{"name": "leaf_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/leaf_scan.cu",
            "replaces": "src/repro/kernels/leaf_scan.py:84",
            "launches": ctx["launches"]["leaf_scan"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "call_ms": call_ms,
            "shape": f"Q={qn} nl={nl} C={C} d={dp} L={L} "
                     f"({int(uniq.numel())} distinct leaves)",
            "bytes_rereading_tiles": qn * nl * C * dp, "groups": groups,
            "valid_pairs": n_valid}]

    # topk: values and indices exact against the plain version
    cases = {"per_query": (got[0].reshape(-1).contiguous(),
                           p.k * p.reorder_factor),
             "1M": (full_distances(store, queries[:1])[0].contiguous(), p.k)}
    timing = {}
    for key, (v, k) in cases.items():
        gv, gi = topk_cuda(v, k)
        wv, wi = ref.topk_partial_ref(v, k)
        check(bool(torch.equal(gv, wv) and torch.equal(gi, wi)),
              f"topk {key}: values or indices differ from the plain version")
        kern = lambda: topk_cuda(v, k)  # noqa: E731
        timing[key] = {
            "n": int(v.numel()), "k": k, "ms": device_ms(kern),
            "call_ms": cuda_ms(kern, iters=40),
            "plain_ms": device_ms(lambda: ref.topk_partial_ref(v, k)),
            "library_ms": device_ms(lambda: torch.topk(v, k, largest=False)),
            "bound": bound(v.numel() * 4 + k * 8, v.numel())}
    t = timing["per_query"]
    out.append({"name": "topk", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/topk.cu",
                "replaces": "src/repro/kernels/topk.py:49",
                "launches": ctx["launches"]["topk"], "max_abs_err": 0.0,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"], "call_ms": t["call_ms"],
                "shape": f"n={t['n']} k={t['k']}", "n_1m": timing["1M"]})
    t1 = timing["1M"]
    print(f"   topk n={t1['n']} k={t1['k']}: kernel {t1['ms']:.4f} ms plain "
          f"{t1['plain_ms']:.4f} ms library {t1['library_ms']:.4f} ms bound "
          f"{t1['bound'][0]:.4f} ms | per call {t1['call_ms']:.4f} ms",
          flush=True)
    return out


def frontier_kernel_rows(ctx: dict, blocks, blocks2) -> list[dict]:
    """The four frontier kernels on the main path's (Q, 32) 1-hop blocks,
    over the full-precision and the SQ8 rows of the quantized store: the
    f32 scan with workload A's bitmaps, the others with the family
    workload's, whose radius rows the exclusion variants read, and tau =
    each query's exact 10th filtered distance (a full W tail).  The f32
    and SQ8 scans also on the (Q, 64) 2-hop blocks (`two_hop`)."""
    import torch
    from repro_torch.core import filtered_knn, select_radii
    from repro_torch.kernels import ref
    from repro_torch.kernels.frontier_scan import (
        frontier_scan_cuda, frontier_scan_excl_cuda,
        frontier_scan_excl_sq8_cuda, frontier_scan_sq8_cuda)

    st, excl = ctx["qstore"], ctx["excl"]
    queries, bma = ctx["queries"], ctx["bitmaps"]
    _, fbm, _ = ctx["family"]
    qn, d = queries.shape
    radii = select_radii(excl, fbm)
    tau = filtered_knn(st, queries, fbm, 10)[0][:, -1].contiguous()
    q8 = (st.q_vectors, st.q_scale, st.q_mean, st.q_norms_sq)
    f32 = (st.vectors, st.norms_sq)
    ex = (radii.table, radii.rows, tau)
    variants = {
        "frontier_scan": (
            lambda ids: frontier_scan_cuda(queries, *f32, ids, bma,
                                           st.metric),
            lambda ids: ref.frontier_scan_ref(queries, *f32, ids, bma,
                                              st.metric),
            False, False),
        "frontier_scan_sq8": (
            lambda ids: frontier_scan_sq8_cuda(queries, *q8, ids, fbm),
            lambda ids: ref.frontier_scan_sq8_ref(queries, *q8, ids, fbm),
            True, False),
        "frontier_scan_excl": (
            lambda ids, m=EXCL_MARGIN: frontier_scan_excl_cuda(
                queries, *f32, ids, fbm, *ex, margin=m),
            lambda ids: ref.frontier_scan_excl_ref(queries, *f32, ids, fbm,
                                                   *ex, margin=EXCL_MARGIN),
            False, True),
        "frontier_scan_excl_sq8": (
            lambda ids, m=EXCL_MARGIN: frontier_scan_excl_sq8_cuda(
                queries, *q8, ids, fbm, *ex, margin=m),
            lambda ids: ref.frontier_scan_excl_sq8_ref(
                queries, *q8, ids, fbm, *ex, margin=EXCL_MARGIN),
            True, True),
    }
    replaces = {"frontier_scan": 92, "frontier_scan_sq8": 164,
                "frontier_scan_excl": 240, "frontier_scan_excl_sq8": 322}

    def measure(name, kern, plain, sq8, has_keep, blocks):
        """Kernel vs plain on every block, times and the bound, cycling
        over the blocks."""
        it = iter(range(10 ** 9))

        def pick():
            return blocks[next(it) % len(blocks)]

        errs, flips, pruned = [], 0, 0
        for ids in blocks:
            got, want = kern(ids), plain(ids)
            errs.append(_compare(name, got[0], want[0], [(got[1], want[1])]))
            if has_keep:
                # keep is exact against the rule on the kernel's own
                # distances; against the plain distances a boundary
                # decision may flip (FMA contraction), counted here
                e = ref.gather_radii(radii.table, radii.rows, ids)
                own = ref.excl_keep_mask(got[0], e, tau[:, None], got[1],
                                         EXCL_MARGIN)
                check(bool(torch.equal(got[2], own)),
                      f"{name}: keep differs from the rule on its own "
                      "distances")
                flips += int((got[2] != want[2]).sum())
                pruned += int((~got[2]).sum())
        ms = device_ms(lambda: kern(pick()))
        call_ms = cuda_ms(lambda: kern(pick()), iters=40)
        plain_ms = device_ms(lambda: plain(pick()))
        if sq8:
            lib = lambda: torch.bmm(ref.dequantize(  # noqa: E731
                st.q_vectors[pick().clamp(min=0).long()], st.q_scale,
                st.q_mean), queries[:, :, None])
        else:
            lib = lambda: torch.bmm(  # noqa: E731
                st.vectors[pick().clamp(min=0).long()], queries[:, :, None])
        lib_ms = device_ms(lib)
        nbytes, flops = [], []
        row_bytes = d if sq8 else 4 * d
        for ids in blocks:
            valid = ids >= 0
            nv = int(valid.sum())
            uniq = int(torch.unique(ids[valid]).numel())
            # queries + ids in; each distinct row and its norm once; one
            # bitmap word per probe; distances and pass flags out; SQ8 adds
            # scale/mean, the exclusion variants one radius per probe, the
            # query's table row and tau, and the keep flags out
            b = (qn * d * 4 + ids.numel() * 4 + uniq * (row_bytes + 4)
                 + nv * 4 + ids.numel() * 5)
            fl = 2 * d * nv + 2 * d * qn
            if sq8:
                b += 2 * d * 4
                fl += 2 * d * nv                 # dequantization
            if has_keep:
                b += nv * 4 + qn * 8 + ids.numel()
                fl += 6 * nv
            nbytes.append(b)
            flops.append(fl)
        b_ms, b_by = bound(sum(nbytes) / len(nbytes), sum(flops) / len(flops))
        row = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "call_ms": call_ms,
               "shape": f"Q={qn} C={blocks[0].shape[1]} d={d} n={st.n}"}
        if has_keep:
            # padding at margin 0: the rule's bound there is 0 * inf = NaN,
            # so no padded id is kept (and the rest follow the rule)
            pad = blocks[0].clone()
            pad[::3] = -1
            pad[:, ::5] = -1
            got = kern(pad, 0.0)
            e = ref.gather_radii(radii.table, radii.rows, pad)
            check(bool(torch.equal(got[2], ref.excl_keep_mask(
                got[0], e, tau[:, None], got[1], 0.0))),
                f"{name}: keep at margin 0 differs from the rule")
            pad_kept = int(got[2][pad < 0].sum())
            check(pad_kept == 0, f"{name}: {pad_kept} padded ids kept at "
                  "margin 0")
            row["padding_kept_at_margin_0"] = pad_kept
            row["keep_vs_plain_flips"] = flips
            row["keep_pruned"] = pruned
            print(f"   {name}: keep exact against its own distances; "
                  f"{flips} of {len(blocks) * blocks[0].numel()} decisions "
                  f"differ from the plain version's ({pruned} pruned); "
                  f"{int((pad < 0).sum())} padded ids at margin 0, "
                  f"{pad_kept} kept", flush=True)
        return row

    out = []
    for name, (kern, plain, sq8, has_keep) in variants.items():
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/frontier_scan.cu",
               "replaces": "src/repro/kernels/frontier_scan.py:"
                           f"{replaces[name]}",
               "launches": ctx["launches"][name]}
        row.update(measure(name, kern, plain, sq8, has_keep, blocks))
        if not has_keep:
            # the 2-hop chunk (frontier_chunk2) the same way
            two = measure(f"{name} 2-hop", kern, plain, sq8, False, blocks2)
            row["two_hop"] = two
            print(f"   {name} 2-hop {two['shape']}: kernel {two['ms']:.4f} ms"
                  f" plain {two['plain_ms']:.4f} ms library "
                  f"{two['library_ms']:.4f} ms bound {two['bound_ms']:.4f} ms"
                  f" ({two['bound_by']}) | per call {two['call_ms']:.4f} ms |"
                  f" max|err| {two['max_abs_err']:.3g}", flush=True)
        out.append(row)
    return out


def phase_profile(ctx: dict, report: dict) -> None:
    """One search per method under torch.profiler (the quickstart methods
    and the SQ8 methods on the first workload, the exclusion and
    partitioned methods on the family workload): the device's busy share
    of the wall time and the kernels that fill it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import make_executor

    print("== profile: device busy share per method ==", flush=True)
    p = main_params()
    rows = {}
    fbm = ctx["family"][1]
    runs = [(m, ctx["bitmaps"]) for m in METHODS + SQ8_METHODS] + [
        (m, fbm) for m in ("sweeping_excl", "sweeping_excl_sq8",
                           "partitioned", "partitioned_sq8")]
    for method, bm in runs:
        ex = make_executor(method, ctx["qstore"], graph=ctx["graph"],
                           index=ctx["scann"], exclusion=ctx["excl"],
                           partitions=ctx["parts"], device="cuda")
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.search(ctx["queries"], bm, p)
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        per_name = device_us_by_name(prof)
        busy_us = sum(per_name.values())
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        rows[method] = {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
                        "busy_share": busy_us / wall_us,
                        "top": [(k[:60], v / 1e3) for k, v in top]}
        print(f"   {method:18s} wall {wall_us / 1e3:.1f} ms (profiled) "
              f"device {busy_us / 1e3:.1f} ms busy {busy_us / wall_us:.3f}"
              f" | top: " + "; ".join(f"{k[:40]} {v / 1e3:.1f} ms"
                                     for k, v in top[:4]), flush=True)
    report["profile"] = rows


# ---------------------------------------------------------------------------
# lm: model serving (the encoder prefill through the flash kernel, the
# dense decoder's ServeEngine), at full width
# ---------------------------------------------------------------------------

# relative L2 error allowed between two bf16 paths over the same weights:
# bf16 keeps 8 significant bits (2^-9 = 0.2 % per rounding), the paths
# round at other points (the tensor-core kernel against its plain version:
# P in bf16, ~2.5e-3 a layer), and 36-48 layers of random weights carry
# each difference on and grow it.  Set between the encoder's readings
# (0.0338 against the plain version, 0.0336 against the jnp path, H100) and
# two broken kernels' (0.47 with the output zeroed, 1.35 with the scale
# dropped), PERF.md section 2
LM_REL_TOL = 0.05
# the smoke-size models compute in f32: card vs CPU within a few ulp
LM_SMOKE_TOL = 1e-4


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _free_cuda(dev="cuda"):
    import gc

    import torch
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def lm_smoke_parity(out: dict, dev="cuda") -> None:
    """Smoke-size models, f32, with the same weights on the CPU (plain
    versions) and on the card (the kernel): the hubert prefill through the
    flash kernel within LM_SMOKE_TOL; granite-8b's and gemma3-12b's greedy
    serving tokens equal."""
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, params_to
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(C.smoke_config("hubert-xlarge"),
                              pallas_flash=True)
    bundle = build_model(cfg)
    params = bundle.init(0, "cpu")
    frames = torch.as_tensor(np.random.RandomState(0).randn(
        2, 300, cfg.d_model).astype(np.float32))
    with torch.inference_mode():
        want = bundle.prefill(params, {"frames": frames})
        ops.reset_launches()
        got = bundle.prefill(params_to(params, dev),
                             {"frames": frames.to(dev)})
        sync(dev)
    launches = ops.launches()["flash_attention"]
    err = float((got.cpu() - want).abs().max())
    check(launches == (cfg.n_layers if dev == "cuda" else 0),
          f"lm smoke: {launches} flash launches, {cfg.n_layers} layers")
    check(bool(torch.allclose(got.cpu(), want, rtol=LM_SMOKE_TOL,
                              atol=LM_SMOKE_TOL)),
          f"lm smoke: hubert prefill card vs CPU max |err| {err}")
    out["smoke_hubert"] = {"max_abs_err": err, "launches": launches}
    print(f"   smoke hubert prefill (2 x 300 frames, f32): card vs CPU max "
          f"|err| {err:.3g}, {launches} flash launches", flush=True)
    for arch in ("granite-8b", "gemma3-12b"):
        cfg = C.smoke_config(arch)
        if arch == "gemma3-12b":       # two 5:1 groups
            cfg = dataclasses.replace(cfg, n_layers=12)
        bundle = build_model(cfg)
        params = bundle.init(0, "cpu")
        prompts = np.random.RandomState(1).randint(0, cfg.vocab, (4, 24))
        toks = {dev: ServeEngine(bundle, p, 24 + 16, 4, device=dev)
                .generate(prompts, 16)
                for dev, p in (("cpu", params),
                               (dev, params_to(params, dev)))}
        same = bool((toks["cpu"] == toks[dev]).all())
        out[f"smoke_{arch}_tokens_equal"] = same
        print(f"   smoke {arch} greedy tokens (4 x 24 + 16) card == CPU: "
              f"{same}", flush=True)
        check(same, f"lm smoke: {arch} greedy tokens differ card vs CPU")


@contextlib.contextmanager
def _attention(fn):
    """Send the encoder's fused attention (`ops.flash_attention_fused`) to
    `fn` inside the block."""
    from repro_torch.kernels import ops
    saved = ops.flash_attention_fused
    ops.flash_attention_fused = fn
    try:
        yield
    finally:
        ops.flash_attention_fused = saved


def _unscaled(q, k, v, causal=True):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = (q * math.sqrt(q.shape[-1])).contiguous()
    if q.is_cuda:
        return flash_attention_cuda(q, k.contiguous(), v.contiguous(), causal)
    return ref.flash_attention_ref(q, k, v, causal)


# kernels broken on purpose: the output zeroed, the 1/sqrt(hd) scale dropped
_ATTENTION_CONTROLS = {
    "zeroed": lambda q, k, v, causal=True: q.new_zeros(q.shape),
    "unscaled": _unscaled}


def encoder_serving(out: dict, frames: int, batch: int, dev="cuda") -> int:
    """hubert-xlarge's prefill at full width, every layer through the flash
    kernel, twice; then under torch.profiler for the kernel's share of the
    device time; then the blocked jnp-path prefill on the same weights, and
    the same prefill with the kernel's plain version, and with each of two
    broken kernels, in its place.  Returns the flash launches of the two
    prefills."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs as C
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model

    cfg = dataclasses.replace(C.get_config("hubert-xlarge"),
                              pallas_flash=True)
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(int(t.numel()) for t in _leaves(params))
    x = torch.as_tensor(np.random.RandomState(0).randn(
        batch, frames, cfg.d_model).astype(np.float32), device=dev)
    on_card = dev == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    walls = []
    with torch.inference_mode():
        ops.reset_launches()
        for i in range(2):
            t0 = time.perf_counter()
            y = bundle.prefill(params, {"frames": x})
            sync(dev)
            walls.append(time.perf_counter() - t0)
            got = ops.launches()["flash_attention"]
            check(got == (i + 1) * cfg.n_layers * on_card,
                  f"encoder prefill {i}: {got} flash launches in all, "
                  f"{cfg.n_layers} a prefill expected")
        launches = ops.launches()
        routes = ops.routes()
        # bf16 compute at hd 80: every launch on the tensor-core route
        check(routes == {"flash_attention.wgmma": 2 * cfg.n_layers * on_card,
                         "flash_attention.fma": 0},
              f"encoder prefill: flash routes {routes}")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        check(tuple(y.shape) == (batch, frames, cfg.d_model),
              f"encoder output shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "encoder output not finite")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bundle.prefill(params, {"frames": x})
            sync(dev)
        per_name = device_us_by_name(prof)
        dev_us = max(sum(per_name.values()), 1e-9)
        flash_us = sum(v for k, v in per_name.items()
                       if "flash_attention" in k)
        plain = build_model(dataclasses.replace(cfg, pallas_flash=False))
        t0 = time.perf_counter()
        yp = plain.prefill(params, {"frames": x})
        sync(dev)
        plain_s = time.perf_counter() - t0
        # the same prefill with the kernel's plain version in its place,
        # and two broken kernels as controls of the comparison
        with _attention(lambda q, k, v, causal=True:
                        ref.flash_attention_ref(q, k, v, causal)):
            yref = bundle.prefill(params, {"frames": x})
        controls = {}
        for name, fn in _ATTENTION_CONTROLS.items():
            with _attention(fn):
                controls[name] = bundle.prefill(params, {"frames": x})
        sync(dev)
    rel_ref = _rel(y, yref)
    ctl_ref = {k: _rel(c, yref) for k, c in controls.items()}
    ctl_jnp = {k: _rel(c, yp) for k, c in controls.items()}
    rel = _rel(y, yp)
    maxerr = float((y.float() - yp.float()).abs().max())
    print(f"   encoder vs the same prefill through the plain version: "
          f"relative error {rel_ref:.4f}, vs the jnp path {rel:.4f} "
          f"(tolerance {LM_REL_TOL}); broken kernels: "
          + ", ".join(f"{k} {ctl_ref[k]:.4f} and {ctl_jnp[k]:.4f}"
                      for k in ctl_ref), flush=True)
    check(rel_ref <= LM_REL_TOL, f"encoder prefill: kernel vs plain "
          f"version relative error {rel_ref} > {LM_REL_TOL}")
    check(rel <= LM_REL_TOL, f"encoder prefill: kernel path vs jnp path "
          f"relative error {rel} > {LM_REL_TOL}")
    check(min(*ctl_ref.values(), *ctl_jnp.values()) > LM_REL_TOL,
          f"encoder prefill: a broken kernel passes a comparison: "
          f"{ctl_ref}, {ctl_jnp}")
    out["encoder"] = {
        "config": "hubert-xlarge, pallas_flash=True", "params": n_params,
        "batch": batch, "frames": frames, "init_s": init_s,
        "prefill_s": walls, "frames_per_s": batch * frames / walls[-1],
        "peak_bytes": peak, "device_ms": dev_us / 1e3,
        "flash_device_ms": flash_us / 1e3, "flash_share": flash_us / dev_us,
        "top": sorted(((k[:80], v / 1e3) for k, v in per_name.items()),
                      key=lambda kv: -kv[1])[:6],
        "plain_path_s": plain_s, "rel_err_vs_plain_path": rel,
        "max_abs_err_vs_plain_path": maxerr,
        "rel_err_vs_plain_kernel": rel_ref,
        "controls_rel_err_vs_plain_kernel": ctl_ref,
        "controls_rel_err_vs_plain_path": ctl_jnp, "launches": launches,
        "routes": routes}
    print(f"   encoder hubert-xlarge ({n_params / 1e9:.3f} B params, f32 "
          f"weights, bf16 compute): {batch} x {frames} frames, prefill "
          f"{walls[0]:.3f} s then {walls[1]:.3f} s = "
          f"{batch * frames / walls[-1]:.0f} frames/s; peak "
          f"{peak / 2**30:.2f} GiB; device {dev_us / 1e3:.1f} ms of which "
          f"flash_attention {flash_us / 1e3:.1f} ms "
          f"({flash_us / dev_us:.3f}); {launches['flash_attention']} flash "
          f"launches in 2 prefills, routes {routes}", flush=True)
    print(f"   encoder jnp-path prefill {plain_s:.3f} s, max |err| against "
          f"it {maxerr:.4g}", flush=True)
    return launches["flash_attention"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def decoder_serving(out: dict, batch: int = 4, prompt_len: int = 128,
                    new: int = 32, dev="cuda") -> None:
    """granite-8b's ServeEngine at full width: greedy generation of `new`
    tokens for `batch` prompts of `prompt_len`, the prefill and each decode
    step timed to a synchronize.  The flash kernel must not run."""
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    cfg = C.get_config("granite-8b")
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(int(t.numel()) for t in _leaves(params))
    spent = {"prefill": [], "decode": []}
    # the prefill's logits and the decode replay's at the last prompt
    # position (decode call prompt_len): two paths' views of one position
    kept = {}

    def timed(kind, fn):
        def run(*a):
            sync(dev)
            t0 = time.perf_counter()
            r = fn(*a)
            sync(dev)
            spent[kind].append(time.perf_counter() - t0)
            if kind == "prefill":
                kept["prefill"] = r
            elif len(spent[kind]) == prompt_len:
                kept["replay"] = r[0]
            return r
        return run

    tb = dataclasses.replace(bundle, prefill=timed("prefill", bundle.prefill),
                             decode=timed("decode", bundle.decode))
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    engine = ServeEngine(tb, params, max_seq=prompt_len + new,
                         batch_size=batch, device=dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    toks = engine.generate(prompts, new)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    check(launches["flash_attention"] == 0,
          f"the decoder launched flash_attention "
          f"{launches['flash_attention']} times")
    check(toks.shape == (batch, new), f"generated {toks.shape}")
    check(bool((toks >= 0).all() and (toks < cfg.vocab).all()),
          "generated tokens out of range")
    rel = _rel(kept["replay"], kept["prefill"])
    agree = float((kept["replay"].argmax(-1)
                   == kept["prefill"].argmax(-1)).float().mean())
    check(rel <= LM_REL_TOL, f"decoder: replayed vs prefill logits relative "
          f"error {rel} > {LM_REL_TOL}")
    prof = _profile_decode(bundle, params, batch, prompt_len + new, dev)
    steps = spent["decode"]
    gen_steps = steps[prompt_len:]
    pre_s = spent["prefill"][0]
    ms_step = 1e3 * sum(steps) / len(steps)
    ms_gen = 1e3 * sum(gen_steps) / max(len(gen_steps), 1)
    out["decoder"] = {
        "config": "granite-8b", "params": n_params, "batch": batch,
        "prompt_len": prompt_len, "new_tokens": new, "init_s": init_s,
        "generate_s": wall, "prefill_s": pre_s,
        "prefill_tokens_per_s": batch * prompt_len / pre_s,
        "decode_steps": len(steps), "ms_per_decode_step": ms_step,
        "ms_per_generated_step": ms_gen,
        "decode_tokens_per_s": batch * 1e3 / ms_gen, "peak_bytes": peak,
        "replay_vs_prefill_rel_err": rel,
        "replay_vs_prefill_argmax_agree": agree,
        "stats": dataclasses.asdict(engine.stats), "launches": launches,
        "profile_4_steps": prof,
        "first_tokens": toks[:, :8].tolist()}
    print(f"   decoder granite-8b ({n_params / 1e9:.3f} B params, f32 "
          f"weights, bf16 compute, init {init_s:.1f} s): {batch} x "
          f"{prompt_len} prompt + {new} greedy in {wall:.2f} s; prefill "
          f"{pre_s:.3f} s = {batch * prompt_len / pre_s:.0f} tokens/s; "
          f"{len(steps)} decode steps at {ms_step:.2f} ms "
          f"({ms_gen:.2f} ms a generated step = "
          f"{batch * 1e3 / ms_gen:.1f} tokens/s); peak "
          f"{peak / 2**30:.2f} GiB; flash launches "
          f"{launches['flash_attention']}", flush=True)
    print(f"   decoder replayed vs prefill logits: relative error {rel:.4f}"
          f", argmax agreement {agree:.3f} (tolerance {LM_REL_TOL})",
          flush=True)


def _profile_decode(bundle, params, batch: int, seq: int, dev) -> dict:
    """Four decode steps of a fresh cache under torch.profiler: the wall,
    the device time, its busy share and the top device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev != "cuda":
        return {}
    cache = bundle.init_cache(batch, seq, dev)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        bundle.decode(params, cache, {"tokens": tok}, 0)
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pos in range(1, 5):
                bundle.decode(params, cache, {"tokens": tok}, pos)
            sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = device_us_by_name(prof)
    dev_ms = sum(per_name.values()) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms,
           "top": [(k[:80], v / 1e3) for k, v in top]}
    print(f"   decoder, 4 decode steps profiled: wall {wall_ms:.1f} ms, "
          f"device {dev_ms:.1f} ms (busy {dev_ms / wall_ms:.3f}); top: "
          + "; ".join(f"{k[:50]} {v / 1e3:.1f} ms" for k, v in top[:5]),
          flush=True)
    return out


def phase_lm(report: dict, frames: int, batch: int, dev="cuda") -> int:
    """The model-serving path; returns the flash launches of its encoder
    prefills (the kernel's launches on the main path)."""
    import torch
    print(f"== lm: model serving at full width ({batch} x {frames} frames; "
          "granite-8b 4 x 128 + 32) ==", flush=True)
    out = report["lm"] = {}
    lm_smoke_parity(out, dev)
    launches = encoder_serving(out, frames, batch, dev)
    _free_cuda(dev)
    with torch.inference_mode():
        decoder_serving(out, dev=dev)
    _free_cuda(dev)
    return launches


def flash_kernel_row(batch: int = 2, frames: int = 8192) -> dict:
    """flash_attention at the encoder's shape, q, k, v (batch, frames, 16,
    80) bf16, non-causal, through the tensor-core route, against its plain
    version on the card under the relative-L2 limit, beside two broken
    kernels the limit must refuse (the last 128 keys cut, the scale
    dropped), timed; a causal and a GQA bf16 case; and one f32 case
    through the FP32 FMA template at (1e-5, 1e-5)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, t, h, kv, hd, dtype=torch.bfloat16):
        return tuple(torch.randn(shape, device="cuda", generator=gen)
                     .to(dtype)
                     for shape in ((b, t, h, hd), (b, t, kv, hd),
                                   (b, t, kv, hd)))

    def routed(q, k, v, causal):
        ops.reset_launches()
        got = flash_attention_cuda(q, k, v, causal)
        return got, [r for r, n in ops.routes().items() if n]

    def compare(name, q, k, v, causal):
        got, used = routed(q, k, v, causal)
        check(used == ["flash_attention.wgmma"],
              f"flash_attention {name}: routes {used}")
        want = ref.flash_attention_ref(q, k, v, causal)
        rel, row = rel_l2(got, want)
        check(bool(torch.isfinite(got).all()) and rel <= FLASH_WGMMA_REL_L2
              and row <= FLASH_WGMMA_ROW_REL_L2,
              f"flash_attention {name}: relative L2 {rel}, worst row {row}")
        err = float((got.float() - want.float()).abs().max())
        return {"rel_l2": rel, "row_rel_l2": row, "max_abs_err": err}

    extra = {"causal (1, 2048, 16, 80)": compare(
                 "causal", *qkv(1, 2048, 16, 16, 80), True),
             "gqa G=4 (2, 1000, 16/4, 80)": compare(
                 "gqa", *qkv(2, 1000, 16, 4, 80), False)}
    # the FP32 FMA template on an f32 case, so both routes are held
    qf, kf, vf = qkv(1, 2048, 16, 16, 80, torch.float32)
    got, used = routed(qf, kf, vf, True)
    check(used == ["flash_attention.fma"], f"flash_attention f32: {used}")
    want = ref.flash_attention_ref(qf, kf, vf, True)
    f32_err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=FLASH_F32_TOL[0],
                              atol=FLASH_F32_TOL[1])),
          f"flash_attention f32 causal (1, 2048, 16, 80): max |err| "
          f"{f32_err}")
    extra["f32 fma causal (1, 2048, 16, 80)"] = {"max_abs_err": f32_err}
    del qf, kf, vf, got, want

    q, k, v = qkv(batch, frames, 16, 16, 80)
    main = compare("encoder shape", q, k, v, False)
    want = ref.flash_attention_ref(q, k, v, False)
    cut = flash_attention_cuda(q, k[:, :-128].contiguous(),
                               v[:, :-128].contiguous(), False)
    controls = {"last 128 keys cut": rel_l2(cut, want),
                "scale dropped": rel_l2(_unscaled(q, k, v, False),
                                            want)}
    del cut, want
    print(f"   flash_attention encoder shape: relative L2 {main['rel_l2']:.3g}"
          f" (worst row {main['row_rel_l2']:.3g}; limits "
          f"{FLASH_WGMMA_REL_L2}, {FLASH_WGMMA_ROW_REL_L2}); broken kernels "
          + ", ".join(f"{k} {r:.3g} (row {w:.3g})"
                      for k, (r, w) in controls.items()), flush=True)
    for name, (rel, row) in controls.items():
        check(rel > FLASH_WGMMA_REL_L2 or row > FLASH_WGMMA_ROW_REL_L2,
              f"flash_attention: the broken kernel ({name}) passes: "
              f"{rel}, {row}")
    kern = lambda: flash_attention_cuda(q, k, v, False)  # noqa: E731
    ms = device_ms(kern, iters=20, warmup=2)
    call_ms = cuda_ms(kern, iters=20, warmup=1)
    plain_ms = device_ms(lambda: ref.flash_attention_ref(q, k, v, False),
                         iters=2, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                       iters=20)
    b, t, h, hd = q.shape
    flops = 4 * b * h * t * t * hd
    nbytes = 4 * b * t * h * hd * 2
    # bf16 inputs: the bound is at the bf16 tensor-core peak
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_PER_S)
    print(f"   flash_attention cases: {extra}", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:99",
            "launches": 0, "max_abs_err": main["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "call_ms": call_ms,
            "shape": f"B={b} T=S={t} H=KV={h} hd={hd} bf16",
            "kernel_route": "wgmma", "rel_l2": main["rel_l2"],
            "row_rel_l2": main["row_rel_l2"],
            "controls_rel_l2": controls, "cases": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "on one card and check it.")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--phases", default="parity,main,serve,kernels,lm")
    ap.add_argument("--lm-frames", type=int, default=8192,
                    help="frames of each encoder prefill (lm phase)")
    ap.add_argument("--lm-batch", type=int, default=2,
                    help="encoder prefill batch (lm phase)")
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    # float32 products stay full float32 (no TF32) in every matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)
    build_s = build.build_all()
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a, all sources at once)",
          flush=True)
    report = {"device": name, "nvidia_smi": smi, "build_s": build_s}

    phases = set(args.phases.split(","))
    phase_s = report["phase_s"] = {}

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[phase] = time.perf_counter() - t0
        return out

    if "parity" in phases:
        timed("parity", phase_parity, PARITY_N, PARITY_QUERIES, report)
    kernels = []
    if "main" in phases:
        ctx = timed("main", phase_main, args.n, args.queries, report)
        if "serve" in phases:
            timed("serve", phase_serve, ctx, report)
        if "kernels" in phases:
            kernels = timed("kernels", phase_kernels, ctx, report)
        if "profile" in phases:
            timed("profile", phase_profile, ctx, report)
        # the search path's data leaves the card before the models come
        del ctx
        _free_cuda()
    if "kernels" in phases:
        flash = timed("kernels_flash", flash_kernel_row, args.lm_batch,
                      args.lm_frames)
        print_kernel_row(flash)       # launches: filled in by the lm phase
        kernels.append(flash)
        report["kernels"] = kernels
    if "lm" in phases:
        launches = timed("lm", phase_lm, report, args.lm_frames,
                         args.lm_batch)
        check(launches > 0, "flash_attention was not launched on the "
              "encoder's path")
        for k in kernels:
            if k["name"] == "flash_attention":
                k["launches"] = launches
    report["total_s"] = time.perf_counter() - t_start
    print(f"total {report['total_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()) + ")",
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    # the card's name and power limit again, beside the numbers
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in KERNEL_KEYS}
                                  for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
