#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card and
check it, end to end.

    python3 chip_smoke.py                 # the full run, one card
    python3 chip_smoke.py --n 100000 --queries 200 --phases main,kernels
    python3 chip_smoke.py --phases lm --lm-frames 2048   # model serving
    python3 chip_smoke.py --phases main,serve            # the serving path
    python3 chip_smoke.py --phases main,shard            # the sharded tiers
    python3 chip_smoke.py --phases families    # MoE, RWKV6, Zamba2, LLaVA
    python3 chip_smoke.py --phases train       # training, mesh, ranks
    python3 chip_smoke.py --phases examples    # the example entry points
    python3 chip_smoke.py --phases main,shard,lm,train,cost   # cost counts

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
            executors, each method cold and then warm on the first 250
            queries, and the legacy
            engines (scann_vmapped through the leaf_scan kernel, the vmapped
            graph engine) beside the batched ones.  Kernel launch counts are
            reset just before each of the three paths and read just after.
            Then the paper step (no kernel): Table 2's row (LID, LRC, the
            distance-versus-filter cost), the modeled QPS of every search
            on A and B, the measured miss penalty of every storage run and
            the 9 x 5 workload grid, every cell's bitmaps holding
            max(1, round(sel * n)) rows each
  shard     (after main, on its store, SQ8 shadow, graph, index, workloads
            and truth; kernel launches counted from 0) the mesh-sharded
            tiers with S shards stacked on the card: ShardedGraphExecutor
            in lockstep bit-equal to main's one-shot searches (sweeping at
            S = 1, 2, 4, 8, sweeping_sq8 at 4 and 8, acorn, navix and
            iterative_scan at 4) with S times their frontier launches and
            the modeled scale-out of each S; drift at S = 4, E = 2, 4, 8
            (recall@10 no more than 0.05 above the E before it,
            collective bytes, wall), and at E = 2, 4 card against CPU on
            the parity phase's store (recall within 0.01, counter means
            within 1 %); per-shard pools (S = 1, 4; 200 queries; S = 1
            equal to the unsharded pool); ContinuousServer(64, 8) over 4
            shards bit-equal to the same server over the GraphExecutor
            (128 requests);
            DistributedScannExecutor over main's index at S = 1, 2, 4, 8
            on A and B (recall@10 >= 0.9, hops and index pages S x nsel,
            one leaf_scan call a search) and card against CPU on a 20,000
            x 128 store (the parity phase's); the cost step: the
            sharded search at S = 8 (1,000 queries, A) counted by
            `launch.op_cost` on the card and on meta, equal, its
            all-gather S x Q x k x 8 bytes, the S = 8 QPS beside the
            bound of the counted work on one card; distributed k-means
            (k = 256) S = 4 against S = 1; `python -m
            repro_torch.launch.serve --arch granite-8b --rag`
  serve     (after main, on its store, SQ8 shadow, graph, index and
            workload A; kernel launches counted from 0) the stepped
            frontier driver against main's one-shot searches bit for bit
            (five strategies, chunks of 8; per-lane deadlines against the
            static one); 250 requests at t=0 through serve_queue(fifo, 64)
            and ContinuousServer(64, 8) in both modes, bit-equal, with wall,
            QPS, ticks, slot utilization and the queries a frontier launch
            serves; benchmarks/bench_serving.py's open-loop trace (250
            requests at 0.7 x capacity) in both modes: p50 / p99 ticks,
            goodput; the degradation ladder under tests/test_robustness.py's
            fault plan, served twice, deterministic, every serving rung's
            kernels launched (32 requests: the Python pool replay);
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
            the plain version and the jnp-path prefill), one more prefill
            counted by `op_cost` on the card and on meta (equal; the
            flash charge the reference's structural formula; its own 48
            launches left out of the flash row's); granite-8b's
            ServeEngine, 4 prompts x 64 tokens + 32 greedy (no flash
            launch) and its replay against prefill (2 x 64).  The
            kernel's launches on this path fill its `kernels` row
  families  (after lm, the card freed between models) the other LM
            families: smoke models, f32, card against CPU (greedy tokens,
            4 x 24 + 16, equal for granite-moe, kimi-k2, rwkv6 scan and
            chunked, zamba2; llava's prefill with 16 patch embeddings
            within LM_SMOKE_TOL); then at the published widths:
            granite-moe-1b-a400m's ServeEngine 4 x 64 + 32 (prefill
            tokens/s, ms a step, peak memory, 4 profiled steps) and its
            replay against prefill at capacity_factor = n_experts (2 x 64);
            kimi-k2-1t-a32b cut to 1 layer (bf16, ~39 GB): a 1 x 256
            prefill and 8 decode steps; rwkv6-3b's and zamba2-1.2b's
            ServeEngine 4 x 64 + 32, their replay against prefill (2 x 64)
            and rwkv6's chunked against scan prefill (4 x 128) held at f32
            compute (SSM_F32) and, cut to 2 layers, at bf16;
            llava-next-mistral-7b's prefill of 2,880 patch embeddings + 128
            tokens and 16 text-only decode steps.  No decoder launches the
            flash kernel
  train     (after families) training, no hand kernel on its path (the
            launch and route counts must not move): every architecture's
            smoke model trained 4 steps (Trainer.run, f32) on the CPU and
            the card from the same seed-0 weights, and llama3.2-3b with 2
            microbatches and int8 compression, each step's loss and grad
            norm and the final params within max(1e-4, 5 x a one-ulp
            weight move's reading); the crash-at-7, resume-from-6 replay
            (f32 and bf16 AdamW states) allclose to the straight run;
            granite-moe-1b-a400m at its published widths and depth:
            directional derivatives of five parts against central
            differences (f32, 1 x 256, routing held) within 1e-2 and two
            planted faults above it, one step at remat none / dots / full
            (loss bit-equal), 2 x (2 x 512) microbatches against 4 x 512 at
            capacity_factor 32, and 12 steps of 4 x 512 (bf16 compute,
            remat dots, f32 AdamW states): tokens/s, the median step, peak
            memory, the busy share of 2 profiled steps, a falling loss,
            one more step counted by `op_cost` on the card and on meta
            (equal) beside the bound on one card; then the mesh step:
            `launch.train --mesh` on the smoke MoE
            (6 steps; the losses of `--mesh single` and of a crash at
            step 4 under it resumed under `--mesh multi` against the run
            without a mesh, allclose 1e-6), the step-3 checkpoint placed
            by `param_specs` / `opt_specs` on both production meshes
            (every leaf bit-equal to its .npy, on the card), the bytes a
            position of three configs under the specs (arithmetic), and
            granite-moe-1b-a400m at its published widths with the EP
            combine on the single-pod mesh (16 stacked shards of 2
            experts) against the plain combine, 2 steps of 4 x 512 at
            f32 (held: both combines' loss and grad norm from each
            step's params of the plain run within 1e-5; the two runs'
            first step within 1e-5, every step and the final params
            within max(1e-5, 5 x a one-ulp weight move's reading)) and
            at bf16 (recorded): ms a step, peak memory; then the ranks
            step: 4 gloo ranks spawned on the one card, every leaf laid
            out by the partition rules; granite-moe at its published
            widths and depth with the EP combine (and its q / o heads
            split) on a (data 1, model 2) group of two (16 experts held
            a rank), 1 step of 4 x 512 at f32 (its loss and
            grad norm within max(1e-6, 5 x a one-ulp weight move's
            reading) of the stacked (1, 2) step from the same params)
            and at bf16 (recorded), ms a step and peak GiB a rank; then
            (data 2, model 1) and (data 2, model 2) cut to 2 layers at
            f32, 2 steps each, within 1e-5 of the one-process step on the
            global batch from the same params; then granite-8b at its
            published widths with fsdp, cut to 2 layers, on (data 2,
            model 2) at f32 (heads, ffn and vocab over `model`, every
            matrix over `data` too), 2 steps within 1e-5 (loss) and 1e-4
            (grad norm) of the one-process step, each rank's bytes of
            params equal to `per_position_bytes`; and ServeEngine on
            those ranks, 2 x 512 prompt tokens and 16 greedy decode
            steps, token for token the one-process engine's
  examples  (after train) the three example entry points' twins at their
            own shapes: the filtered-search study (12,000 x 128, the 3 x
            3 grid, five methods), RAG serving over
            the sharded ScaNN index (4,096 x 64, two predicates), their
            frontier, distance and leaf-scan launches counted from 0, and
            train_lm for 20 steps
  cost      `python -m repro_torch.launch.dryrun --arch granite-8b
            --shape decode_32k --json` and `python -m
            repro_torch.launch.fvs_dryrun` as subprocesses started beside
            the kernels' build and read after train (exit 0; their
            roofline lines are arithmetic), and the three counted steps
            summed up
  profile   (only when named in --phases) one search per method under
            torch.profiler: the device's busy share and its top kernels

The line before the last is the `kernels` JSON record; the last line is
`{"ok": true, "device": {...}}`.  Any failed check ends the run with a
non-zero exit and no result.  Without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import argparse
import atexit
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
# the H100 SXM's peaks (HBM, FP32 outside the tensor cores, bf16 on them),
# which the dry runs' roofline reads too
from repro_torch.hardware import (PEAK_BF16_PER_S,  # noqa: E402
                                  PEAK_BYTES_PER_S, PEAK_FP32_PER_S)
from repro_torch.measure import (EMPTY_SESSIONS, cuda_ms,  # noqa: E402
                                 device_ms, device_us_by_name, rel_l2)

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

# 32 queries, 200 until the train phase's TP / FSDP run needed the room:
# the CPU sides took ~100 s of the phase's 140 s at 200 on an H100's host,
# and the phase 147 s at 100 on a slower one
PARITY_N, PARITY_QUERIES = 20_000, 32

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


# queries of the storage step: the first 250 of main's 1,000 (all of them
# took 42.2-80.6 s on an H100's host, most of it the Python pool replay;
# cut when the train phase's TP / FSDP run needed the room)
STORAGE_QUERIES = 250


def storage_path(ctx: dict, report: dict, dev="cuda") -> None:
    """Every method with the paged storage engine attached (LRU, half the
    pages), cold and then warm on the same batch (main's first
    STORAGE_QUERIES queries): StorageStats per
    segment, the seconds of the search, of ordering the traces and of the
    pool replay, results equal to the same search without storage,
    measured pages against the counters."""
    from repro_torch.storage import make_storage_engine

    qstore, graph, scann = ctx["qstore"], ctx["graph"], ctx["scann"]
    nq = min(STORAGE_QUERIES, ctx["queries"].shape[0])
    queries = ctx["queries"][:nq]
    (wa, wb), wf = [(wl, bm[:nq], truth[:nq]) for wl, bm, truth
                    in ctx["inputs"]], ctx["family"]
    wf = (wf[0], wf[1][:nq], wf[2][:nq])
    p = main_params()
    engine = make_storage_engine(qstore, scann, graph, capacity_frac=0.5,
                                 policy="lru")
    segs = {k: hi - lo for k, (lo, hi) in engine.segment_ranges().items()}
    print(f"   storage engine: {engine.total_pages} pages {segs}, LRU pool "
          f"of {engine.pool.capacity}; the first {nq} queries", flush=True)
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
                                 "queries": nq, "rows": rows}


def _storage_case(engine, case, spent, qstore, queries, kw, p, dev, kept):
    """One method with storage, cold and then warm: its two report rows;
    each run's (label, mode, StorageStats, queries) goes onto `kept`.
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
        kept.append((label, mode, st, queries.shape[0]))
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


# the witness's ef_search sweep runs on the first 250 of the 1,000
# queries (all of them took ~15 s, ef 1536 9.8 s of it, on an H100's
# host; cut when the train phase's TP / FSDP run needed the room)
WITNESS_SWEEP_QUERIES = 250


def family_witness(ctx: dict, report: dict, dev="cuda") -> None:
    """Why recall is low on the family workload, measured: where the
    queries lie against each family's ball (the rows nearest its centre
    row), `partitioned` at larger ef_search on the first
    WITNESS_SWEEP_QUERIES of the same queries (a sound subgraph approaches
    recall 1), and `partitioned` at the main ef on queries drawn inside
    the balls (midpoints of two rows of the query's family)."""
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
           "ef_sweep": [], "ef_sweep_queries": min(WITNESS_SWEEP_QUERIES,
                                                   nq)}
    ex = make_executor("partitioned", store, partitions=parts, device=dev)
    ns = min(WITNESS_SWEEP_QUERIES, nq)
    for ef in (p.ef_search, 384, 1536):
        pe = dataclasses.replace(p, ef_search=ef,
                                 beam_width=max(ef, p.beam_width),
                                 max_hops=4096)
        t0 = time.perf_counter()
        res = ex.search(queries[:ns], fbm[:ns], pe)
        sync(dev)
        rec = float(recall_at_k(res.ids, ftruth[:ns], p.k).mean())
        hops = float(res.stats.hops.float().mean())
        print(f"   witness F: partitioned ef_search {ef} on the first {ns} "
              f"queries recall {rec:.4f} hops {hops:.1f} wall "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
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
    for label, mode, st, batch in ctx["storage_stats"]:
        v = pen[f"{label} {mode}"] = measured_miss_penalty(st, batch, SYSTEM)
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
# 125 requests, not the bench's 1,000: cut to make room for the train
# phase's ranks steps (1,000 took 41.6 s on an H100, 500 22.9 s; 250
# until the ranks' RWKV6 / Zamba2 runs)
TRACE_LOAD, TRACE_SEED, TRACE_REQUESTS = 0.7, 7, 125
# the FIFO equivalence on main's first 125 queries (1,000 took 36.4 s,
# 500 14.9 s; 250 until the ranks' RWKV6 / Zamba2 runs)
FIFO_REQUESTS = 125
# tests/test_robustness.py's chaos plan, on a pool of a quarter of the
# pages.  16 requests (one dispatch batch), not 1,000: at 1M nearly every
# request faults down the ladder, ~0.4 s a request, 629 s for two runs of
# 1,000 on an H100 (PERF.md); 128 took 108 s of the time limit, 64 57.8 s,
# 32 33.0 s (until the ranks' RWKV6 / Zamba2 runs needed the room)
LADDER_FAULTS = dict(seed=13, read_fail_prob=0.12, max_retries=1,
                     latency_spike_prob=0.05)
LADDER_REQUESTS = 16
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
    """FIFO_REQUESTS sweeping requests at t=0: serve_queue(fifo, 64)
    against ContinuousServer(64, 8) in both modes, ids and dists
    bit-equal."""
    import numpy as np
    from repro_torch.core import GraphExecutor
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousServer, Request, \
        results_in_order
    store, graph = ctx["store"], ctx["graph"]
    nq = min(FIFO_REQUESTS, ctx["queries"].shape[0])
    queries, bm = ctx["queries"][:nq], ctx["inputs"][0][1][:nq]
    p = main_params()
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
# shard: the mesh-sharded tiers on main's store, S shards stacked on the card
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)
SHARD_SQ8_COUNTS = (4, 8)
SHARD_OTHERS = ("acorn", "navix", "iterative_scan")   # at S = 4
SHARD_DRIFT_E = (2, 4, 8)                              # at S = 4
SHARD_STORAGE_QUERIES = 200
SHARD_SERVE_WIDTH = 64
# requests served over 4 shards and over the GraphExecutor: 1,000 took
# 16.0 + 38.5 s on an H100 (PERF.md), the phase's longest step, so the
# check serves the first 64 of A's queries (256, 10.5 s, until the train
# phase's TP / FSDP run needed the room, 128 until its RWKV6 / Zamba2
# runs did)
SHARD_SERVE_REQUESTS = 64
SHARD_KMEANS_K, SHARD_KMEANS_ITERS = 256, 5


def _bit_equal(a, b) -> bool:
    """Two SearchResults equal bit for bit: ids, dists, seven counters."""
    import torch
    return bool(torch.equal(a.ids, b.ids)
                and torch.equal(a.dists.view(torch.int32),
                                b.dists.view(torch.int32))
                and all(torch.equal(getattr(a.stats, c), getattr(b.stats, c))
                        for c in COUNTERS))


def _timed_search(ex, queries, bm, p, dev):
    from repro_torch.kernels import ops
    before = ops.launches()
    sync(dev)
    t0 = time.perf_counter()
    res = ex.search(queries, bm, p)
    sync(dev)
    wall = time.perf_counter() - t0
    after = ops.launches()
    return res, wall, {k: after[k] - before[k] for k in after
                       if after[k] > before[k]}


def shard_lockstep(ctx: dict, out: dict, dev="cuda") -> None:
    """ShardedGraphExecutor(S) in lockstep against main's one-shot search
    bit for bit: sweeping at S in {1, 2, 4, 8}, sweeping_sq8 at 4 and 8,
    acorn / navix / iterative_scan at 4; S times the frontier launches;
    the modeled scale-out of each S."""
    from repro_torch.core import SYSTEM
    from repro_torch.core.costmodel import sharded_cycle_summary
    from repro_torch.core.distributed import ShardedGraphExecutor
    label, bm, truth = ctx["inputs"][0]
    queries, p = ctx["queries"], main_params()
    rows = out["lockstep"] = []
    cases = [("sweeping", S) for S in SHARD_COUNTS]
    cases += [("sweeping_sq8", S) for S in SHARD_SQ8_COUNTS]
    cases += [(m, 4) for m in SHARD_OTHERS]
    for method, S in cases:
        quant = "sq8" if method.endswith("_sq8") else "none"
        strategy = method[:-4] if quant == "sq8" else method
        ex = ShardedGraphExecutor(ctx["graph"], ctx["qstore"], S,
                                  strategy=strategy, graph_quant=quant,
                                  device=dev)
        res, wall, launches = _timed_search(ex, queries, bm, p, dev)
        want = ctx["oneshot"][(label, method)]
        base = next(r for r in ctx["results"]
                    if r["workload"] == label and r["method"] == method)
        kern = "frontier_scan_sq8" if quant == "sq8" else "frontier_scan"
        same = _bit_equal(res, want)
        summary = sharded_cycle_summary(res.stats, res.plan.params,
                                        ctx["store"].dim, S, SYSTEM,
                                        graph_quant=quant)
        row = {"method": method, "shards": S, "wall_s": wall,
               "qps": queries.shape[0] / wall,
               "unsharded_wall_s": base["wall_s"],
               "launches": launches.get(kern, 0),
               "unsharded_launches": base["launches"].get(kern, 0),
               "bit_equal": same, "model": summary}
        rows.append(row)
        print(f"   shard: lockstep {method:14s} S={S} {wall:.3f} s "
              f"(unsharded {base['wall_s']:.3f} s), {kern} launches "
              f"{row['launches']} = {S} x {row['unsharded_launches']}: "
              f"{row['launches'] == S * row['unsharded_launches']}; ids, "
              f"dists, 7 counters bit-equal: {same} | modeled "
              f"{summary['cycles_per_query'] / 1e6:.4f} Mcycles a query, "
              f"collective {summary['collective_bytes']:.1f} B, QPS "
              f"{summary['modeled_qps']:.1f}", flush=True)
        check(same, f"shard: lockstep {method} at S={S} differs from the "
              "unsharded search")
        check(row["launches"] == S * row["unsharded_launches"] > 0,
              f"shard: {method} at S={S} launched {kern} "
              f"{row['launches']} times, not {S} x "
              f"{row['unsharded_launches']}")


def _parity_shard_store(ctx: dict, dev="cuda"):
    """The parity phase's 20,000 x 128 store and 100 queries, remade on the
    card, for the shard phase's card-against-CPU checks."""
    if "shard_parity" not in ctx:
        from repro_torch.data import DatasetSpec, make_dataset
        ctx["shard_parity"] = make_dataset(
            DatasetSpec("parity", PARITY_N, 128, "l2", clusters=128),
            num_queries=PARITY_QUERIES, seed=1, device=dev)
    return ctx["shard_parity"]


def shard_drift(ctx: dict, out: dict, dev="cuda") -> None:
    """Drift at S = 4, E in {2, 4, 8}: recall@10, collective bytes a
    query, wall.  Recall may not rise by more than 0.05 as E grows (the
    reference test's monotone limit) and the search must return real
    neighbors.  The reference test's other limit, recall >= 0.5, holds on
    its 4,000-row fixture at S = 2 (tests/test_torch_sharding.py) but not
    at this scale: the reference's own 1M sweep (BENCH_sharding.json,
    benchmarks/bench_sharding.py) records 0.1375 at S = 4 for every E > 1.
    So drift on the card is also held against drift on the CPU (which
    tests/test_torch_sharding.py holds to the reference bit for bit) on
    the parity phase's store, at S = 4 and E in {2, 4}, to the parity
    phase's tolerances: recall within 0.01, every counter's mean within
    1 %."""
    import dataclasses as dc
    from repro_torch.core import recall_at_k, stats_table_row
    from repro_torch.core.costmodel import beam_exchange_bytes
    from repro_torch.core.distributed import ShardedGraphExecutor
    label, bm, truth = ctx["inputs"][0]
    queries = ctx["queries"]
    ex = ShardedGraphExecutor(ctx["graph"], ctx["qstore"], 4, device=dev)
    prev = float(recall_at_k(ctx["oneshot"][(label, "sweeping")].ids,
                             truth, 10).mean())
    rows = out["drift"] = [{"E": 1, "recall": prev}]
    for E in SHARD_DRIFT_E:
        p = dc.replace(main_params(), beam_exchange_interval=E)
        res, wall, launches = _timed_search(ex, queries, bm, p, dev)
        rec = float(recall_at_k(res.ids, truth, 10).mean())
        cbytes = beam_exchange_bytes(stats_table_row(res.stats),
                                     res.plan.params, 4)
        rows.append({"E": E, "recall": rec, "collective_bytes": cbytes,
                     "wall_s": wall,
                     "launches": launches.get("frontier_scan", 0)})
        print(f"   shard: drift S=4 E={E}: recall@10 {rec:.4f} (E before "
              f"it {prev:.4f}), collective {cbytes:.1f} B a query, wall "
              f"{wall:.3f} s, frontier_scan launches "
              f"{rows[-1]['launches']}", flush=True)
        check(rec <= prev + 0.05 and rec > 0.0,
              f"shard: drift recall {rec} at E={E} rises by more than the "
              f"reference's 0.05 over {prev}, or finds nothing")
        prev = rec
    drift_parity(ctx, out, dev)


def drift_parity(ctx: dict, out: dict, dev="cuda") -> None:
    """Drift at S = 4, E in {2, 4} on the card against the CPU on the
    parity phase's store, its graph built on the card and copied."""
    import dataclasses as dc
    from repro_torch.core import (WorkloadSpec, build_graph_blocked,
                                  filtered_knn, generate_bitmaps,
                                  recall_at_k, to_device)
    from repro_torch.core.distributed import ShardedGraphExecutor
    store, q = _parity_shard_store(ctx, dev)
    graph = build_graph_blocked(store, m=16, ef_construction=32, seed=0,
                                device=dev)
    bm = generate_bitmaps(store, q, WorkloadSpec(0.10, "med_pos"), seed=2,
                          device=dev)
    truth = filtered_knn(to_device(store, "cpu"), q.cpu(), bm.cpu(), 10)[1]
    sides = {"card": ShardedGraphExecutor(graph, store, 4, device=dev),
             "cpu": ShardedGraphExecutor(to_device(graph, "cpu"),
                                         to_device(store, "cpu"), 4,
                                         device="cpu")}
    rows = out["drift_parity"] = []
    for E in (2, 4):
        p = dc.replace(main_params(), beam_exchange_interval=E)
        got = {}
        for side, ex in sides.items():
            on = q.device if side == "card" else "cpu"
            res, wall, _ = _timed_search(ex, q.to(on), bm.to(on), p, on)
            got[side] = (res, float(recall_at_k(res.ids.cpu(), truth,
                                                10).mean()),
                         counter_means(res), wall)
        (rh, rech, ch, th), (rg, recg, cg, tg) = got["cpu"], got["card"]
        worst = max(abs(cg[k] - ch[k]) / max(abs(ch[k]), 1e-9)
                    if ch[k] or cg[k] else 0.0 for k in COUNTERS)
        ids_diff = int((rg.ids.cpu() != rh.ids).sum())
        stats_diff = sum(int((getattr(rg.stats, k).cpu()
                              != getattr(rh.stats, k)).sum())
                         for k in COUNTERS)
        rows.append({"E": E, "recall_card": recg, "recall_cpu": rech,
                     "worst_counter_drift": worst, "ids_differing": ids_diff,
                     "counters_differing": stats_diff, "wall_card_s": tg,
                     "wall_cpu_s": th})
        print(f"   shard: drift S=4 E={E} on the parity phase's {PARITY_N} "
              f"x 128 store: recall@10 card {recg:.4f} CPU {rech:.4f} | "
              f"worst counter drift {worst:.5f} | differing ids {ids_diff}"
              f" counters {stats_diff} | card {tg:.2f} s CPU {th:.1f} s",
              flush=True)
        check(abs(recg - rech) <= 0.01, f"shard: drift E={E} recall on the "
              f"card {recg} vs the CPU {rech}")
        check(worst <= 0.01, f"shard: drift E={E} counters drift {worst} "
              "between the card and the CPU")


def shard_storage(ctx: dict, out: dict, dev="cuda") -> None:
    """Per-shard pools of 0.5 / S of the pages, S in {1, 4}, on 200
    queries of A; at S = 1 the merged StorageStats equal the unsharded
    executor's with the same pool.  Per-shard hit rates."""
    from repro_torch.core import GraphExecutor
    from repro_torch.core.distributed import (ShardedGraphExecutor,
                                              make_sharded_storage)
    from repro_torch.storage import make_storage_engine
    store, graph = ctx["qstore"], ctx["graph"]
    nq = SHARD_STORAGE_QUERIES
    queries, bm = ctx["queries"][:nq], ctx["inputs"][0][1][:nq]
    p = main_params()
    one = make_storage_engine(store, graph=graph, capacity_frac=0.5)
    base = GraphExecutor(graph, store, storage=one).search(queries, bm, p)
    rows = out["storage"] = []
    for S in (1, 4):
        engines = [make_storage_engine(store, graph=graph,
                                       capacity_frac=0.5 / S)
                   for _ in range(S)]
        acct = make_sharded_storage(engines, store.n)
        ex = ShardedGraphExecutor(graph, store, S, storage=acct, device=dev)
        res, wall, _ = _timed_search(ex, queries, bm, p, dev)
        hits = [s.hit_rate for s in acct.last_per_shard]
        row = {"shards": S, "wall_s": wall, "hit_rate": res.storage.hit_rate,
               "per_shard_hit_rate": hits,
               "logical": dict(res.storage.logical),
               "misses": dict(res.storage.misses),
               "bit_equal": _bit_equal(res, base)}
        rows.append(row)
        print(f"   shard: storage S={S}, {nq} queries, pools of 0.5/{S} of "
              f"the pages: wall {wall:.3f} s, hit rate "
              f"{row['hit_rate']:.4f}, per shard "
              f"{[round(h, 4) for h in hits]}, logical {row['logical']}",
              flush=True)
        check(row["bit_equal"], f"shard: storage S={S} changed the search")
        if S == 1:
            same = res.storage.as_dict() == base.storage.as_dict()
            print(f"   shard: storage S=1 merged StorageStats equal the "
                  f"unsharded executor's: {same}", flush=True)
            check(same, "shard: S=1 StorageStats differ from the "
                  "unsharded executor's")


def shard_serving(ctx: dict, out: dict, dev="cuda") -> None:
    """ContinuousServer(64, 8) over ShardedGraphExecutor(4) against the
    same server over the GraphExecutor: SHARD_SERVE_REQUESTS FIFO
    requests, records bit-equal."""
    import numpy as np
    from repro_torch.core import GraphExecutor
    from repro_torch.core.distributed import ShardedGraphExecutor
    from repro_torch.serving import ContinuousServer, Request, \
        results_in_order
    store, graph = ctx["qstore"], ctx["graph"]
    nq = min(SHARD_SERVE_REQUESTS, ctx["queries"].shape[0])
    queries, bm = ctx["queries"][:nq], ctx["inputs"][0][1][:nq]
    p = main_params()
    reqs = [Request(rid=i, query=queries[i], bitmap=bm[i])
            for i in range(nq)]
    got = {}
    for name, ex in (("graph", GraphExecutor(graph, store)),
                     ("sharded4", ShardedGraphExecutor(graph, store, 4,
                                                       device=dev))):
        srv = ContinuousServer(ex, p, width=SHARD_SERVE_WIDTH, hop_chunk=8)
        sync(dev)
        t0 = time.perf_counter()
        recs, info = srv.serve(reqs)
        sync(dev)
        wall = time.perf_counter() - t0
        got[name] = results_in_order(recs, nq, p.k)
        out.setdefault("serving", {})[name] = {
            "wall_s": wall, "qps": nq / wall, "ticks": info["ticks"]}
        print(f"   shard: ContinuousServer({SHARD_SERVE_WIDTH}, 8) over "
              f"{name}: {nq} requests {wall:.3f} s = {nq / wall:.1f} QPS, "
              f"ticks {info['ticks']}", flush=True)
    (ai, ad), (bi, bd) = got["graph"], got["sharded4"]
    same = bool((ai == bi).all() and (ad.view(np.int32)
                                      == bd.view(np.int32)).all())
    out["serving"]["bit_equal"] = same
    print(f"   shard: served records bit-equal: {same}", flush=True)
    check(same, "shard: the server over 4 shards differs from the server "
          "over the GraphExecutor")


def shard_scann(ctx: dict, out: dict, dev="cuda") -> None:
    """shard_index of main's index for S in {1, 2, 4, 8} behind
    DistributedScannExecutor on A and B: recall@10 >= 0.9 (the reference
    test's limit), hops = S * nsel and index pages = S * nsel * pages a
    leaf for every query, leaf_scan called once a search; then card
    against CPU at S = 4 on a 20,000 x 128 store: recall within 0.01."""
    from repro_torch.core import (WorkloadSpec, filtered_knn,
                                  generate_bitmaps, recall_at_k, to_device)
    from repro_torch.core.distributed import (DistributedScannExecutor,
                                              build_sharded_scann,
                                              shard_index)
    from repro_torch.core.scann import _quant_pages_per_leaf
    from repro_torch.launch.mesh import make_mesh
    p = main_params()
    qppl = _quant_pages_per_leaf(ctx["scann"])
    rows = out["scann"] = []
    for S in SHARD_COUNTS:
        sh = shard_index(ctx["scann"], ctx["store"],
                         make_mesh((S,), ("data",)), "data")
        ex = DistributedScannExecutor(sh)
        nsel = min(max(1, -(-p.num_leaves_to_search // S)),
                   sh.index.num_leaves // S)
        for label, bm, truth in ctx["inputs"]:
            res, wall, launches = _timed_search(ex, ctx["queries"], bm, p,
                                                dev)
            rec = float(recall_at_k(res.ids, truth, p.k).mean())
            counts_ok = bool((res.stats.hops == S * nsel).all() and (
                res.stats.page_accesses_index == S * nsel * qppl).all())
            rows.append({"shards": S, "workload": label, "recall": rec,
                         "wall_s": wall,
                         "qps": ctx["queries"].shape[0] / wall,
                         "leaf_scan_calls": launches.get("leaf_scan", 0),
                         "counters_ok": counts_ok})
            print(f"   shard: scann S={S} {label:10s} recall@10 {rec:.4f}"
                  f" wall {wall:.3f} s QPS {rows[-1]['qps']:.1f}, "
                  f"leaf_scan calls {rows[-1]['leaf_scan_calls']}, hops = "
                  f"{S} x {nsel} and index pages = {S} x {nsel} x {qppl}: "
                  f"{counts_ok}", flush=True)
            check(rec >= 0.9, f"shard: scann recall {rec} < 0.9 at S={S}")
            check(counts_ok, f"shard: scann counters at S={S}")
            check(rows[-1]["leaf_scan_calls"] == 1,
                  f"shard: scann at S={S} called leaf_scan "
                  f"{rows[-1]['leaf_scan_calls']} times, not once")
    store, q = _parity_shard_store(ctx, dev)
    mesh = make_mesh((4,), ("data",))
    sh = build_sharded_scann(store, mesh, "data", num_leaves=200, levels=1,
                             seed=0, device=dev)
    bm = generate_bitmaps(store, q, WorkloadSpec(0.10, "med_pos"), seed=10,
                          device=dev)
    _, truth = filtered_knn(store, q, bm, p.k)
    sp = dataclasses.replace(p, num_leaves_to_search=20)
    card = DistributedScannExecutor(sh).search(q, bm, sp)
    cpu_sh = shard_index(to_device(sh.index, "cpu"),
                         to_device(store, "cpu"), mesh, "data")
    cpu = DistributedScannExecutor(cpu_sh).search(q.cpu(), bm.cpu(), sp)
    rc = float(recall_at_k(card.ids, truth, p.k).mean())
    rh = float(recall_at_k(cpu.ids, truth.cpu(), p.k).mean())
    out["scann_parity"] = {"card_recall": rc, "cpu_recall": rh}
    print(f"   shard: scann S=4 on the parity phase's {PARITY_N} x 128 "
          f"store, card recall@10 {rc:.4f}, CPU {rh:.4f}", flush=True)
    check(abs(rc - rh) <= 0.01, "shard: scann card and CPU recalls differ "
          "by more than 0.01")


def shard_cost(ctx: dict, out: dict, dev="cuda") -> None:
    """The sharded ScaNN search at S = COST_SHARDS on main's queries and
    workload A, counted by `op_cost` on the card and on meta (the leaf
    scan charged as its kernel): equal counts, the all-gather S x Q x k x
    8 bytes; shard_scann's measured QPS at that S beside the bound of
    the counted work on one card."""
    from repro_torch.core.distributed import (DistributedScannExecutor,
                                              shard_index)
    from repro_torch.launch.mesh import make_mesh
    p = main_params()
    mesh = make_mesh((COST_SHARDS,), ("data",))
    label, bm, _ = ctx["inputs"][0]
    q = ctx["queries"]

    def search(sh):
        return lambda q_, b_: DistributedScannExecutor(sh).search(
            q_, b_, p).ids
    rec = count_on_both(
        f"sharded ScaNN S={COST_SHARDS}",
        search(shard_index(ctx["scann"], ctx["store"], mesh, "data")),
        (q, bm),
        search(shard_index(_meta(ctx["scann"]), _meta(ctx["store"]), mesh,
                           "data")), (_meta(q), _meta(bm)), dev)
    want = COST_SHARDS * q.shape[0] * p.k * 8.0
    check(rec["collectives"].get("all-gather") == want,
          f"cost: the sharded search's all-gather reads "
          f"{rec['collectives']}, not S x Q x k x 8 = {want}")
    row = next(r for r in out["scann"] if r["shards"] == COST_SHARDS
               and r["workload"] == label)
    b_ms, b_by = bound(rec["bytes"], rec["flops"], PEAK_FP32_PER_S)
    qps_bound = q.shape[0] / b_ms * 1e3
    rec.update(qps=row["qps"], bound_ms=b_ms, bound_by=b_by,
               qps_bound_one_card=qps_bound, share=row["qps"] / qps_bound)
    out["cost"] = rec
    print(f"   cost: sharded ScaNN S={COST_SHARDS}, {q.shape[0]} queries "
          f"on {label}: measured {row['qps']:.1f} QPS, bound on one card "
          f"{rec['qps_bound_one_card']:.1f} QPS ({b_ms:.4f} ms, {b_by}), "
          f"share {rec['share']:.4f}", flush=True)


def shard_kmeans(ctx: dict, out: dict, dev="cuda") -> None:
    """distributed_kmeans on main's 1M rows, k = 256, 5 iterations: S = 4
    within 1e-3 of S = 1."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import distributed_kmeans_fn
    from repro_torch.launch.mesh import make_mesh
    x = ctx["store"].vectors
    pick = np.random.RandomState(0).choice(x.shape[0], SHARD_KMEANS_K,
                                           replace=False)
    init = x[torch.as_tensor(pick, device=x.device)]
    got = {}
    for S in (1, 4):
        fn = distributed_kmeans_fn(make_mesh((S,), ("data",)), "data",
                                   SHARD_KMEANS_K, SHARD_KMEANS_ITERS)
        sync(dev)
        t0 = time.perf_counter()
        got[S] = fn(x, init)
        sync(dev)
        out.setdefault("kmeans", {})[f"wall_s_{S}"] = \
            time.perf_counter() - t0
    err = float((got[4] - got[1]).abs().max())
    out["kmeans"]["max_abs_diff"] = err
    print(f"   shard: distributed_kmeans k={SHARD_KMEANS_K}, "
          f"{SHARD_KMEANS_ITERS} iterations on {x.shape[0]} rows: S=1 "
          f"{out['kmeans']['wall_s_1']:.3f} s, S=4 "
          f"{out['kmeans']['wall_s_4']:.3f} s, max |S=4 - S=1| {err:.3g}",
          flush=True)
    check(err < 1e-3, f"shard: kmeans S=4 is {err} from S=1")


def shard_rag(ctx: dict, out: dict, dev="cuda") -> None:
    """`python -m repro_torch.launch.serve --arch granite-8b --rag` as a
    subprocess: exit 0, every retrieved id passing its bitmap."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", "granite-8b", "--rag"],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    ok = proc.returncode == 0 and \
        "retrieved ids pass their filters: True" in proc.stdout
    out["rag"] = {"wall_s": wall, "returncode": proc.returncode, "ok": ok}
    print(f"   shard: serve --rag exit {proc.returncode} in {wall:.1f} s; "
          f"ids pass their filters: {ok}", flush=True)
    if not ok:
        print(proc.stdout[-2000:] + proc.stderr[-3000:], flush=True)
    check(ok, "shard: serve --rag failed")


def phase_shard(ctx: dict, report: dict, dev="cuda") -> None:
    """The mesh-sharded tiers on main's data, its kernel launches counted
    from 0: lockstep, drift, the sharded storage, serving over shards,
    the sharded ScaNN executor, distributed k-means, serve --rag."""
    from repro_torch.kernels import ops
    print("== shard: the mesh-sharded graph, storage and ScaNN tiers on the "
          "1M store (S shards stacked on one card) ==", flush=True)
    out = report["shard"] = {}
    secs = out["seconds"] = {}
    ctx["results"] = report["main"]["results"]
    ops.reset_launches()
    for name, fn in (("lockstep", shard_lockstep), ("drift", shard_drift),
                     ("storage", shard_storage), ("serving", shard_serving),
                     ("scann", shard_scann), ("cost", shard_cost),
                     ("kmeans", shard_kmeans), ("rag", shard_rag)):
        t0 = time.perf_counter()
        fn(ctx, out, dev)
        secs[name] = time.perf_counter() - t0
    counts = ops.launches()
    out["launches"] = counts
    print(f"   launches on the shard path: {counts}; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    for k in ("frontier_scan", "frontier_scan_sq8", "leaf_scan"):
        check(counts[k] > 0, f"kernel {k} was not launched on the shard "
              "path")


# ---------------------------------------------------------------------------
# mutate: live mutability on the 1M store (WAL, delta tier, tombstones,
# checkpoints, compaction, crash recovery, ingestion while serving)
# ---------------------------------------------------------------------------

MUTATE_DELTA = 8192            # delta_capacity; capacity = base + 4 x delta
MUTATE_BATCH = 512             # rows an insert batch
MUTATE_FILLS = (0.25, 0.5, 0.75, 1.0)
MUTATE_PLANTED = 16
# The graph tier's cut: the exact build_graph that MutableIndex builds,
# compacts and recovers with takes ~102 s at 1M rows on an H100
# (tools_torch/time_graph_build.py, PERF.md), and the phase builds it four
# times (construction, compaction, two recoveries), ~410 s, over the
# phase's budget; so the graph methods run on a MutableIndex over the
# first 25,000 rows of the same store (100,000 until the train phase's
# ranks step needed the room, 50,000 until its TP / FSDP run did),
# bruteforce and ScaNN on all of it
MUTATE_GRAPH_ROWS = 25_000
MUTATE_SERVE_MID_TICK = 20     # the mid-flight insert's tick
# requests of each of the three ingest-serve runs: the first 250 of the
# phase's queries (all 1,000 took 46.2 s for the three on an H100, 500
# 23.1 s and 226 ticks, until the ranks' RWKV6 / Zamba2 runs needed the
# room; the mid-flight insert lands at tick 20)
MUTATE_SERVE_REQUESTS = 250


def _widen(bm, base_words: int, width: int, delta_bits):
    """Workload bitmaps over a base's ids [0, 32 * base_words), widened to
    `width` words: the delta id range [base, base + 4 x delta) takes the
    seeded `delta_bits` words (the same selectivity), the rest zeros."""
    import torch
    out = torch.zeros((bm.shape[0], width), dtype=torch.int32,
                      device=bm.device)
    out[:, :base_words] = bm[:, :base_words]
    out[:, base_words:base_words + delta_bits.shape[1]] = delta_bits
    return out


def _secs(d: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in d.items())


def _merged_row(ix, method, q, bm, p, dev) -> tuple:
    """One merged search and the same method on the base alone (the live
    bitmap clipped to the base), each timed."""
    sync(dev)
    t0 = time.perf_counter()
    res = ix.search(q, bm, dataclasses.replace(p, strategy=method),
                    method=method)
    sync(dev)
    merged_s = time.perf_counter() - t0
    _, base_bm = ix.live_bitmaps(bm)
    sync(dev)
    t0 = time.perf_counter()
    ix._executor(method).search(q, base_bm,
                                dataclasses.replace(p, strategy=method))
    sync(dev)
    return res, merged_s, time.perf_counter() - t0


def _oracle(ix, q, bm, k):
    from repro_torch.core import filtered_knn, rebuild_oracle_store
    store, live = rebuild_oracle_store(ix)
    live_bm, _ = ix.live_bitmaps(bm)
    return filtered_knn(store, q, live_bm & live[None], k)


def _same_bits(a_ids, a_d, b_ids, b_d) -> bool:
    import torch
    return bool(torch.equal(a_ids.to(torch.int32), b_ids.to(torch.int32))
                and torch.equal(a_d.view(torch.int32),
                                b_d.view(torch.int32)))


def _snapshot(tiers, queries, bms, p) -> dict:
    """Every method's merged (ids, dists) on its tier."""
    out = {}
    for tier, (ix, methods) in tiers.items():
        for m in methods:
            r = ix.search(queries, bms[tier],
                          dataclasses.replace(p, strategy=m), method=m)
            out[m] = (r.ids.clone(), r.dists.clone())
    return out


def phase_mutate(ctx: dict, report: dict, dev="cuda") -> None:
    """MutableIndex on main's store: inserts and deletes at four fills of
    the delta tier with merged search against the oracle, a checkpoint, a
    compaction, recovery from two crash points, and ContinuousServer
    ingesting while it serves; kernel launches counted from 0."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import (MutableIndex, bitset_words,
                                  pack_bool_bitmap, recall_at_k)
    from repro_torch.core.costmodel import (should_compact,
                                            write_amplification)
    from repro_torch.kernels import ops
    from repro_torch.measure import device_ms
    from repro_torch.storage import PAGE_BYTES

    store, queries = ctx["store"], ctx["queries"]
    n, nq, dim = store.n, queries.shape[0], store.dim
    graph_rows = min(MUTATE_GRAPH_ROWS, n)
    print(f"== mutate: MutableIndex on the {n} x {dim} store (delta "
          f"capacity {MUTATE_DELTA}, batches of {MUTATE_BATCH}) ==",
          flush=True)
    print(f"   cut: the graph tier (sweeping, sweeping_sq8) runs on the "
          f"first {graph_rows} rows: the exact build_graph is built four "
          f"times in this phase (bruteforce and scann on all {n})",
          flush=True)
    out = report["mutate"] = {"n": n, "graph_rows": graph_rows,
                              "fills": []}
    p = main_params()
    tmp = tempfile.mkdtemp(prefix="mutate_")
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        gen = torch.Generator(device=store.device).manual_seed(21)
        kw = dict(delta_capacity=MUTATE_DELTA, graph_m=16,
                  ef_construction=32, num_leaves=2000, seed=0, device=dev)
        t0 = time.perf_counter()
        big = MutableIndex(store.vectors, f"{tmp}/big.wal", f"{tmp}/big_ck",
                           with_graph=False, with_scann=True, **kw)
        small_base = store.vectors[:graph_rows].clone()
        small = MutableIndex(small_base, f"{tmp}/g.wal", f"{tmp}/g_ck",
                             with_graph=True, with_scann=False, **kw)
        sync(dev)
        out["build_s"] = time.perf_counter() - t0
        out["build_seconds"] = {"base": big.build_seconds,
                                "graph": small.build_seconds}
        print(f"   build {out['build_s']:.1f} s: base "
              f"{_secs(big.build_seconds)}; graph tier "
              f"{_secs(small.build_seconds)}", flush=True)
        tiers = {"base": (big, ("bruteforce", "scann")),
                 "graph": (small, ("sweeping", "sweeping_sq8"))}
        # workload A widened over each index's id space: the delta range
        # takes bits at A's selectivity (0.10), one draw for both indexes
        span = 4 * MUTATE_DELTA
        dbits = pack_bool_bitmap(torch.rand((nq, span), generator=gen,
                                            device=store.device) < 0.10)
        bm_a = ctx["bitmaps"]
        bms = {"base": _widen(bm_a, bitset_words(n), big.words(), dbits),
               "graph": _widen(bm_a, bitset_words(graph_rows),
                               small.words(), dbits)}
        scale = float(store.vectors[:10_000].std())
        ins_s = del_s = 0.0
        ins_rows = del_ids = 0
        deleted = {"base": [], "graph": []}
        rows = None
        for fill in MUTATE_FILLS:
            target = int(fill * MUTATE_DELTA)
            while big.delta.count < target:
                src = torch.randint(0, n, (MUTATE_BATCH,), generator=gen,
                                    device=store.device)
                rows = (store.vectors[src] + 0.05 * scale * torch.randn(
                    (MUTATE_BATCH, dim), generator=gen,
                    device=store.device)).cpu().numpy()
                for ix in (big, small):
                    t0 = time.perf_counter()
                    ix.insert(rows)
                    ins_s += time.perf_counter() - t0
                    ins_rows += MUTATE_BATCH
            for name, (ix, _) in tiers.items():
                nb = max(1, ix.base_n // 1000)
                base_ids = torch.randint(0, ix.base_n, (nb,), generator=gen,
                                         device=store.device).cpu().numpy()
                dl = torch.randint(0, ix.delta.count,
                                   (ix.delta.count // 16,), generator=gen,
                                   device=store.device).cpu().numpy()
                ids = np.concatenate([base_ids, ix.base_n + dl])
                t0 = time.perf_counter()
                ix.delete(ids)
                del_s += time.perf_counter() - t0
                del_ids += ids.size
                deleted[name].append(ids)
            if fill == 0.5:
                t0 = time.perf_counter()
                for ix in (big, small):
                    ix.checkpoint()
                out["checkpoint_s"] = time.perf_counter() - t0
            row = {"fill": fill, "delta_count": big.delta.count,
                   "should_compact": should_compact(
                       big.delta.count, MUTATE_DELTA, big.base_n, dim, 0.10),
                   "methods": {}}
            for name, (ix, methods) in tiers.items():
                od, truth = _oracle(ix, queries, bms[name], p.k)
                dead = torch.as_tensor(np.concatenate(deleted[name]),
                                       device=store.device)
                for m in methods:
                    res, merged_s, base_s = _merged_row(ix, m, queries,
                                                        bms[name], p, dev)
                    rec = float(recall_at_k(res.ids, truth, p.k).mean())
                    hit = bool(torch.isin(res.ids.to(torch.int64),
                                          dead).any())
                    check(not hit, f"mutate: {m} returned a deleted id at "
                          f"fill {fill}")
                    row["methods"][m] = {
                        "recall": rec, "merged_s": merged_s,
                        "merged_qps": nq / merged_s, "base_s": base_s,
                        "base_qps": nq / base_s}
                    if m == "bruteforce":
                        same = _same_bits(truth, od, res.ids, res.dists)
                        row["bruteforce_equals_oracle"] = same
                        check(same, f"mutate: merged bruteforce != oracle "
                              f"at fill {fill}")
            out["fills"].append(row)
            print(f"   fill {fill:.2f} ({row['delta_count']} delta rows, "
                  f"should_compact {row['should_compact']}): "
                  + "; ".join(f"{m} recall {v['recall']:.4f} merged "
                              f"{v['merged_qps']:.1f} QPS base alone "
                              f"{v['base_qps']:.1f}"
                              for m, v in row["methods"].items())
                  + "; bruteforce == oracle bit for bit", flush=True)
        out["insert_rows_per_s"] = ins_rows / ins_s
        out["delete_ids_per_s"] = del_ids / del_s
        print(f"   inserts {ins_rows} rows in {ins_s:.3f} s = "
              f"{out['insert_rows_per_s']:.1f} rows/s; deletes {del_ids} "
              f"ids in {del_s:.3f} s = {out['delete_ids_per_s']:.1f} ids/s "
              f"(WAL append + fsync + apply); checkpoint at fill 0.5 "
              f"{out['checkpoint_s']:.2f} s", flush=True)

        # queries planted on live rows of the last batch rank them first
        # for bruteforce (all-pass bitmaps)
        last = big.base_n + big.delta.count - MUTATE_BATCH
        cand = np.arange(last, last + MUTATE_BATCH)
        want = cand[~big.tombstones.is_dead(cand)][:MUTATE_PLANTED]
        pq = torch.as_tensor(rows[want - last], device=store.device)
        pq = pq + 1e-3 * scale * torch.randn(pq.shape, generator=gen,
                                             device=store.device)
        allpass = torch.full((len(want), big.words()), -1,
                             dtype=torch.int32, device=store.device)
        pres = big.search(pq, allpass, dataclasses.replace(
            p, strategy="bruteforce"))
        check(bool((pres.ids[:, 0].cpu().numpy() == want).all()),
              "mutate: a planted row does not rank first")
        print(f"   {MUTATE_PLANTED} planted rows rank first for bruteforce",
              flush=True)

        # the delta scan alone, at the full tier
        live, _ = big.live_bitmaps(bms["base"])
        dex = big._delta_executor()
        out["delta_scan_ms"] = device_ms(
            lambda: dex.search(queries, live, p), iters=5, warmup=1) \
            if dev == "cuda" else 0.0
        print(f"   delta scan ({nq} queries x {big.delta.count} rows): "
              f"{out['delta_scan_ms']:.4f} ms of device time", flush=True)

        # crash point A: after the last mutation, before compaction
        pre = _snapshot(tiers, queries, bms, p)
        crash_a = {}
        for name, (ix, _) in tiers.items():
            wal_a = ix.wal.crash_copy(f"{tmp}/{name}_a.wal")
            ck_a = f"{tmp}/{name}_ck_a"
            shutil.copytree(ix.ckpt_dir, ck_a)
            crash_a[name] = (wal_a, ck_a)

        for ix in (big, small):
            ix.compact()
        out["compaction_seconds"] = {"base": big.compaction_seconds,
                                     "graph": small.compaction_seconds}
        print(f"   compaction: base {_secs(big.compaction_seconds)}; "
              f"graph tier {_secs(small.compaction_seconds)}", flush=True)
        od, oi = _oracle(big, queries, bms["base"], p.k)
        res = big.search(queries, bms["base"], p)
        check(_same_bits(oi, od, res.ids, res.dists),
              "mutate: bruteforce != oracle after compaction")
        post = _snapshot(tiers, queries, bms, p)
        marker = big.wal.replay()[-1]

        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(f"{tmp}/big_ck")
                         for f in fs)
        recs = {}
        for name, (ix, methods) in tiers.items():
            rkw = dict(kw, with_graph=name == "graph",
                       with_scann=name == "base")
            base = store.vectors if name == "base" else small_base
            mk = ix.wal.replay()[-1]
            wal_b = ix.wal.crash_copy(f"{tmp}/{name}_b.wal",
                                      at_bytes=mk.offset + mk.length // 2)
            for point, (wal, ck), want in (
                    ("after the last insert", crash_a[name], pre),
                    ("inside the COMPACT marker", (wal_b, ix.ckpt_dir),
                     post)):
                t0 = time.perf_counter()
                r = MutableIndex.recover(base, wal, ck, **rkw)
                sync(dev)
                wall = time.perf_counter() - t0
                for m in methods:
                    got = r.search(queries, bms[name],
                                   dataclasses.replace(p, strategy=m),
                                   method=m)
                    check(_same_bits(want[m][0], want[m][1], got.ids,
                                     got.dists),
                          f"mutate: {m} after recovery ({point}) differs "
                          "from the uncrashed index")
                recs[f"{name}: {point}"] = wall
                r.close()
                del r
        out["recovery_s"] = recs
        out["checkpoint_bytes"] = ckpt_bytes
        wal_bytes = big.wal.offset
        out["write_amplification"] = write_amplification(
            big.user_bytes, -(-ckpt_bytes // PAGE_BYTES), wal_bytes)
        out["should_compact_after"] = should_compact(
            big.delta.count, MUTATE_DELTA, big.base_n, dim, 0.10)
        print("   recovery (bit-equal to the uncrashed index, all four "
              "methods): " + ", ".join(f"{k} {v:.2f} s"
                                       for k, v in recs.items())
              + f"; base checkpoint bytes {ckpt_bytes}; COMPACT marker "
              f"{marker.length} bytes at {marker.offset}", flush=True)
        print(f"   write amplification {out['write_amplification']:.4f} "
              f"((WAL {wal_bytes} B + checkpoint pages) / user "
              f"{big.user_bytes} B); should_compact after compaction "
              f"{out['should_compact_after']}", flush=True)
        mutate_serve(small, queries[:MUTATE_SERVE_REQUESTS],
                     bms["graph"][:MUTATE_SERVE_REQUESTS], p, out, dev)
        counts = ops.launches()
        out["launches"] = counts
        if dev == "cuda":
            out["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated()
        print(f"   launches on the mutate path: {counts}; peak device "
              f"memory {out.get('max_memory_allocated_bytes', 0) / 2**30:.3f}"
              " GiB", flush=True)
        for k in ("frontier_scan", "frontier_scan_sq8", "distance_matrix",
                  "leaf_scan_batched"):
            check(counts[k] > 0, f"kernel {k} was not launched on the "
                  "mutate path")
        for ix in (big, small):
            ix.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mutate_serve(ix, queries, bm, p, out: dict, dev="cuda") -> None:
    """ContinuousServer(64, 8) on sweeping over the graph tier: without
    ingestion; with an insert of 512 rows and a delete of 100 ids at tick 0
    and arrivals from tick 1 (every record == MutableIndex.search); with an
    insert mid-flight (each record's delta_count is the tier's at its admit
    tick)."""
    import numpy as np
    import torch
    from repro_torch.core import GraphExecutor
    from repro_torch.serving import ContinuousServer, Request, \
        results_in_order
    from repro_torch.serving.continuous import IngestEvent
    nq = queries.shape[0]
    gen = torch.Generator(device=queries.device).manual_seed(23)
    ex = GraphExecutor(ix.graph, ix.store, strategy="sweeping")
    ps = dataclasses.replace(p, strategy="sweeping")
    rows = out["serve"] = {}

    def serve(name, reqs, **kw):
        srv = ContinuousServer(ex, ps, width=SERVE_WIDTH,
                               hop_chunk=SERVE_HOP_CHUNK, **kw)
        sync(dev)
        t0 = time.perf_counter()
        recs, info = srv.serve(reqs)
        sync(dev)
        wall = time.perf_counter() - t0
        rows[name] = {"wall_s": wall, "qps": nq / wall,
                      "ticks": info["ticks"],
                      "ingest": [info["ingest_inserts"],
                                 info["ingest_deletes"],
                                 info["ingest_rows"]]}
        return recs, info

    live, base = ix.live_bitmaps(bm)
    serve("no ingestion", [Request(rid=i, query=queries[i], bitmap=base[i],
                                   arrival=1) for i in range(nq)])

    def new_rows(m):
        src = torch.randint(0, ix.base_n, (m,), generator=gen,
                            device=queries.device)
        return (ix.store.vectors[src] + 0.01 * torch.randn(
            (m, ix.store.dim), generator=gen,
            device=queries.device)).cpu().numpy()

    dels = torch.randint(0, ix.base_n, (100,), generator=gen,
                         device=queries.device).cpu().numpy()
    events = [IngestEvent(tick=0, kind="insert", rows=new_rows(512)),
              IngestEvent(tick=0, kind="delete", ids=dels)]
    recs, info = serve("ingest at tick 0", [
        Request(rid=i, query=queries[i], bitmap=bm[i], arrival=1)
        for i in range(nq)], index=ix, ingest=events)
    check(info["ingest_inserts"] == 1 and info["ingest_rows"] == 512
          and info["ingest_deletes"] == 1, "mutate: ingest counters")
    ids, dists = results_in_order(recs, nq, p.k)
    want = ix.search(queries, bm, ps, method="sweeping")
    same = bool((want.ids.cpu().numpy() == ids).all() and (
        want.dists.cpu().numpy().view(np.int32) == dists.view(np.int32)
    ).all())
    check(same, "mutate: ingest-serve records differ from "
          "MutableIndex.search")
    check(not np.isin(ids, dels).any(), "mutate: a deleted id was served")
    c0 = ix.delta.count
    recs, _ = serve("insert mid-flight", [
        Request(rid=i, query=queries[i], bitmap=bm[i], arrival=1)
        for i in range(nq)], index=ix, ingest=[IngestEvent(
            tick=MUTATE_SERVE_MID_TICK, kind="insert", rows=new_rows(512))])
    seen = [(r["admit_tick"], r["delta_count"]) for r in recs.values()]
    ok = all(dc == (c0 + 512 if at >= MUTATE_SERVE_MID_TICK else c0)
             for at, dc in seen)
    check(ok, "mutate: a record's delta_count is not the tier's at its "
          "admit tick")
    before = sum(1 for at, _ in seen if at < MUTATE_SERVE_MID_TICK)
    print("   serve (ContinuousServer(64, 8), sweeping, graph tier, "
          f"{nq} requests): " + "; ".join(
              f"{k} {v['wall_s']:.3f} s = {v['qps']:.1f} QPS, ticks "
              f"{v['ticks']}" for k, v in rows.items())
          + f"; records == MutableIndex.search bit for bit; mid-flight: "
          f"{before} admitted before tick {MUTATE_SERVE_MID_TICK} saw "
          f"{c0} delta rows, the rest {c0 + 512}", flush=True)


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
        greedy_card_vs_cpu(cfg, arch, out, dev)


def greedy_card_vs_cpu(cfg, label: str, out: dict, dev="cuda") -> None:
    """One smoke config's ServeEngine, 4 prompts x 24 + 16 greedy tokens,
    on the CPU and on the card with the same weights: the same tokens."""
    import numpy as np
    from repro_torch.models import build_model, params_to
    from repro_torch.serving import ServeEngine

    bundle = build_model(cfg)
    params = bundle.init(0, "cpu")
    prompts = np.random.RandomState(1).randint(0, cfg.vocab, (4, 24))
    toks = {d: ServeEngine(bundle, p, 24 + 16, 4, device=d)
            .generate(prompts, 16)
            for d, p in (("cpu", params), (dev, params_to(params, dev)))}
    same = bool((toks["cpu"] == toks[dev]).all())
    out[f"smoke_{label}_tokens_equal"] = same
    print(f"   smoke {label} greedy tokens (4 x 24 + 16) card == CPU: "
          f"{same}", flush=True)
    check(same, f"smoke {label}: greedy tokens differ card vs CPU")


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
        cost = encoder_cost(bundle, params, x, walls[-1], dev)
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
        "routes": routes, "cost": cost}
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


def encoder_cost(bundle, params, x, prefill_s: float, dev="cuda") -> dict:
    """One flash prefill counted on the card and on meta (the kernel
    charged as the reference charges its pallas_call): equal counts, the
    flash charge n_layers x 4 x B x H x T x hd x S (the lengths padded to
    min(512, T)), its own launches read before and after and left out of
    the flash row's; the measured prefill beside the bound on one card."""
    from repro_torch.kernels import ops
    cfg = bundle.cfg
    before = ops.launches()["flash_attention"]
    rec = count_on_both("encoder prefill", bundle.prefill,
                        (params, {"frames": x}), bundle.prefill,
                        (bundle.init(0, "meta"), {"frames": _meta(x)}), dev)
    own = ops.launches()["flash_attention"] - before
    check(own == cfg.n_layers * (dev == "cuda"),
          f"cost: the counted prefill launched flash {own} times")
    b, t = x.shape[0], x.shape[1]
    tp = t + (-t) % min(512, t)
    want = cfg.n_layers * 4.0 * b * cfg.n_heads * tp * cfg.head_dim * tp
    got = rec["by_class"]["kernel:flash_attention"][0]
    check(got == want, f"cost: the flash charge {got} is not the "
          f"structural formula's {want}")
    b_ms, b_by = bound(rec["bytes"], rec["flops"], PEAK_BF16_PER_S)
    rec.update(prefill_ms=prefill_s * 1e3, bound_ms=b_ms, bound_by=b_by,
               share=b_ms / (prefill_s * 1e3), own_launches=own)
    print(f"   cost: encoder prefill {b} x {t}: measured "
          f"{prefill_s * 1e3:.1f} ms, bound on one card {b_ms:.4f} ms "
          f"({b_by}), share {rec['share']:.4f}; flash charge {got:.6g} "
          f"FLOPs = the structural formula", flush=True)
    return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _timed(fn, *a, dev="cuda"):
    """(fn(*a), its seconds between two synchronizes)."""
    sync(dev)
    t0 = time.perf_counter()
    r = fn(*a)
    sync(dev)
    return r, time.perf_counter() - t0


# the prompt of each decoder's ServeEngine run: the engine replays it
# through the decode path a token a step, so 128 (until the train phase's
# TP / FSDP run needed the room) took 127 of 159 host-bound steps; 64
# until its RWKV6 / Zamba2 runs did
DECODER_PROMPT = 32


def decoder_serving(out: dict, cfg, key: str, batch: int = 4,
                    prompt_len: int = DECODER_PROMPT, new: int = 32,
                    dev="cuda") -> dict:
    """One decoder's ServeEngine at the config's widths: greedy generation
    of `new` tokens for `batch` prompts of `prompt_len`, the prefill and
    each decode step timed to a synchronize; then 4 decode steps under
    the profiler.  The flash kernel must not run.  The replayed prompt's
    logits at its last position against the prefill's are recorded here
    and held by `replay_vs_prefill` (a MoE prefill at its published
    capacity factor drops pairs a one-token step never drops, and the
    RWKV6 and Mamba2 stacks at full depth amplify bf16 rounding past any
    limit: SSM_F32).  Writes and returns out[key]."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

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
            r, sec = _timed(fn, *a, dev=dev)
            spent[kind].append(sec)
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
          f"{cfg.name} launched flash_attention "
          f"{launches['flash_attention']} times")
    check(toks.shape == (batch, new), f"{cfg.name} generated {toks.shape}")
    check(bool((toks >= 0).all() and (toks < cfg.vocab).all()),
          f"{cfg.name}: generated tokens out of range")
    rel = _rel(kept["replay"], kept["prefill"])
    agree = float((kept["replay"].argmax(-1)
                   == kept["prefill"].argmax(-1)).float().mean())
    prof = _profile_decode(bundle, params, batch, prompt_len + new, dev)
    steps = spent["decode"]
    gen_steps = steps[prompt_len:]
    pre_s = spent["prefill"][0]
    ms_step = 1e3 * sum(steps) / len(steps)
    ms_gen = 1e3 * sum(gen_steps) / max(len(gen_steps), 1)
    rec = out[key] = {
        "config": cfg.name, "params": n_params, "batch": batch,
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
    print(f"   {key} {cfg.name} ({n_params / 1e9:.3f} B params, "
          f"{cfg.param_dtype} weights, {cfg.compute_dtype} compute, init "
          f"{init_s:.1f} s): {batch} x {prompt_len} prompt + {new} greedy in "
          f"{wall:.2f} s; prefill {pre_s:.3f} s = "
          f"{batch * prompt_len / pre_s:.0f} tokens/s; {len(steps)} decode "
          f"steps at {ms_step:.2f} ms ({ms_gen:.2f} ms a generated step = "
          f"{batch * 1e3 / ms_gen:.1f} tokens/s); peak "
          f"{peak / 2**30:.2f} GiB; flash launches "
          f"{launches['flash_attention']}", flush=True)
    print(f"   {key} replayed vs prefill logits: relative error {rel:.4f}, "
          f"argmax agreement {agree:.3f} (recorded)", flush=True)
    return rec


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
        # device activity only, as the train phase profiles: with the
        # host ops' events too, a model's serving step ran 10-19 s past
        # its generation on an H100's host, most of it post-processing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pos in range(1, 5):
                bundle.decode(params, cache, {"tokens": tok}, pos)
            sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    per_name = device_us_by_name(prof, averages)
    dev_ms = sum(per_name.values()) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    # device kernels and copies run, a step
    from torch.autograd import DeviceType
    per_step = sum(e.count for e in averages
                   if e.device_type == DeviceType.CUDA) / 4
    out = {"wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms, "device_items_a_step": per_step,
           "top": [(k[:80], v / 1e3) for k, v in top]}
    print(f"   {bundle.cfg.name}, 4 decode steps profiled: wall "
          f"{wall_ms:.1f} ms, "
          f"device {dev_ms:.1f} ms (busy {dev_ms / wall_ms:.3f}), "
          f"{per_step:.0f} device items a step; top: "
          + "; ".join(f"{k[:50]} {v / 1e3:.1f} ms" for k, v in top[:5]),
          flush=True)
    return out


def phase_lm(report: dict, frames: int, batch: int, dev="cuda") -> int:
    """The model-serving path; returns the flash launches of its encoder
    prefills (the kernel's launches on the main path)."""
    import torch
    from repro_torch import configs as C
    print(f"== lm: model serving at full width ({batch} x {frames} frames; "
          f"granite-8b 4 x {DECODER_PROMPT} + 32) ==", flush=True)
    out = report["lm"] = {}
    lm_smoke_parity(out, dev)
    launches = encoder_serving(out, frames, batch, dev)
    _free_cuda(dev)
    granite = C.get_config("granite-8b")
    with torch.inference_mode():
        decoder_serving(out, granite, "decoder", dev=dev)
        _free_cuda(dev)
        replay_vs_prefill(granite, out, "decoder_replay", 2, 64, dev)
    _free_cuda(dev)
    return launches


# the smoke-size decoders of the families phase held card against CPU:
# (arch, rwkv_mode or None)
FAMILY_SMOKE = (("granite-moe-1b-a400m", None), ("kimi-k2-1t-a32b", None),
                ("rwkv6-3b", "scan"), ("rwkv6-3b", "chunked"),
                ("zamba2-1.2b", None))
# kimi-k2 at its published widths, cut to 1 of its 61 layers: one layer's
# bf16 experts are ~34 GB and the embeddings ~4.7 GB, so the full depth
# needs more than one card
KIMI_LAYERS, KIMI_PROMPT, KIMI_STEPS = 1, 256, 8
# llava: 2,880 patch embeddings (the config's anyres prefix) + this many
# text tokens, then text-only decode steps on a fresh cache
LLAVA_TEXT, LLAVA_STEPS = 128, 16
# patch embeddings at the token table's scale (its init std)
PATCH_STD = 0.02
# The RWKV6 and Mamba2 stacks with random weights amplify a difference in
# their input over their depth: in bf16 the scan and chunked forms, and a
# prefill and its token-by-token replay, round differently in every layer,
# and at d 512 the reference's own two-path readings grow from ~0.009 at 2
# layers to 0.29 (rwkv6, 32 layers) and 0.62 (zamba2, 38 layers), the
# port's alike (CPU, `tests/torch_bf16_study.py --depth`, PERF.md section 6).
# So at full depth the two-path comparisons are held at f32 compute
# (SSM_F32), and at bf16 at a depth cut where the port on the CPU reads
# ~0.01 at the published widths: 2 layers (zamba2's are then its Mamba2
# tail; its shared attention is the dense block granite-8b's replay
# holds).  The bf16 path itself is held against the reference on the CPU
# (`tests/test_torch_bf16_families.py`).
SSM_F32 = "float32"
RWKV6_BF16_LAYERS = ZAMBA2_BF16_LAYERS = 2


def families_smoke(out: dict, dev="cuda") -> None:
    """Smoke-size models, f32, with the same weights on the CPU and the
    card: the decoders' greedy tokens equal; llava's prefill with 16
    seeded patch embeddings within LM_SMOKE_TOL."""
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.models import build_model, params_to

    for arch, mode in FAMILY_SMOKE:
        cfg, label = C.smoke_config(arch), arch
        if mode is not None:
            cfg, label = dataclasses.replace(cfg, rwkv_mode=mode), \
                f"{arch} {mode}"
        greedy_card_vs_cpu(cfg, label, out, dev)
    cfg = C.smoke_config("llava-next-mistral-7b")
    bundle = build_model(cfg)
    params = bundle.init(0, "cpu")
    rng = np.random.RandomState(2)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab, (2, 24))),
             "patch_embeds": torch.as_tensor((rng.randn(
                 2, cfg.num_patches, cfg.d_model) * PATCH_STD).astype(
                     np.float32))}
    want = bundle.prefill(params, batch)
    got = bundle.prefill(params_to(params, dev), params_to(batch, dev)).cpu()
    err = float((got - want).abs().max())
    out["smoke_llava_prefill_max_abs_err"] = err
    print(f"   smoke llava prefill (2 x 24 tokens, {cfg.num_patches} "
          f"patches, f32): card vs CPU max |err| {err:.3g}", flush=True)
    check(bool(torch.allclose(got, want, rtol=LM_SMOKE_TOL,
                              atol=LM_SMOKE_TOL)),
          f"smoke llava prefill card vs CPU max |err| {err}")


def _seeded_tokens(cfg, batch: int, length: int, dev):
    import numpy as np
    import torch
    return torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab, (batch, length)), dtype=torch.int64, device=dev)


def replay_vs_prefill(cfg, out: dict, key: str, batch: int,
                      prompt_len: int, dev="cuda") -> float:
    """The prefill's last-position logits against the decode path's after
    replaying the same prompts, seed-0 weights, `batch` x `prompt_len`;
    held under LM_REL_TOL.  Writes out[key]."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    bundle = build_model(cfg)
    params = bundle.init(0, dev)
    toks = _seeded_tokens(cfg, batch, prompt_len, dev)
    ops.reset_launches()
    pre = bundle.prefill(params, {"tokens": toks})
    cache = bundle.init_cache(batch, prompt_len, dev)
    for t in range(prompt_len):
        logits, cache = bundle.decode(params, cache,
                                      {"tokens": toks[:, t:t + 1]}, t)
    rel = _rel(logits, pre)
    flash = ops.launches()["flash_attention"]
    cf = f" at capacity_factor {cfg.capacity_factor}" \
        if cfg.family == "moe" else ""
    out[key] = {"config": f"{cfg.name}{cf}, {cfg.n_layers} layers, "
                          f"{cfg.compute_dtype} compute",
                "batch": batch,
                "prompt_len": prompt_len, "rel_err": rel,
                "flash_launches": flash}
    print(f"   {key}: {cfg.name}{cf}, {cfg.n_layers} layers, "
          f"{cfg.compute_dtype} compute, {batch} x {prompt_len}: replayed "
          f"vs prefill logits relative error {rel:.4g} (tolerance "
          f"{LM_REL_TOL})", flush=True)
    check(flash == 0, f"{key}: {flash} flash launches")
    check(rel <= LM_REL_TOL, f"{key}: replayed vs prefill logits relative "
          f"error {rel} > {LM_REL_TOL}")
    return rel


def rwkv_chunked_vs_scan(cfg, out: dict, key: str, batch: int = 4,
                         prompt_len: int = 128, dev="cuda") -> float:
    """rwkv6's chunked prefill against its scan prefill on the same
    seed-0 weights and prompts, each timed to a synchronize; held under
    LM_REL_TOL.  Writes out[key]."""
    from repro_torch.models import build_model

    params = build_model(cfg).init(0, dev)
    toks = _seeded_tokens(cfg, batch, prompt_len, dev)
    logits, walls = {}, {}
    for mode in ("scan", "chunked"):
        bundle = build_model(dataclasses.replace(cfg, rwkv_mode=mode))
        logits[mode], walls[mode] = _timed(bundle.prefill, params,
                                           {"tokens": toks}, dev=dev)
    rel = _rel(logits["chunked"], logits["scan"])
    out[key] = {"config": f"{cfg.name}, {cfg.n_layers} layers, "
                f"{cfg.compute_dtype} compute", "batch": batch,
                "prompt_len": prompt_len, "rel_err": rel,
                "prefill_s": walls}
    print(f"   {key}: {cfg.name} ({cfg.n_layers} layers, "
          f"{cfg.compute_dtype} compute, {batch} x {prompt_len}): chunked "
          f"vs scan prefill relative error {rel:.4g} (tolerance "
          f"{LM_REL_TOL}); scan {walls['scan']:.3f} s, chunked "
          f"{walls['chunked']:.3f} s", flush=True)
    check(rel <= LM_REL_TOL, f"{key}: chunked vs scan prefill relative "
          f"error {rel} > {LM_REL_TOL}")
    return rel


def prefill_and_steps(cfg, out: dict, key: str, batch: dict, steps: int,
                      dev="cuda") -> dict:
    """One model at the config's widths: a prefill of `batch` (timed
    twice), then `steps` greedy text-only decode steps on a fresh cache,
    each timed to a synchronize; prefill tokens/s, ms a step, peak memory.
    No flash launch, finite logits of the right shape."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(int(t.numel()) for t in leaves)
    n_bytes = sum(int(t.numel()) * t.element_size() for t in leaves)
    b, t = batch["tokens"].shape
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    pre_s = []
    for _ in range(2):
        logits, sec = _timed(bundle.prefill, params, batch, dev=dev)
        pre_s.append(sec)
    check(tuple(logits.shape) == (b, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{key}: prefill logits {tuple(logits.shape)} or not finite")
    cache = bundle.init_cache(b, steps, dev)
    tok = logits[:, -1].argmax(-1)[:, None]
    step_s = []
    for pos in range(steps):
        (logits, cache), sec = _timed(bundle.decode, params, cache,
                                      {"tokens": tok}, pos, dev=dev)
        step_s.append(sec)
        tok = logits[:, -1].argmax(-1)[:, None]
    check(bool(torch.isfinite(logits).all()), f"{key}: decode logits not "
          "finite")
    flash = ops.launches()["flash_attention"]
    check(flash == 0, f"{key}: {flash} flash launches")
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    ms = 1e3 * sum(step_s[1:]) / max(len(step_s) - 1, 1)
    rec = out[key] = {
        "config": f"{cfg.name}, {cfg.n_layers} layers", "params": n_params,
        "param_bytes": n_bytes, "init_s": init_s, "batch": b,
        "prefill_len": t, "prefill_s": pre_s,
        "prefill_tokens_per_s": b * t / pre_s[-1], "decode_steps": steps,
        "step_s": step_s, "ms_per_decode_step": ms, "peak_bytes": peak,
        "flash_launches": flash}
    print(f"   {key} {cfg.name} ({cfg.n_layers} layers, {n_params / 1e9:.3f} "
          f"B params, {n_bytes / 2**30:.2f} GiB, init {init_s:.1f} s): "
          f"prefill {b} x {t} {pre_s[0]:.3f} s then {pre_s[1]:.3f} s = "
          f"{b * t / pre_s[-1]:.0f} tokens/s; {steps} decode steps, "
          f"{ms:.2f} ms a step after the first ({1e3 * step_s[0]:.2f}); "
          f"peak {peak / 2**30:.2f} GiB; flash launches {flash}", flush=True)
    return rec


def phase_families(report: dict, dev="cuda") -> None:
    """The MoE, RWKV6, Zamba2 hybrid and LLaVA families: smoke models
    card against CPU, then each model at its published widths (kimi-k2 at
    one layer), the card freed between models."""
    import torch
    from repro_torch import configs as C

    print("== families: MoE, RWKV6, Zamba2, LLaVA at full width ==",
          flush=True)
    out = report["families"] = {}
    step_s = out["step_s"] = {}

    def step(name, fn, *a, **kw):
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn(*a, **kw)
        _free_cuda(dev)
        step_s[name] = time.perf_counter() - t0

    moe = C.get_config("granite-moe-1b-a400m")
    rwkv6 = C.get_config("rwkv6-3b")
    kimi = dataclasses.replace(C.get_config("kimi-k2-1t-a32b"),
                               n_layers=KIMI_LAYERS)
    llava = C.get_config("llava-next-mistral-7b")
    step("smoke", families_smoke, out, dev)
    # the published capacity factor drops pairs in the prefill that a
    # one-token step keeps: replay against prefill at n_experts instead
    step("granite_moe", decoder_serving, out, moe, "granite_moe", dev=dev)
    step("granite_moe_nodrop", replay_vs_prefill, dataclasses.replace(
        moe, capacity_factor=float(moe.n_experts)), out,
        "granite_moe_replay", 2, 64, dev)
    step("kimi_k2", prefill_and_steps, kimi, out, "kimi_k2",
         {"tokens": _seeded_tokens(kimi, 1, KIMI_PROMPT, dev)}, KIMI_STEPS,
         dev)
    zamba2 = C.get_config("zamba2-1.2b")
    rwkv6_f32 = dataclasses.replace(rwkv6, compute_dtype=SSM_F32)
    rwkv6_cut = dataclasses.replace(rwkv6, n_layers=RWKV6_BF16_LAYERS)
    step("rwkv6", decoder_serving, out, rwkv6, "rwkv6", dev=dev)
    step("rwkv6_f32", replay_vs_prefill, rwkv6_f32, out, "rwkv6_replay_f32",
         2, 64, dev)
    step("rwkv6_chunked", rwkv_chunked_vs_scan, rwkv6_f32, out,
         "rwkv6_chunked_vs_scan_f32", dev=dev)
    step("rwkv6_bf16_cut", rwkv_chunked_vs_scan, rwkv6_cut, out,
         "rwkv6_chunked_vs_scan_bf16_cut", dev=dev)
    step("rwkv6_bf16_cut_replay", replay_vs_prefill, rwkv6_cut, out,
         "rwkv6_replay_bf16_cut", 2, 64, dev)
    step("zamba2", decoder_serving, out, zamba2, "zamba2", dev=dev)
    step("zamba2_f32", replay_vs_prefill, dataclasses.replace(
        zamba2, compute_dtype=SSM_F32), out, "zamba2_replay_f32", 2, 64, dev)
    step("zamba2_bf16_cut", replay_vs_prefill, dataclasses.replace(
        zamba2, n_layers=ZAMBA2_BF16_LAYERS), out, "zamba2_replay_bf16_cut",
         2, 64, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    patches = torch.randn((1, llava.num_patches, llava.d_model),
                          device=dev, generator=gen) * PATCH_STD
    step("llava", prefill_and_steps, llava, out, "llava",
         {"tokens": _seeded_tokens(llava, 1, llava.num_patches + LLAVA_TEXT,
                                   dev), "patch_embeds": patches},
         LLAVA_STEPS, dev)
    print("   families steps: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in step_s.items()), flush=True)


# ---------------------------------------------------------------------------
# train: the training path (optim, train, the losses with remat); no hand
# kernel lies on it (the reference's losses never reach a Pallas kernel)
# ---------------------------------------------------------------------------

TRAIN_SMOKE_STEPS = 4
# smoke training, f32, card against CPU from the same weights: each step's
# loss and grad norm, and each final param leaf (relative L2), within
# max(TRAIN_SMOKE_TOL, TRAIN_SMOKE_RATIO x the CPU run's own reading
# against a CPU run from weights moved by one ulp, w (1 + eps_f32 N(0,1))).
# The two sides sum each product and the global norm in another order;
# AdamW divides each element by its own root second moment, which lifts
# an element's relative error over its leaf's.  Some smoke models are
# ill-conditioned at their seed-0 weights: rwkv6-3b's gradient norm
# moves by 6.2e-4 (its `u` 9.6e-4) under that one-ulp move on the CPU,
# and the card reads 6.7e-4 (`u` 1.0e-3); a well-conditioned model's
# one-ulp reading is ~1e-6, so its limit stays TRAIN_SMOKE_TOL
TRAIN_SMOKE_TOL = 1e-4
TRAIN_SMOKE_RATIO = 5.0
# the crash-restart replay against the uninterrupted run (the reference
# test's allclose)
TRAIN_RESTART_ATOL = 1e-6
# granite-moe-1b-a400m at its published widths and depth
TRAIN_FULL_ARCH = "granite-moe-1b-a400m"
TRAIN_FULL_STEPS, TRAIN_FULL_BATCH, TRAIN_FULL_SEQ = 12, 4, 512
TRAIN_FULL_LR, TRAIN_FULL_WARMUP = 3e-4, 2
TRAIN_PROFILED_STEPS = 2
# the directional-derivative check: f32 compute, 1 x 256 tokens, the MoE
# routing of the point held fixed on both sides of it (a top-k or
# capacity choice that flips under the step is a jump of the loss that
# no derivative sees).  A part's direction v is a random r ~ N(0,
# rms(leaf)^2) elementwise plus the part's gradient scaled to |r|: a
# purely random direction's projection on g is ~|g| |v| / sqrt(N) (N up
# to 1.2e9 elements), below the f32 loss's noise floor.  The step eps is
# set so that the first-order change of the loss is GRADCHECK_STEP each
# side (far above f32 noise, ~1e-6, and small enough that the third-order
# term of the central difference stays under 1e-3: at 2 layers on the
# CPU the readings were 2e-5 to 1e-3).  Reading: |FD - <g, v>| /
# max(|FD|, |<g, v>|)
GRADCHECK_TOKENS = 256
GRADCHECK_STEP = 0.01
GRADCHECK_LIMIT = 1e-2
GRADCHECK_PARTS = {
    "embeddings and head": (("embed", "tok"), ("embed", "unembed")),
    "attention": tuple(("layers", "attn", w) for w in
                       ("wq", "wk", "wv", "wo")),
    "router": (("layers", "ffn", "router"),),
    "experts": tuple(("layers", "ffn", w) for w in ("wg", "wu", "wd")),
    "norms": (("embed", "final_norm"), ("layers", "attn", "norm"),
              ("layers", "ffn", "norm")),
}
# one step at each remat mode: the loss bit-equal, the grad norm and the
# updated params within this (the embedding's backward adds with atomics)
TRAIN_REMAT_TOL = 1e-5
# two microbatches of 2 x 512 against one batch of 4 x 512 at
# capacity_factor = n_experts (no pair dropped), bf16 compute
TRAIN_MICRO_TOL = 1e-3


def _train_smoke_config(arch: str):
    from repro_torch import configs as C
    cfg = C.smoke_config(arch)
    if arch == "gemma3-12b":           # two 5:1 groups, the window wraps
        cfg = dataclasses.replace(cfg, n_layers=12, window=8)
    return cfg


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_rel(got, want) -> float:
    """The largest relative L2 error over the leaves."""
    from repro_torch.optim.adamw import tree_leaves
    return max(_rel(a, b.to(a.device)) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))


def _one_ulp(tree, seed: int = 5):
    """Each float leaf times (1 + eps N(0, 1)), eps its dtype's; the
    draws on the leaves' device."""
    import torch
    from repro_torch.optim.adamw import tree_leaves, tree_map
    dev = tree_leaves(tree)[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda t: t * (1 + torch.finfo(t.dtype).eps
                                   * torch.randn(t.shape, generator=gen,
                                                 dtype=t.dtype,
                                                 device=dev)), tree)


def train_card_vs_cpu(cfg, label: str, out: dict, dev="cuda",
                      **train_kw) -> None:
    """TRAIN_SMOKE_STEPS steps of Trainer.run from seed-0 weights made on
    the CPU, on the CPU, on the card and on the CPU from the weights moved
    by one ulp: each step's loss and grad norm and the final params, card
    against CPU, within max(TRAIN_SMOKE_TOL, TRAIN_SMOKE_RATIO x the
    one-ulp run's reading)."""
    from repro_torch.launch.specs import make_smoke_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import init_opt_state

    bundle = build_model(cfg)
    base = bundle.init(0, "cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    tc = TrainConfig(steps=TRAIN_SMOKE_STEPS, log_every=1, **train_kw)
    mb = tc.microbatches
    runs = []
    for d, start in (("cpu", base), (dev, base), ("cpu", _one_ulp(base))):
        def batch_fn(step, d=d):
            b = make_smoke_batch(cfg, 2 * mb, 32, "train", seed=step,
                                 device=d)
            if mb > 1:
                b = {k: v.reshape((mb, 2) + tuple(v.shape[1:]))
                     for k, v in b.items()}
            return b
        tr = Trainer(bundle, opt, tc, batch_fn)
        # a copy on each side: the run writes its params in place
        params = tree_map(lambda t, d=d: t.to(d, copy=True), start)
        params, _ = tr.run(params, init_opt_state(bundle, params, opt, tc))
        runs.append((tr.history, params))

    def readings(got, want):
        (hg, pg), (hw, pw) = got, want
        return (max(abs(a["loss"] / b["loss"] - 1) for a, b in zip(hg, hw)),
                max(abs(a["grad_norm"] / b["grad_norm"] - 1)
                    for a, b in zip(hg, hw)),
                _tree_rel(pg, pw))

    card = readings(runs[1], runs[0])
    ulp = readings(runs[2], runs[0])
    limit = tuple(max(TRAIN_SMOKE_TOL, TRAIN_SMOKE_RATIO * u) for u in ulp)
    hd = runs[1][0]
    names = ("loss", "grad norm", "params")
    out[label] = {"card_vs_cpu": dict(zip(names, card)),
                  "one_ulp_vs_cpu": dict(zip(names, ulp)),
                  "limit": dict(zip(names, limit)),
                  "losses": [h["loss"] for h in hd]}
    print(f"   train smoke {label}: {TRAIN_SMOKE_STEPS} steps card vs CPU "
          + ", ".join(f"{n} {c:.3g} (one ulp {u:.3g}, limit {m:.3g})"
                      for n, c, u, m in zip(names, card, ulp, limit))
          + "; losses " + " ".join(f"{h['loss']:.4f}" for h in hd),
          flush=True)
    check(len(hd) == TRAIN_SMOKE_STEPS and all(
        math.isfinite(h["loss"]) for h in hd), f"train smoke {label}: "
          "a loss is not finite")
    check(all(c <= m for c, m in zip(card, limit)),
          f"train smoke {label}: card vs CPU {card}, limits {limit}")


def train_smoke(out: dict, dev="cuda") -> None:
    from repro_torch import configs as C
    for arch in C.ARCH_IDS:
        train_card_vs_cpu(_train_smoke_config(arch), arch, out, dev)
    train_card_vs_cpu(_train_smoke_config("llama3.2-3b"),
                      "llama3.2-3b microbatches 2, int8 compression", out,
                      dev, microbatches=2, grad_compression=True)


def train_restart(out: dict, dev="cuda") -> None:
    """The reference test's crash-restart replay on the card: 10 steps with
    a checkpoint every 3 straight, against a crash at step 7 and a resume
    from step 6; f32 and bf16 optimizer states."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch.specs import make_smoke_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, Trainer

    cfg = _train_smoke_config("llama3.2-3b")
    bundle = build_model(cfg)

    def batch_fn(step):
        return make_smoke_batch(cfg, 2, 32, "train", seed=step, device=dev)

    root = tempfile.mkdtemp(prefix="train_restart_")
    try:
        for sdt in ("float32", "bfloat16"):
            opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                              state_dtype=sdt)

            def trainer(name):
                return Trainer(bundle, opt, TrainConfig(
                    steps=10, checkpoint_every=3, log_every=100,
                    checkpoint_dir=os.path.join(root, sdt, name)), batch_fn)

            tr = trainer("straight")
            straight, _ = tr.run(*tr.init_or_restore(1, dev)[:2])
            tr = trainer("crash")
            try:
                tr.run(*tr.init_or_restore(1, dev)[:2], fail_at=7)
                crashed = False
            except RuntimeError as e:
                crashed = "injected failure" in str(e)
            tr.ckpt.wait()
            tr = trainer("crash")
            params, state, start = tr.init_or_restore(1, dev)
            check(crashed and start == 6, f"train restart {sdt}: crashed "
                  f"{crashed}, resumed at {start}")
            check(state["adamw"]["m"]["embed"]["tok"].dtype
                  == getattr(torch, sdt), f"train restart {sdt}: states "
                  "restored in another dtype")
            resumed, _ = tr.run(params, state, start)
            pairs = list(zip(tree_leaves(resumed), tree_leaves(straight)))
            close = all(bool(torch.allclose(a, b, atol=TRAIN_RESTART_ATOL))
                        for a, b in pairs)
            equal = all(bool(torch.equal(a, b)) for a, b in pairs)
            worst = max(float((a - b).abs().max()) for a, b in pairs)
            out[f"restart_{sdt}"] = {"allclose": close, "bit_equal": equal,
                                     "max_abs_diff": worst}
            print(f"   train restart ({sdt} states): crash at 7, resume "
                  f"from 6: allclose (atol {TRAIN_RESTART_ATOL}) {close}, "
                  f"bit-equal {equal}, max |diff| {worst:.3g}", flush=True)
            check(close, f"train restart {sdt}: resumed params differ by "
                  f"{worst}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


class _FrozenRouting:
    """Stands in for `layers.moe_route`: records each call's choices (which
    experts, which pairs kept) and, on `replay`, hands them back in the
    same order with the gate values recomputed from the router at the
    current weights, so the loss is a smooth function of the weights
    around the recorded point."""

    def __init__(self, real):
        self.real = real
        self.routes = []
        self.replay = False
        self.at = 0

    def __call__(self, params, x, cfg, groups=32, data=1, seq=None):
        import torch
        from repro_torch.models.layers import rmsnorm
        if not self.replay:
            out = self.real(params, x, cfg, groups, data, seq)
            self.routes.append(out[2:])
            return out
        route, cap = self.routes[self.at]
        self.at += 1
        sorted_e, _, _, _, order = route
        b, t, d = x.shape
        g_ = sorted_e.shape[0]
        xt = rmsnorm(x, params["norm"]).reshape(g_, (b // g_) * t, d)
        probs = torch.softmax(xt.to(torch.float32) @ params["router"],
                              dim=-1)
        sel = torch.empty_like(sorted_e).scatter_(1, order, sorted_e)
        gate = torch.gather(probs, -1, sel.reshape(g_, xt.shape[1], -1))
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return xt, gate, route, cap


def _directional(grads, v) -> float:
    return sum(float((_leaf(grads, path).double() * d.double()).sum())
               for path, d in v.items())


def _derivative_reading(bundle, params, batch, frozen, grads, paths, seed,
                        eps=None) -> dict:
    """<g, v> against the central difference along v (see GRADCHECK_STEP)
    for one part; `eps` None sets the step from <g, v>."""
    import torch
    dev = _leaf(params, paths[0]).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = {}
    for path in paths:
        p = _leaf(params, path)
        scale = float(p.float().pow(2).mean().sqrt())
        v[path] = torch.randn(p.shape, generator=gen, device=dev,
                              dtype=torch.float32) * scale
    r_norm = math.sqrt(sum(float(t.double().pow(2).sum())
                           for t in v.values()))
    g_norm = math.sqrt(sum(float(_leaf(grads, p).double().pow(2).sum())
                           for p in paths))
    if g_norm > 0:
        for p in paths:
            v[p] += _leaf(grads, p) * (r_norm / g_norm)
    an = _directional(grads, v)
    if eps is None:
        eps = GRADCHECK_STEP / abs(an)
    keep = {p: _leaf(params, p).clone() for p in paths}
    side = []
    with torch.no_grad():
        for sign in (1.0, -1.0):
            for p, d in v.items():
                _leaf(params, p).copy_(keep[p] + sign * eps * d)
            frozen.at = 0
            side.append(float(bundle.loss(params, batch)))
        for p in paths:
            _leaf(params, p).copy_(keep[p])
    fd = (side[0] - side[1]) / (2 * eps)
    scale = max(abs(fd), abs(an))
    return {"reading": abs(fd - an) / scale if scale > 0 else 1.0,
            "directional": an, "central_difference": fd, "eps": eps}


def gradient_check(cfg, out: dict, dev="cuda") -> None:
    """<g, v> from autograd against (L(θ + εv) − L(θ − εv)) / 2ε for five
    directions, each confined to one part (GRADCHECK_STEP), at f32
    compute on a 1 x GRADCHECK_TOKENS batch, routing held fixed; then two
    planted faults (the gate detached in the combine, the expert
    gradients halved) must read above GRADCHECK_LIMIT in their parts."""
    import torch
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.models import build_model, layers
    from repro_torch.train.loop import value_and_grad

    cfg = dataclasses.replace(cfg, compute_dtype="float32", remat="none")
    bundle = build_model(cfg)
    params = bundle.init(0, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_for_step(
        DataConfig(cfg.vocab, GRADCHECK_TOKENS, 1), 0).items()}
    frozen = _FrozenRouting(layers.moe_route)
    real_route, real_combine = layers.moe_route, layers._combine
    layers.moe_route = frozen
    try:
        loss, grads = value_and_grad(bundle.loss, params, batch)
        # planted: the gate detached in the combine (the router learns
        # nothing) ...
        layers._combine = lambda vals, w, ok, order, k: real_combine(
            vals, w.detach(), ok, order, k)
        _, detached = value_and_grad(bundle.loss, params, batch)
        layers._combine = real_combine
        # ... and the expert gradients halved
        halved = {"embed": grads["embed"], "layers": {
            "attn": grads["layers"]["attn"],
            "ffn": dict(grads["layers"]["ffn"])}}
        for w in ("wg", "wu", "wd"):
            halved["layers"]["ffn"][w] = grads["layers"]["ffn"][w] * 0.5
        frozen.replay = True
        readings = {}
        for seed, (part, paths) in enumerate(GRADCHECK_PARTS.items()):
            readings[part] = _derivative_reading(bundle, params, batch,
                                                 frozen, grads, paths, seed)
            planted = {"router": ("planted: gate detached", detached),
                       "experts": ("planted: expert grads halved", halved)}
            if part in planted:
                name, faulty = planted[part]
                readings[name] = _derivative_reading(
                    bundle, params, batch, frozen, faulty, paths, seed,
                    eps=readings[part]["eps"])
    finally:
        layers.moe_route, layers._combine = real_route, real_combine
    out["gradient_check"] = {"step": GRADCHECK_STEP,
                             "limit": GRADCHECK_LIMIT, "loss": float(loss),
                             "readings": readings}
    print(f"   gradient check ({cfg.name}, {cfg.n_layers} layers, f32, 1 x "
          f"{GRADCHECK_TOKENS}, routing held, first-order step "
          f"{GRADCHECK_STEP}, limit {GRADCHECK_LIMIT}): " + "; ".join(
              f"{k} {r['reading']:.3g} (<g,v> {r['directional']:.5g}, FD "
              f"{r['central_difference']:.5g}, eps {r['eps']:.3g})"
              for k, r in readings.items()), flush=True)
    for part, r in readings.items():
        if part.startswith("planted"):
            check(r["reading"] > GRADCHECK_LIMIT, f"gradient check: {part} "
                  f"reads {r['reading']}, within the limit")
        else:
            check(r["reading"] <= GRADCHECK_LIMIT,
                  f"gradient check {part}: {r}")
    del params, grads, detached, halved


def _full_batch(cfg, step: int, batch: int, dev):
    import torch
    from repro_torch.data import DataConfig, batch_for_step
    return {k: torch.as_tensor(v, device=dev) for k, v in batch_for_step(
        DataConfig(cfg.vocab, TRAIN_FULL_SEQ, batch), step).items()}


def remat_check(cfg, out: dict, dev="cuda") -> None:
    """One step from the same params and batch at remat "none", "dots"
    and "full": the loss bit-equal, the grad norm and the updated params
    within TRAIN_REMAT_TOL; the peak memory of each."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import (TrainConfig, init_opt_state,
                                        make_train_step)

    opt, tc = AdamWConfig(lr=TRAIN_FULL_LR, warmup_steps=TRAIN_FULL_WARMUP,
                          total_steps=TRAIN_FULL_STEPS), TrainConfig()
    params = build_model(cfg).init(0, dev)
    state = init_opt_state(None, params, opt, tc)
    batch = _full_batch(cfg, 0, TRAIN_FULL_BATCH, dev)
    rec, base = {}, None
    for mode in ("none", "dots", "full"):
        bundle = build_model(dataclasses.replace(cfg, remat=mode))
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(2):          # the first call, then a warm one
            new = m = None
            step_out, sec = _timed(make_train_step(bundle, opt, tc,
                                                   donate=False),
                                   params, state, batch, dev=dev)
            secs.append(sec)
            new, m = step_out[0], step_out[2]
            del step_out            # the new moments: not compared
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        rec[mode] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "s": secs,
                     "peak_gib": peak / 2**30}
        if base is None:
            base = (m["loss"], float(m["grad_norm"]), new)
        else:
            rec[mode]["loss_bit_equal"] = bool(torch.equal(m["loss"],
                                                           base[0]))
            rec[mode]["grad_norm_rel"] = abs(float(m["grad_norm"])
                                             / base[1] - 1)
            rec[mode]["params_rel"] = _tree_rel(new, base[2])
        del new, m
        _free_cuda(dev)
    out["remat"] = rec
    print("   remat, one step 4 x 512 bf16: " + "; ".join(
        f"{k}: loss {r['loss']:.6f}, {r['s'][0]:.2f} s then "
        f"{r['s'][1]:.2f} s, peak "
        f"{r['peak_gib']:.2f} GiB"
        + (f", loss bit-equal {r['loss_bit_equal']}, grad norm "
           f"{r['grad_norm_rel']:.3g}, params {r['params_rel']:.3g}"
           if "params_rel" in r else "") for k, r in rec.items()),
        flush=True)
    for mode in ("dots", "full"):
        r = rec[mode]
        check(r["loss_bit_equal"] and r["grad_norm_rel"] <= TRAIN_REMAT_TOL
              and r["params_rel"] <= TRAIN_REMAT_TOL,
              f"remat {mode} against none: {r}")
    del params, state, base


def microbatch_check(cfg, out: dict, dev="cuda") -> None:
    """At capacity_factor = n_experts (no pair dropped), two microbatches
    of 2 x 512 against one batch of 4 x 512: the loss within
    TRAIN_MICRO_TOL (bf16 compute); the grad norm recorded."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import (TrainConfig, init_opt_state,
                                        make_train_step)

    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    bundle = build_model(cfg)
    opt = AdamWConfig(lr=TRAIN_FULL_LR, warmup_steps=TRAIN_FULL_WARMUP,
                      total_steps=TRAIN_FULL_STEPS)
    params = bundle.init(0, dev)
    big = _full_batch(cfg, 0, TRAIN_FULL_BATCH, dev)
    metrics = {}
    for micro in (1, 2):
        tc = TrainConfig(microbatches=micro)
        state = init_opt_state(bundle, params, opt, tc)
        batch = big if micro == 1 else {
            k: v.reshape((micro, -1) + tuple(v.shape[1:]))
            for k, v in big.items()}
        _, _, m = make_train_step(bundle, opt, tc, donate=False)(
            params, state, batch)
        metrics[micro] = (float(m["loss"]), float(m["grad_norm"]))
        del state, m
        _free_cuda(dev)
    loss_rel = abs(metrics[2][0] / metrics[1][0] - 1)
    gn_rel = abs(metrics[2][1] / metrics[1][1] - 1)
    out["microbatch"] = {"capacity_factor": cfg.capacity_factor,
                         "loss": metrics, "loss_rel": loss_rel,
                         "grad_norm_rel": gn_rel}
    print(f"   microbatches at capacity_factor {cfg.capacity_factor:g}: "
          f"2 x (2 x 512) loss {metrics[2][0]:.6f} vs 4 x 512 "
          f"{metrics[1][0]:.6f}: relative {loss_rel:.3g} (limit "
          f"{TRAIN_MICRO_TOL}); grad norm {gn_rel:.3g}", flush=True)
    check(loss_rel <= TRAIN_MICRO_TOL, f"microbatches: loss {loss_rel}")
    del params


def train_run(cfg, out: dict, dev="cuda") -> None:
    """TRAIN_FULL_STEPS steps of Trainer.run on batch_for_step batches,
    then TRAIN_PROFILED_STEPS more under torch.profiler: tokens/s, the
    median step, peak memory, the device's busy share; every loss finite
    and the last below the first."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, Trainer

    bundle = build_model(cfg)
    opt = AdamWConfig(lr=TRAIN_FULL_LR, warmup_steps=TRAIN_FULL_WARMUP,
                      total_steps=TRAIN_FULL_STEPS)
    tr = Trainer(bundle, opt, TrainConfig(steps=TRAIN_FULL_STEPS,
                                          log_every=1),
                 lambda step: _full_batch(cfg, step, TRAIN_FULL_BATCH, dev))
    params, state, _ = tr.init_or_restore(0, dev)
    leaves = tree_leaves(params)
    n_params = sum(int(t.numel()) for t in leaves)
    state_bytes = sum(int(t.numel()) * t.element_size()
                      for t in leaves + tree_leaves(state))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (params, state), wall = _timed(tr.run, params, state, dev=dev)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    hist = tr.history
    tokens = TRAIN_FULL_STEPS * TRAIN_FULL_BATCH * TRAIN_FULL_SEQ
    median_ms = 1e3 * statistics.median(h["sec"] for h in hist[2:])
    prof_rec = {}
    batch = _full_batch(cfg, TRAIN_FULL_STEPS, TRAIN_FULL_BATCH, dev)
    if dev == "cuda":
        # device activity only: a step launches ~10^4 kernels, and the
        # host ops' events would multiply the trace's post-processing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRAIN_PROFILED_STEPS):
                params, state, _ = tr.step_fn(params, state, batch)
            sync(dev)
            prof_wall = (time.perf_counter() - t0) * 1e3
        per_name = device_us_by_name(prof)
        dev_ms = sum(per_name.values()) / 1e3
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        check(dev_ms > 0, "train run: the profiler recorded no device "
              "time")
        prof_rec = {"wall_ms": prof_wall, "device_ms": dev_ms,
                    "busy_share": dev_ms / prof_wall,
                    "top": [(k[:80], v / 1e3) for k, v in top]}
    out["cost"] = train_cost(bundle, opt, tr, params, state, batch,
                             median_ms, dev)
    first, last = hist[0], hist[-1]
    out["run"] = {
        "config": f"{cfg.name}, {cfg.n_layers} layers, {cfg.compute_dtype} "
                  f"compute, remat {cfg.remat}, f32 params and AdamW "
                  "states",
        "params": n_params, "state_bytes": state_bytes,
        "batch": f"{TRAIN_FULL_BATCH} x {TRAIN_FULL_SEQ}",
        "steps": TRAIN_FULL_STEPS, "wall_s": wall,
        "tokens_per_s": tokens / wall, "median_step_ms_3_12": median_ms,
        "step_s": [h["sec"] for h in hist], "peak_gib": peak / 2**30,
        "losses": [h["loss"] for h in hist],
        "grad_norms": [h["grad_norm"] for h in hist],
        "profiled": prof_rec}
    print(f"   train run {cfg.name} ({n_params / 1e9:.3f} B params, params "
          f"+ AdamW states {state_bytes / 2**30:.2f} GiB): "
          f"{TRAIN_FULL_STEPS} steps of {TRAIN_FULL_BATCH} x "
          f"{TRAIN_FULL_SEQ} in {wall:.2f} s = {tokens / wall:.0f} "
          f"tokens/s; median step (3-{TRAIN_FULL_STEPS}) {median_ms:.1f} "
          f"ms (first {1e3 * hist[0]['sec']:.1f}); peak {peak / 2**30:.2f} "
          f"GiB; loss {first['loss']:.4f} -> {last['loss']:.4f}, grad norm "
          f"{first['grad_norm']:.3f} -> {last['grad_norm']:.3f}",
          flush=True)
    if prof_rec:
        print(f"   {TRAIN_PROFILED_STEPS} profiled steps: wall "
              f"{prof_rec['wall_ms']:.1f} ms, device "
              f"{prof_rec['device_ms']:.1f} ms (busy "
              f"{prof_rec['busy_share']:.3f}); top: " + "; ".join(
                  f"{k[:50]} {v:.1f} ms" for k, v in prof_rec["top"][:5]),
              flush=True)
    check(all(math.isfinite(h["loss"]) for h in hist)
          and len(hist) == TRAIN_FULL_STEPS,
          f"train run: losses {[h['loss'] for h in hist]}")
    check(last["loss"] < first["loss"], f"train run: the loss went from "
          f"{first['loss']} to {last['loss']}")
    del params, state, tr


def train_cost(bundle, opt, tr, params, state, batch, step_ms: float,
               dev="cuda") -> dict:
    """One training step of the run counted on the card and on meta (the
    run's params, states and batch, and their meta shapes): equal counts;
    the run's median step beside the bound of the counted work on one
    card (bf16 compute)."""
    from repro_torch.train.loop import init_opt_state, make_train_step
    mp = bundle.init(0, "meta")
    ms = init_opt_state(bundle, mp, opt, tr.cfg)
    rec = count_on_both("training step", tr.step_fn, (params, state, batch),
                        make_train_step(bundle, opt, tr.cfg),
                        (mp, ms, _meta(batch)), dev)
    b_ms, b_by = bound(rec["bytes"], rec["flops"], PEAK_BF16_PER_S)
    rec.update(step_ms=step_ms, bound_ms=b_ms, bound_by=b_by,
               share=b_ms / step_ms)
    print(f"   cost: training step: median {step_ms:.1f} ms, bound on one "
          f"card {b_ms:.4f} ms ({b_by}), share {rec['share']:.4f}",
          flush=True)
    return rec


# the mesh step: launch.train --mesh on the smoke MoE (the shipped
# configs leave the EP combine off, so a mesh run is the one-device run),
# a crash under one production mesh resumed under the other, the
# checkpoint laid out by the partition rules, then the EP combine at the
# published widths
MESH_SMOKE_ARGS = ("--arch", "granite-moe-1b-a400m", "--steps", "6",
                   "--batch", "4", "--seq", "64", "--log-every", "1")
MESH_CKPT_EVERY, MESH_FAIL_AT = 3, 4
# granite-moe at its published widths and depth with moe_local_combine on
# the single-pod mesh (model axis 16: 2 experts a stacked shard) against
# the plain combine, 3 steps of 4 x 512 each.  At f32 compute the two
# differ only in the order of the additions.  Held within MESH_EP_TOL:
# at each step of the plain run, the loss and grad norm of both combines
# from that step's params and batch.  The two training runs, each on its
# own combine, part further: AdamW divides each element by its own root
# second moment, which lifts a rounding difference of one step's
# gradient in the next steps' (on an H100 the grad norm of step 3 read
# 1.78e-5 apart, and 1.77e-5 against a plain run from the weights moved
# by one ulp).  So their first step (the same weights on both sides) is
# held within MESH_EP_TOL, and every step and the final params (relative
# L2, the worst leaf) within max(MESH_EP_TOL, TRAIN_SMOKE_RATIO x that
# one-ulp run's reading), the smoke training's rule.  At the published
# bf16 compute each shard's partial rounds to bf16 (CPU, 2 layers,
# 2 x 256: loss 1.3e-4, grad norm 3.4e-3 apart): recorded only
MESH_EP_STEPS = 2              # 3 until the ranks' TP / FSDP run
MESH_EP_TOL = 1e-5
MESH_BYTES_ARCHS = ("granite-moe-1b-a400m", "granite-8b",
                    "kimi-k2-1t-a32b")


def mesh_launcher(out: dict, dev="cuda") -> None:
    """`launch.train.main` on the smoke granite-moe, 6 steps: without a
    mesh, under `--mesh single` (allclose TRAIN_RESTART_ATOL), and killed
    at step 4 under `--mesh single` with a checkpoint every 3, resumed
    under `--mesh multi` (the resumed losses against the uninterrupted
    run's); then the step-3 checkpoint restored with
    `shardings=to_named(param_specs(...))` on both production meshes,
    every leaf bit-equal to its .npy and on the card."""
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import leaf_paths, restore_checkpoint
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, init_opt_state

    def run(*args):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                hist = launch_train.main([*MESH_SMOKE_ARGS, "--device", dev,
                                          *args])
        finally:
            lines = buf.getvalue().splitlines()
        return [h["loss"] for h in hist], [h["step"] for h in hist], lines

    def close(a, b):
        return len(a) == len(b) and bool(np.allclose(
            a, b, rtol=0, atol=TRAIN_RESTART_ATOL))

    root = tempfile.mkdtemp(prefix="mesh_launcher_")
    try:
        straight, _, _ = run()
        single, _, lines = run("--mesh", "single")
        print("   " + lines[0], flush=True)
        check(lines[0].startswith("mesh data=16 model=16") and close(
            single, straight), f"mesh: --mesh single losses {single} "
              f"against {straight}")
        ck = os.path.join(root, "ck")
        resume = ("--checkpoint-dir", ck, "--checkpoint-every",
                  str(MESH_CKPT_EVERY))
        try:
            run("--mesh", "single", *resume, "--fail-at", str(MESH_FAIL_AT))
            crashed = False
        except RuntimeError as e:
            crashed = "injected failure" in str(e)
        resumed, steps, lines = run("--mesh", "multi", *resume)
        want = straight[MESH_FAIL_AT - 1:]
        worst = max(abs(a - b) for a, b in zip(resumed, want))
        out["launcher"] = {
            "straight": straight, "single": single,
            "single_bit_equal": single == straight, "resumed": resumed,
            "resumed_steps": steps, "resumed_bit_equal": resumed == want,
            "resumed_max_abs_diff": worst}
        print(f"   mesh launcher: smoke {MESH_SMOKE_ARGS[1]} 6 steps, "
              f"--mesh single vs none bit-equal {single == straight}; crash "
              f"at {MESH_FAIL_AT} under single, resumed under multi at "
              f"steps {steps}: max |diff| {worst:.3g} (bit-equal "
              f"{resumed == want}); {lines[0]}", flush=True)
        check(crashed and steps == list(range(MESH_FAIL_AT, 7))
              and lines[0].startswith("mesh pod=2 data=16 model=16")
              and close(resumed, want), f"mesh: resumed {steps} "
              f"{resumed} against {want}")

        # the step-3 checkpoint laid out by the partition rules
        from repro_torch.configs import smoke_config
        cfg = smoke_config(MESH_SMOKE_ARGS[1])
        bundle = build_model(cfg)
        shapes = bundle.init(0, "meta")
        like = {"params": shapes, "opt": init_opt_state(
            bundle, shapes, AdamWConfig(), TrainConfig())}
        step_dir = os.path.join(ck, f"step_{MESH_CKPT_EVERY:08d}")
        files = {n: np.load(os.path.join(step_dir, n + ".npy"))
                 for n, _ in leaf_paths(like)}
        placed = {}
        for name in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=name == "multi")
            pspec = SH.param_specs(cfg, shapes, mesh)
            shd = {"params": SH.to_named(pspec, mesh),
                   "opt": SH.to_named(SH.opt_specs(cfg, like["opt"], pspec,
                                                   mesh), mesh)}
            tree, _ = restore_checkpoint(ck, MESH_CKPT_EVERY, like,
                                         shardings=shd)
            leaves = leaf_paths(tree)
            equal = sum(t.cpu().numpy().tobytes() == files[n].tobytes()
                        for n, t in leaves)
            on_card = sum(t.device.type == torch.device(dev).type
                          for _, t in leaves)
            split = sum(any(a is not None for a in s.spec)
                        for _, s in leaf_paths(shd))
            placed[name] = {"leaves": len(leaves), "bit_equal": equal,
                            "on_device": on_card, "sharded_specs": split}
            check(equal == on_card == len(leaves) == len(files),
                  f"mesh: placement on {name}: {placed[name]}")
        out["placement"] = placed
        print(f"   mesh placement of the step-{MESH_CKPT_EVERY} checkpoint "
              f"(shardings from param_specs / opt_specs): " + "; ".join(
                  f"{k}: {v['bit_equal']} / {v['leaves']} leaves bit-equal "
                  f"on {dev}, {v['sharded_specs']} specs name an axis"
                  for k, v in placed.items()), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def mesh_ep_combine(cfg, out: dict, dev="cuda") -> None:
    """`cfg` (granite-moe-1b-a400m at its published widths and depth)
    trained MESH_EP_STEPS steps of TRAIN_FULL_BATCH x TRAIN_FULL_SEQ with
    the plain combine and with the EP combine on the single-pod mesh
    (stacked), at f32 and at bf16 compute, and at f32 the plain combine
    from the weights moved by one ulp: loss and grad norm a step, ms a
    step, peak GiB, the final params against the plain run's; first, at
    f32, both combines' loss and grad norm from each step's params of the
    plain run.  f32 held (see MESH_EP_TOL)."""
    import statistics

    import torch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import value_and_grad

    mesh = make_production_mesh()
    opt = AdamWConfig(lr=TRAIN_FULL_LR, warmup_steps=TRAIN_FULL_WARMUP,
                      total_steps=TRAIN_FULL_STEPS)
    rec = out["ep_combine"] = {}

    def train(c, m, ulp=False):
        tr = Trainer(build_model(c, m), opt, TrainConfig(
            steps=MESH_EP_STEPS, log_every=1), lambda step: _full_batch(
                c, step, TRAIN_FULL_BATCH, dev))
        # the peak above what earlier runs still hold (the plain run's
        # params, kept for the comparison)
        held = torch.cuda.memory_allocated() if dev == "cuda" else 0
        params, state, _ = tr.init_or_restore(0, dev)
        if ulp:
            params = _one_ulp(params)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        params, state = tr.run(params, state)
        peak = torch.cuda.max_memory_allocated() - held \
            if dev == "cuda" else 0
        hist = tr.history
        del state, tr
        _free_cuda(dev)
        return params, {"losses": [h["loss"] for h in hist],
                "grad_norms": [h["grad_norm"] for h in hist],
                "step_ms": [1e3 * h["sec"] for h in hist],
                "median_ms_2_on": 1e3 * statistics.median(
                    h["sec"] for h in hist[1:]),
                "peak_gib": peak / 2**30}

    def norm(grads) -> float:
        return math.sqrt(sum(float(torch.sum(torch.square(g.float())))
                             for g in tree_leaves(grads)))

    def same_params(c, ep_c) -> dict:
        """At each step of the plain run, the EP combine's loss and grad
        norm against the plain one's from that step's params and batch."""
        plain_b, ep_b = build_model(c), build_model(ep_c, mesh)
        params = plain_b.init(0, dev)
        state = adamw_init(params, opt)
        got = {"losses": [], "grad_norms": []}
        for step in range(MESH_EP_STEPS):
            batch = _full_batch(c, step, TRAIN_FULL_BATCH, dev)
            le, grads = value_and_grad(ep_b.loss, params, batch)
            ne = norm(grads)
            del grads
            lp, grads = value_and_grad(plain_b.loss, params, batch)
            got["losses"].append(abs(float(le) / float(lp) - 1))
            got["grad_norms"].append(abs(ne / norm(grads) - 1))
            params, state, _ = adamw_update(params, grads, state, opt,
                                            donate=True)
            del grads
        del params, state
        _free_cuda(dev)
        return got

    def rels(got, want):
        (gp, got), (wp, want) = got, want
        out = {k: [abs(a / b - 1) for a, b in zip(got[k], want[k])]
               for k in ("losses", "grad_norms")}
        out["params"] = [_tree_rel(gp, wp)]
        return out

    for compute in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=compute)
        ep_c = dataclasses.replace(c, moe_local_combine=True)
        r = rec[compute] = {}
        if compute == "float32":
            r["same_params"] = same_params(c, ep_c)
            print(f"   mesh EP combine {cfg.name} f32, from each step's "
                  f"params of the plain run: loss rel " + " ".join(
                      f"{x:.3g}" for x in r["same_params"]["losses"])
                  + ", grad norm rel " + " ".join(
                      f"{x:.3g}" for x in r["same_params"]["grad_norms"])
                  + f" (limit {MESH_EP_TOL})", flush=True)
        plain = train(c, None)
        ep = train(ep_c, mesh)
        p, e = plain[1], ep[1]
        r.update({"plain": p, "ep": e, "ep_vs_plain": rels(ep, plain)})
        del ep
        if compute == "float32":
            r["one_ulp_vs_plain"] = rels(train(c, None, ulp=True), plain)
        del plain
        _free_cuda(dev)
        print(f"   mesh EP combine {cfg.name} ({cfg.n_layers} layers, "
              f"{compute} compute, model axis 16: "
              f"{cfg.n_experts // 16} experts a stacked shard), "
              f"{MESH_EP_STEPS} steps of {TRAIN_FULL_BATCH} x "
              f"{TRAIN_FULL_SEQ}: EP vs plain loss rel "
              + " ".join(f"{x:.3g}" for x in r["ep_vs_plain"]["losses"])
              + ", grad norm rel " + " ".join(
                  f"{x:.3g}" for x in r["ep_vs_plain"]["grad_norms"])
              + f", final params rel {r['ep_vs_plain']['params'][0]:.3g}"
              + ("; one ulp vs plain loss rel " + " ".join(
                  f"{x:.3g}" for x in r["one_ulp_vs_plain"]["losses"])
                 + ", grad norm rel " + " ".join(
                  f"{x:.3g}" for x in r["one_ulp_vs_plain"]["grad_norms"])
                 + ", final params rel "
                 f"{r['one_ulp_vs_plain']['params'][0]:.3g}"
                 if "one_ulp_vs_plain" in r else "")
              + f"; ms a step (median of 2-{MESH_EP_STEPS}) plain "
              f"{p['median_ms_2_on']:.1f}, EP {e['median_ms_2_on']:.1f}; "
              f"peak GiB plain {p['peak_gib']:.2f}, EP "
              f"{e['peak_gib']:.2f}; losses plain " + " ".join(
                  f"{x:.4f}" for x in p["losses"]) + ", EP " + " ".join(
                  f"{x:.4f}" for x in e["losses"]), flush=True)
        check(all(math.isfinite(x) for x in e["losses"] + p["losses"]),
              f"mesh EP combine {compute}: a loss is not finite")
    f32 = rec["float32"]
    limit = {k: max(MESH_EP_TOL, TRAIN_SMOKE_RATIO * max(v))
             for k, v in f32["one_ulp_vs_plain"].items()}
    f32["limit"] = limit
    check(all(max(v) <= MESH_EP_TOL for v in f32["same_params"].values()),
          f"mesh EP combine f32, from the same params: "
          f"{f32['same_params']} (limit {MESH_EP_TOL})")
    first = {k: f32["ep_vs_plain"][k][0] for k in ("losses", "grad_norms")}
    check(max(first.values()) <= MESH_EP_TOL,
          f"mesh EP combine f32, first step: {first} (limit {MESH_EP_TOL})")
    check(all(max(v) <= limit[k] for k, v in f32["ep_vs_plain"].items()),
          f"mesh EP combine f32: {f32['ep_vs_plain']}, limits {limit}")


def mesh_spec_bytes(out: dict) -> None:
    """Arithmetic on the shapes, not a measurement: the bytes one
    position of each production mesh would hold of params and AdamW
    states (bf16 states for bf16 params, as the reference's dry run
    chooses) laid out by param_specs / opt_specs."""
    from repro_torch import configs as C
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.loop import TrainConfig, init_opt_state

    rec = out["spec_bytes"] = {}
    for arch in MESH_BYTES_ARCHS:
        cfg = C.get_config(arch)
        bundle = build_model(cfg)
        shapes = bundle.init(0, "meta")
        opt = AdamWConfig(state_dtype="bfloat16" if cfg.param_dtype
                          == "bfloat16" else "float32")
        states = init_opt_state(bundle, shapes, opt, TrainConfig())
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            pspec = SH.param_specs(cfg, shapes, mesh)
            ospec = SH.opt_specs(cfg, states, pspec, mesh)
            whole = sum(t.numel() * t.element_size()
                        for t in tree_leaves(shapes))
            got = {"params_gib": SH.per_position_bytes(
                       shapes, pspec, mesh) / 2**30,
                   "adamw_gib": SH.per_position_bytes(
                       states, ospec, mesh) / 2**30,
                   "params_whole_gib": whole / 2**30}
            key = f"{arch} {'multi' if multi else 'single'}"
            rec[key] = got
            print(f"   spec arithmetic (not a measurement) {key} "
                  f"({mesh.devices.size} positions): params "
                  f"{got['params_gib']:.3f} GiB a position (whole "
                  f"{got['params_whole_gib']:.1f}), AdamW states "
                  f"{got['adamw_gib']:.3f} GiB a position", flush=True)


def mesh_step(cfg, out: dict, dev="cuda") -> None:
    """The mesh step of the train phase; its own hand-kernel launches
    must be 0."""
    from repro_torch.kernels import ops
    rec = out["mesh"] = {}
    before = dict(ops.launches())
    mesh_launcher(rec, dev)
    mesh_spec_bytes(rec)
    mesh_ep_combine(cfg, rec, dev)
    after = dict(ops.launches())
    rec["hand_kernel_launches"] = {k: after[k] - before.get(k, 0)
                                   for k in after}
    check(not any(rec["hand_kernel_launches"].values()),
          f"mesh: hand kernels launched: {rec['hand_kernel_launches']}")


# granite-moe across the ranks of a gloo process group, every rank on
# the one card (NCCL refuses two ranks on one GPU; gloo stages CUDA
# tensors through the host): one spawn of RANKS_WORLD processes.  Ranks
# 0 and 1 (a subgroup) run the published widths and depth with the EP
# combine on a (data 1, model 2) mesh, 16 experts held a rank,
# RANKS_STEPS steps of TRAIN_FULL_BATCH x TRAIN_FULL_SEQ at f32 and at
# bf16 compute (remat "dots"); at f32, before each step, rank 0 also
# computes the stacked (1, 2) EP step's loss and grad norm from the same
# params (the ranks' blocks gathered to it through the host, as a
# checkpoint is), held within
# RANKS_TOL (`mesh_ep_combine`'s `same_params` rule; two runs part by
# AdamW's lift of rounding, see MESH_EP_TOL).  Then (data 2, model 1) on
# the pair and (data 2, model 2, EP) on all four, cut to RANKS_DP_LAYERS
# layers (every gradient crosses the host) at f32 compute (a bf16
# product rounds by the rows a GEMM sees), RANKS_DP_STEPS steps each:
# rank 0 computes the one-process step (no mesh) on the global batch
# from the same params, held within RANKS_DP_TOL.  Every leaf is laid out
# by the partition rules (`rank_specs`): on `model` ranks the q / o heads
# and the vocab split too where they divide it (granite-moe's odd vocab
# of 49,155 stays whole), so the EP pair's ranks add attention partials
# that the stacked step computes in one product: RANKS_TOL is re-derived
# with a control, the stacked step's own loss and grad norm from the
# params moved by one ulp, and the pair held within max(RANKS_TOL,
# TRAIN_SMOKE_RATIO x that control), as MESH_EP_TOL holds the mesh step.
# Then granite-8b at its published widths with fsdp (RANKS_TP_ARCH), cut
# to RANKS_TP_LAYERS of 36 layers, at f32 on (data 2, model 2): every
# weight of attention, the MLP and the embeddings split over `model` and
# `data`, RANKS_TP_STEPS steps against the one-process step from the
# same params (loss within RANKS_DP_TOL, grad norm RANKS_TP_GRAD_TOL);
# then ServeEngine on the same ranks (fresh seed-0 params) prefills
# RANKS_TP_SERVE_BATCH prompts of RANKS_TP_PROMPT tokens and decodes
# RANKS_TP_DECODE greedy steps, token for token the one-process
# engine's.  Every FSDP block crosses the host twice a step (the gather,
# the gradient's all-reduce; with remat "dots" the gather again).  Then
# in the same spawn (RANKS_SSM) rwkv6-3b (d 2,560, 40 heads of 64, d_ff
# 8,960, vocab 65,536) and zamba2-1.2b (d 2,048, d_inner 4,096, 64
# Mamba2 heads, state 64, 32 attention heads, vocab 32,000) at their
# published widths with fsdp, cut to 2 of 32 and to 7 of 38 layers (one
# group of 6 with the shared block, one tail layer), f32 compute, remat
# "dots", on (2, 2), RANKS_SSM_STEPS steps each, and a cut-heads run
# (RANKS_CUT: smoke llama3.2-3b with 6 q heads and 2 kv heads on (1, 4),
# 1.5 heads a rank; no published config cuts a head at 4 ranks): each
# against rank 0's one-process step from the same params, loss within
# RANKS_DP_TOL, grad norm within max(RANKS_TP_GRAD_TOL,
# TRAIN_SMOKE_RATIO x the one-ulp control), as the EP pair is held;
# then the two full-width runs' ServeEngine, as granite-8b's, on
# RANKS_SSM_PROMPT-token prompts and RANKS_SSM_DECODE decode steps.
# Last in the spawn, the `sp` scheme (RANKS_SP): zamba2-1.2b at the same
# 7 layers, f32, on (2, 2) with `sharding_scheme="sp"`: a `model` rank
# holds 256 of the 512 positions, the shared attention gathers K / V and
# masks at the rank's offset, the Mamba2 conv reads the previous rank's
# last 3 positions, the SSD state is handed across the ranks, and every
# dense weight splits over `data`; held as the SSM runs are
RANKS_WORLD = 4
RANKS_STEPS = 1                # 3 before the TP / FSDP run: cut to make room
RANKS_TOL = 1e-6
RANKS_DP_LAYERS, RANKS_DP_STEPS = 2, 1   # 2 steps until the SSM runs
RANKS_DP_TOL = 1e-5
# 2 steps, and serving 2 x 512 + 16, until the SSM runs: cut to make room
RANKS_TP_ARCH, RANKS_TP_LAYERS, RANKS_TP_STEPS = "granite-8b", 2, 1
RANKS_TP_GRAD_TOL = 1e-4
RANKS_TP_SERVE_BATCH, RANKS_TP_PROMPT, RANKS_TP_DECODE = 2, 128, 8
RANKS_SSM = (("rwkv", "rwkv6-3b", 2), ("zamba", "zamba2-1.2b", 7))
RANKS_SSM_STEPS, RANKS_SSM_PROMPT, RANKS_SSM_DECODE = 2, 512, 16
RANKS_CUT = ("llama3.2-3b", {"n_heads": 6, "n_kv": 2}, (1, 4))
RANKS_SP = ("zamba2-1.2b", 7, (2, 2))


def _ranks_run(cfg, mesh, steps: int, dev: str, rank: int,
               reference=None, control: bool = False) -> dict:
    """`steps` steps of `cfg` through `Trainer` on the ranks of `mesh`
    (init from seed 0, placed by `RankLayout`; `step_fn` timed to a
    synchronize, its peak memory a rank; the rank's bytes of params
    beside `per_position_bytes` of the layout); with `reference` (a
    bundle without a mesh or stacked), rank 0 computes its loss and grad
    norm on the global batch from the same params before each step, and
    with `control`, before the last step, also from those params moved by
    one ulp."""
    import statistics

    import torch
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch.sharding import map_leaves, per_position_bytes
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import _global_norm, tree_leaves
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import value_and_grad

    dcfg = DataConfig(cfg.vocab, TRAIN_FULL_SEQ, TRAIN_FULL_BATCH)
    opt = AdamWConfig(lr=TRAIN_FULL_LR, warmup_steps=TRAIN_FULL_WARMUP,
                      total_steps=TRAIN_FULL_STEPS)
    tr = Trainer(build_model(cfg, mesh), opt, TrainConfig(steps=steps),
                 lambda step: batch_for_step(dcfg, step))
    params, state, _ = tr.init_or_restore(0, dev)
    meta = build_model(cfg).init(0, "meta")
    rec = {"held_experts": int(params["layers"]["ffn"]["wg"].shape[-3])
           if cfg.family == "moe" else None, "losses": [],
           "grad_norms": [], "step_ms": [], "peak_gib": [],
           "ref_losses": [], "ref_grad_norms": [], "ctl_losses": [],
           "ctl_grad_norms": [],
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
           "per_position_bytes": per_position_bytes(
               meta, tr.ranks.specs(meta), mesh)}
    for step in range(steps):
        batch = batch_for_step(dcfg, step)
        if reference is not None:
            # the global params on rank 0 only (the checkpoint's gather):
            # every rank holding them whole would move 4x the bytes
            whole = tr.ranks.gather(params)
            if rank == 0:
                whole = map_leaves(lambda _, t: t.to(dev), whole)
                on = {k: torch.as_tensor(v, device=dev)
                      for k, v in batch.items()}
                last = step == steps - 1
                for key in ("ref", "ctl") if control and last else ("ref",):
                    p = whole if key == "ref" else _one_ulp(whole)
                    loss, grads = value_and_grad(reference.loss, p, on)
                    rec[f"{key}_losses"].append(float(loss))
                    rec[f"{key}_grad_norms"].append(float(
                        _global_norm(grads)))
                    del grads, p
            del whole
            _free_cuda(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        params, state, m = tr.step_fn(params, state, batch)
        sync(dev)
        rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30
                               if dev == "cuda" else 0.0)
        rec["losses"].append(float(m["loss"]))
        rec["grad_norms"].append(float(m["grad_norm"]))
    rec["median_ms_2_on"] = statistics.median(rec["step_ms"][1:]
                                              or rec["step_ms"])
    del params, state, tr
    _free_cuda(dev)
    return rec


def _ranks_serve(cfg, mesh, dev: str, rank: int,
                 prompt: int = RANKS_TP_PROMPT,
                 decode: int = RANKS_TP_DECODE) -> dict:
    """Greedy `ServeEngine` tokens on the ranks of `mesh` from seed-0
    params placed by `RankLayout` (the engine gathers the fsdp blocks
    once), and on rank 0 the one-process engine's from the same params:
    RANKS_TP_SERVE_BATCH prompts of `prompt` tokens, the prefill's token
    and `decode` decode steps; seconds to a synchronize."""
    import numpy as np
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.train.ranks import RankLayout

    prompts = np.random.RandomState(29).randint(
        0, cfg.vocab, (RANKS_TP_SERVE_BATCH, prompt))
    new = decode + 1
    kw = dict(max_seq=prompt + new,
              batch_size=RANKS_TP_SERVE_BATCH, device=dev)
    rec = {}
    for key, bundle in (("ranks", build_model(cfg, mesh)),
                        ("one", build_model(cfg))):
        if key == "one" and rank != 0:
            break
        params = build_model(cfg).init(0, dev)
        if key == "ranks":
            params = RankLayout(cfg, mesh).place(params)
            _free_cuda(dev)
        eng = ServeEngine(bundle, params, **kw)
        del params
        sync(dev)
        t0 = time.perf_counter()
        tokens = eng.generate(prompts, new)
        sync(dev)
        rec[f"{key}_s"] = time.perf_counter() - t0
        rec[f"{key}_tokens"] = tokens.tolist()
        del eng
        _free_cuda(dev)
    return rec


def _ranks_warm_up(cfg, dev: str) -> None:
    """One forward and backward of `cfg` on 1 x 64 tokens, no mesh: the
    ranks that wait out the pair's runs load the card's kernels and
    cuBLAS there, not inside their first timed step (without it the
    (2, 2) run's first step read 13.5-15.2 s on an H100, 1.6-1.9 s
    after)."""
    import torch
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.models import build_model
    from repro_torch.train.loop import value_and_grad

    bundle = build_model(cfg)
    params = bundle.init(0, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_for_step(
        DataConfig(cfg.vocab, 64, 1), 0).items()}
    loss, grads = value_and_grad(bundle.loss, params, batch)
    sync(dev)
    del loss, grads, params
    _free_cuda(dev)


def ranks_worker(rank: int, world: int, tmp: str, cfg, tp_cfg, more,
                 dev: str) -> None:
    """One rank of the `ranks` step (spawned; see RANKS_WORLD): writes its
    records to tmp/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    pair = dist.new_group([0, 1])
    out, secs = {}, {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - clock[0]
        clock[0] = now

    try:
        def on(shape, group):
            return dataclasses.replace(
                make_mesh(shape, ("data", "model")), group=group)

        def plain(c):
            """A cut run's one-process reference: remat would recompute
            the same values, so it runs without (the full-width EP pair's
            stacked reference keeps it: its activations would not fit)"""
            return build_model(dataclasses.replace(c, remat="none"))

        ep = dataclasses.replace(cfg, moe_local_combine=True)
        cut = dataclasses.replace(cfg, n_layers=RANKS_DP_LAYERS,
                                  compute_dtype="float32")
        if rank < 2:
            for compute in ("float32", "bfloat16"):
                c = dataclasses.replace(ep, compute_dtype=compute,
                                        remat="dots")
                stacked = build_model(c, on((1, 2), None)) \
                    if compute == "float32" else None
                out[f"full_{compute}"] = _ranks_run(
                    c, on((1, 2), pair), RANKS_STEPS, dev, rank, stacked,
                    control=stacked is not None)
        elif dev == "cuda":
            _ranks_warm_up(cut, dev)
        dist.barrier()
        lap("full")
        if rank < 2:
            out["dp_2x1"] = _ranks_run(cut, on((2, 1), pair),
                                       RANKS_DP_STEPS, dev, rank,
                                       plain(cut))
        dist.barrier()
        lap("dp_2x1")
        cut_ep = dataclasses.replace(cut, moe_local_combine=True)
        out["dp_2x2"] = _ranks_run(cut_ep, on((2, 2), dist.group.WORLD),
                                   RANKS_DP_STEPS, dev, rank,
                                   plain(cut_ep))
        lap("dp_2x2")
        out["tp_fsdp_2x2"] = _ranks_run(tp_cfg, on((2, 2), dist.group.WORLD),
                                        RANKS_TP_STEPS, dev, rank,
                                        plain(tp_cfg))
        lap("tp_fsdp_2x2")
        out["tp_serve"] = _ranks_serve(tp_cfg, on((2, 2), dist.group.WORLD),
                                       dev, rank)
        lap("tp_serve")
        for name, c, shape, serve in more:
            mesh = on(shape, dist.group.WORLD)
            out[name] = _ranks_run(c, mesh, RANKS_SSM_STEPS, dev, rank,
                                   plain(c), control=True)
            lap(name)
            if serve:
                out[f"{name}_serve"] = _ranks_serve(
                    c, mesh, dev, rank, RANKS_SSM_PROMPT, RANKS_SSM_DECODE)
                lap(f"{name}_serve")
        out["seconds"] = secs
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def ranks_step(cfg, out: dict, dev="cuda") -> None:
    """The `ranks` step of the train phase (see RANKS_WORLD): spawns the
    ranks, reads rank 0's records and holds them."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch import configs as C
    rec = out["ranks"] = {}
    tp_cfg = dataclasses.replace(C.get_config(RANKS_TP_ARCH),
                                 n_layers=RANKS_TP_LAYERS,
                                 compute_dtype="float32")
    more = [(f"{name}_fsdp_2x2", dataclasses.replace(
        C.get_config(arch), n_layers=layers, compute_dtype="float32",
        remat="dots", fsdp=True), (2, 2), True)
        for name, arch, layers in RANKS_SSM]
    arch, over, shape = RANKS_CUT
    more.append(("cut_heads_1x4", dataclasses.replace(
        C.smoke_config(arch), **over), shape, False))
    arch, layers, shape = RANKS_SP
    more.append(("zamba_sp_2x2", dataclasses.replace(
        C.get_config(arch), n_layers=layers, compute_dtype="float32",
        remat="dots", sharding_scheme="sp"), shape, False))
    _free_cuda(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(ranks_worker, args=(RANKS_WORLD, tmp, cfg, tp_cfg, more,
                                     dev),
                 nprocs=RANKS_WORLD, join=True)
        rec["spawn_s"] = time.perf_counter() - t0
        runs = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                for r in range(RANKS_WORLD)]
    served = [k for k in runs[0] if k.endswith("_serve")]
    serves = {k: [r.pop(k) for r in runs] for k in served}
    secs = [r.pop("seconds") for r in runs]
    got = runs[0]
    rec.update(got)
    rec.update({k: v[0] for k, v in serves.items()})
    rec["seconds"] = secs[0]
    print(f"   ranks: spawned and joined in {rec['spawn_s']:.1f} s; rank 0's "
          "seconds (each run's init, reference steps, steps and free) "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs[0].items()),
          flush=True)

    def rels(r, a, b):
        return [abs(x / y - 1) for x, y in zip(r[a], r[b])]

    def control(r, kind):
        """The one-ulp control of the last step against its reference."""
        return [abs(x / r[f"ref_{kind}"][-1] - 1) for x in r[f"ctl_{kind}"]]

    f32 = got["full_float32"]
    for name, r in got.items():
        r["loss_rel"] = rels(r, "losses", "ref_losses")
        r["grad_norm_rel"] = rels(r, "grad_norms", "ref_grad_norms")
        print(f"   ranks {name} ({'gloo on one card' if dev == 'cuda' else dev}"
              f", held experts {r['held_experts']}): losses " + " ".join(
                  f"{x:.6f}" for x in r["losses"]) + ", grad norms "
              + " ".join(f"{x:.6f}" for x in r["grad_norms"])
              + (", against the reference from the same params: loss rel "
                 + " ".join(f"{x:.3g}" for x in r["loss_rel"])
                 + ", grad norm rel " + " ".join(
                     f"{x:.3g}" for x in r["grad_norm_rel"])
                 + f" (bit-equal: {r['losses'] == r['ref_losses'] and r['grad_norms'] == r['ref_grad_norms']})"
                 if r["ref_losses"] else " (recorded)")
              + "; ms a step " + " ".join(f"{x:.1f}" for x in r["step_ms"])
              + "; peak GiB a rank " + " ".join(
                  f"{x:.2f}" for x in r["peak_gib"]), flush=True)
        check(all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]),
              f"ranks {name}: a loss or grad norm is not finite")
        for other in runs[1:]:
            if name in other:
                check(other[name]["losses"] == r["losses"],
                      f"ranks {name}: ranks disagree on the loss")
    check(f32["held_experts"] == cfg.n_experts // 2,
          f"ranks: {f32['held_experts']} experts held a rank")
    ctl = control(f32, "losses") + control(f32, "grad_norms")
    limit = f32["limit"] = max(RANKS_TOL, TRAIN_SMOKE_RATIO * max(ctl))
    print(f"   ranks full_float32: the stacked step from the params moved "
          f"by one ulp, loss and grad norm rel " + " ".join(
              f"{x:.3g}" for x in ctl) + f": limit {limit:.3g}", flush=True)
    check(max(f32["loss_rel"] + f32["grad_norm_rel"]) <= limit,
          f"ranks f32 EP against the stacked (1, 2) step: {f32['loss_rel']}"
          f", {f32['grad_norm_rel']} (limit {limit})")
    for name in ("dp_2x1", "dp_2x2"):
        r = got[name]
        check(max(r["loss_rel"] + r["grad_norm_rel"]) <= RANKS_DP_TOL,
              f"ranks {name} against the one-process step: "
              f"{r['loss_rel']}, {r['grad_norm_rel']} (limit {RANKS_DP_TOL})")
    tp = got["tp_fsdp_2x2"]
    for r, run in enumerate(runs):
        mine = run["tp_fsdp_2x2"]
        print(f"   ranks tp_fsdp_2x2 rank {r}: bytes of params "
              f"{mine['param_bytes']:,} (per_position_bytes "
              f"{mine['per_position_bytes']:,}); peak GiB " + " ".join(
                  f"{x:.2f}" for x in mine["peak_gib"]) + "; ms a step "
              + " ".join(f"{x:.1f}" for x in mine["step_ms"]), flush=True)
        check(mine["param_bytes"] == mine["per_position_bytes"],
              f"ranks tp_fsdp_2x2 rank {r}: {mine['param_bytes']} bytes of "
              f"params, the layout gives {mine['per_position_bytes']}")
    check(max(tp["loss_rel"]) <= RANKS_DP_TOL
          and max(tp["grad_norm_rel"]) <= RANKS_TP_GRAD_TOL,
          f"ranks tp_fsdp_2x2 against the one-process step: "
          f"{tp['loss_rel']}, {tp['grad_norm_rel']} (limits {RANKS_DP_TOL}, "
          f"{RANKS_TP_GRAD_TOL})")
    for name, c, shape, _ in more:
        r = got[name]
        ctl = control(r, "grad_norms")
        limit = r["limit"] = max(RANKS_TP_GRAD_TOL,
                                 TRAIN_SMOKE_RATIO * max(ctl))
        print(f"   ranks {name} ({c.name}, {c.n_layers} layers, "
              f"{shape}): bytes of params a rank " + ", ".join(
                  f"{run[name]['param_bytes']:,}" for run in runs)
              + f" (per_position_bytes {r['per_position_bytes']:,}); "
              f"one-ulp control grad norm rel " + " ".join(
                  f"{x:.3g}" for x in ctl) + f": limit {limit:.3g}",
              flush=True)
        for i, run in enumerate(runs):
            check(run[name]["param_bytes"] == run[name]["per_position_bytes"],
                  f"ranks {name} rank {i}: {run[name]['param_bytes']} bytes "
                  f"of params, the layout gives "
                  f"{run[name]['per_position_bytes']}")
        check(max(r["loss_rel"]) <= RANKS_DP_TOL
              and max(r["grad_norm_rel"]) <= limit,
              f"ranks {name} against the one-process step: "
              f"{r['loss_rel']}, {r['grad_norm_rel']} (limits "
              f"{RANKS_DP_TOL}, {limit})")
    for key, runs_of in serves.items():
        s0 = runs_of[0]
        prompt, decode = (RANKS_TP_PROMPT, RANKS_TP_DECODE) \
            if key == "tp_serve" else (RANKS_SSM_PROMPT, RANKS_SSM_DECODE)
        print(f"   ranks {key}: {RANKS_TP_SERVE_BATCH} x {prompt} "
              f"prompt tokens, {decode} greedy decode steps on "
              f"(2, 2) TP / FSDP ranks {s0['ranks_s']:.1f} s, one process "
              f"{s0['one_s']:.1f} s; tokens equal: "
              f"{s0['ranks_tokens'] == s0['one_tokens']}", flush=True)
        check(all(s["ranks_tokens"] == s0["one_tokens"] for s in runs_of),
              f"ranks {key}: the ranks' greedy tokens are not the "
              f"one-process engine's")


def phase_train(report: dict, dev="cuda", full_cfg=None) -> None:
    """Training: smoke models card against CPU (every architecture), the
    crash-restart replay on the card, then granite-moe-1b-a400m at its
    published widths and depth (`full_cfg` stands in for it in a
    rehearsal): the gradient check, remat, microbatches and the training
    run; then the mesh step (`launch.train --mesh`, the elastic restart,
    placement by the partition rules, the EP combine at the published
    widths, the specs' per-position bytes).  No hand kernel may launch on
    the path."""
    from repro_torch import configs as C
    from repro_torch.kernels import ops

    print("== train: AdamW, the losses with remat, the Trainer; "
          f"{TRAIN_FULL_ARCH} at full width ==", flush=True)
    out = report["train"] = {}
    step_s = out["step_s"] = {}
    cfg = C.get_config(TRAIN_FULL_ARCH) if full_cfg is None else full_cfg
    before = (dict(ops.launches()), dict(ops.routes()))

    def step(name, fn, *a, **kw):
        t0 = time.perf_counter()
        fn(*a, **kw)
        _free_cuda(dev)
        step_s[name] = time.perf_counter() - t0

    _free_cuda(dev)
    step("smoke", train_smoke, out, dev)
    step("restart", train_restart, out, dev)
    step("gradient_check", gradient_check, cfg, out, dev)
    step("remat", remat_check, cfg, out, dev)
    step("microbatch", microbatch_check, cfg, out, dev)
    step("run", train_run, cfg, out, dev)
    step("mesh", mesh_step, cfg, out, dev)
    step("ranks", ranks_step, cfg, out, dev)
    after = (dict(ops.launches()), dict(ops.routes()))
    out["hand_kernel_launches"] = {k: after[0][k] - before[0].get(k, 0)
                                   for k in after[0]}
    print("   train steps: " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in step_s.items())
          + f"; hand-kernel launches on the path: "
          f"{sum(out['hand_kernel_launches'].values())}", flush=True)
    check(after == before, f"train: hand kernels launched on the training "
          f"path: {before} -> {after}")


# ---------------------------------------------------------------------------
# examples: the three example entry points' twins at their own shapes
# ---------------------------------------------------------------------------

EXAMPLES_TRAIN_STEPS = 20


def phase_examples(report: dict, dev="cuda") -> None:
    """`repro_torch.filtered_search_study.main` (12,000 x 128, 48
    clusters, the 3 x 3 grid, five methods) and `rag_serving.main`
    (4,096 x 64, two predicates, 12 greedy tokens) at the examples' own
    shapes, their kernel launches counted from 0, and
    `train_lm.main` for EXAMPLES_TRAIN_STEPS steps of 8 x 256 (the
    example's model, a checkpoint every 5 steps)."""
    import tempfile

    from repro_torch import filtered_search_study, rag_serving, train_lm
    from repro_torch.kernels import ops
    print("== examples: the filtered-search study, RAG serving, train_lm "
          "==", flush=True)
    out = report["examples"] = {}
    secs = out["seconds"] = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = filtered_search_study.main(device=dev)
    secs["study"] = time.perf_counter() - t0
    out["study"] = rows
    t0 = time.perf_counter()
    rag = rag_serving.main(device=dev)
    secs["rag"] = time.perf_counter() - t0
    out["rag"] = {"ids": rag["ids"].tolist(),
                  "tokens": rag["tokens"].tolist(),
                  "augmented_len": rag["augmented_len"]}
    counts = ops.launches()
    out["launches"] = counts
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        hist = train_lm.main(device=dev, steps=EXAMPLES_TRAIN_STEPS,
                             checkpoint_dir=ck, log_every=5)
        secs["train_lm"] = time.perf_counter() - t0
    out["train_lm"] = hist
    print(f"   launches on the examples' path: {counts}; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    check(len(rows) == 45 and all(math.isfinite(r["recall"])
                                  and r["sys_qps"] > 0 for r in rows),
          "examples: the study's grid is not whole")
    check({r["method"].split(">")[0] for r in rows}
          == set(filtered_search_study.METHODS)
          and all(0.0 <= r["recall"] <= 1.0 for r in rows),
          "examples: the study's methods or recalls are off")
    check(rag["ids"].shape == (2, 4) and (rag["ids"] >= 0).all(),
          f"examples: RAG ids {rag['ids']}")
    check(len(hist) == EXAMPLES_TRAIN_STEPS // 5
          and all(math.isfinite(h["loss"]) for h in hist),
          f"examples: train_lm history {hist}")
    for k in ("frontier_scan", "distance_matrix"):
        check(counts[k] > 0, f"kernel {k} was not launched on the examples' "
              "path")
    check(counts["leaf_scan_batched"] + counts["leaf_scan"] > 0,
          "no leaf-scan kernel was launched on the examples' path")


# ---------------------------------------------------------------------------
# cost: the op-level cost counter anchored on the card; the dry runs
# ---------------------------------------------------------------------------

COST_SHARDS = 8
COST_RUNS = (("dryrun", ("-m", "repro_torch.launch.dryrun", "--arch",
                         "granite-8b", "--shape", "decode_32k", "--json")),
             ("fvs_dryrun", ("-m", "repro_torch.launch.fvs_dryrun")))


def _meta(x):
    """`x` with each tensor an empty one of its shape and dtype on the
    meta device (through dicts, tuples and dataclasses)."""
    import torch
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_meta(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _meta(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def count_on_both(label: str, card_fn, card_args, meta_fn, meta_args,
                  dev="cuda") -> dict:
    """`op_cost.step_cost` of one step on the card and of the same step on
    meta, hand kernels charged as kernels on both: FLOPs, bytes, each
    class, each collective and the kernel calls must be equal, exactly."""
    from repro_torch.launch import op_cost
    runs = {}
    for where, fn, args in (("card", card_fn, card_args),
                            ("meta", meta_fn, meta_args)):
        counter = op_cost.CostCounter(fused_kernels=True)
        t0 = time.perf_counter()
        total = op_cost.step_cost(fn, *args, counter=counter)
        sync(dev if where == "card" else "cpu")
        runs[where] = {"flops": total.flops, "bytes": total.bytes,
                       "by_class": {k: (c.flops, c.bytes) for k, c in
                                    counter.by_class.items()},
                       "collectives": dict(counter.collectives),
                       "kernel_calls": dict(counter.kernel_calls),
                       "count_s": time.perf_counter() - t0}
    card, meta = runs["card"], runs["meta"]
    same = all(card[k] == meta[k] for k in ("flops", "bytes", "by_class",
                                            "collectives", "kernel_calls"))
    print(f"   cost: {label}: card {card['flops']:.6g} FLOPs "
          f"{card['bytes']:.6g} bytes, meta {meta['flops']:.6g} FLOPs "
          f"{meta['bytes']:.6g} bytes, equal: {same}; collectives "
          f"{card['collectives']}, kernel calls {card['kernel_calls']} "
          f"(counted in {card['count_s']:.1f} s and "
          f"{meta['count_s']:.1f} s)", flush=True)
    check(same, f"cost: {label} is counted differently on the card and on "
          f"meta: {card} against {meta}")
    return dict(card, meta_count_s=meta["count_s"])


def start_cost_runs() -> dict:
    """The dry runs' entry points started as subprocesses, both at once,
    while the kernels build (they run on the meta device and touch no
    card): name -> its process, its output files and its start;
    `phase_cost` reads them and `stop_cost_runs` kills what still runs."""
    import tempfile
    import threading
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}
    t0 = time.perf_counter()
    for name, args in COST_RUNS:
        log, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                                stdout=log, stderr=err, text=True)
        runs[name] = {"proc": proc, "log": log, "err": err, "t0": t0}

        def ended(rec=runs[name]):
            rec["proc"].wait()
            rec["wall_s"] = time.perf_counter() - rec["t0"]
        threading.Thread(target=ended, daemon=True).start()
    return runs


def stop_cost_runs(runs: dict) -> None:
    for rec in runs.values():
        if rec["proc"].poll() is None:
            rec["proc"].kill()
            rec["proc"].wait()


def phase_cost(report: dict, runs: dict) -> None:
    """The dry runs' entry points, run as subprocesses on this machine's
    installation since the build (`start_cost_runs`; exit 0; their
    roofline lines are arithmetic at the H100's constants, not
    measurements), and the counted steps of the shard, lm and train
    phases summed up."""
    print("== cost: the dry runs (arithmetic on the meta device) and the "
          "counted steps ==", flush=True)
    out = report["cost"] = {}
    try:
        for name, run in runs.items():
            proc = run["proc"]
            proc.wait(timeout=600)
            run["log"].seek(0)
            run["err"].seek(0)
            stdout = run["log"].read()
            if proc.returncode:
                print(stdout[-2000:] + run["err"].read()[-3000:], flush=True)
            check(proc.returncode == 0, f"cost: {name} exited "
                  f"{proc.returncode}")
            rec = json.loads(stdout[stdout.index("{"):])
            wall = run.get("wall_s", time.perf_counter() - run["t0"])
            out[name] = {"wall_s": wall, "roofline": rec["roofline"],
                         "collectives": rec["collectives"]}
            print(f"   cost: {name} exit 0 in {wall:.1f} s (started with "
                  f"the build); roofline (arithmetic, not measured): "
                  f"{rec['roofline']}; collectives {rec['collectives']}",
                  flush=True)
    finally:
        stop_cost_runs(runs)
    anchors = {"sharded ScaNN": report.get("shard", {}).get("cost"),
               "encoder prefill": report.get("lm", {}).get(
                   "encoder", {}).get("cost"),
               "training step": report.get("train", {}).get("cost")}
    for name, rec in anchors.items():
        if rec:
            print(f"   cost: {name}: card = meta, {rec['flops']:.6g} FLOPs "
                  f"{rec['bytes']:.6g} bytes; bound on one card "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), share of "
                  f"it reached {rec['share']:.4f}", flush=True)
    out["anchors"] = {k: v is not None for k, v in anchors.items()}


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
    ap.add_argument("--phases",
                    default="parity,main,shard,serve,mutate,kernels,lm,"
                    "families,train,examples,cost")
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
    phases = set(args.phases.split(","))
    cost_runs = start_cost_runs() if "cost" in phases else {}
    atexit.register(stop_cost_runs, cost_runs)
    build_s = build.build_all()
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a, all sources at once"
          f"{'; the dry runs beside it' if cost_runs else ''})", flush=True)
    report = {"device": name, "nvidia_smi": smi, "build_s": build_s}

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
        if "shard" in phases:
            timed("shard", phase_shard, ctx, report)
            _free_cuda()
        if "serve" in phases:
            timed("serve", phase_serve, ctx, report)
        if "mutate" in phases:
            timed("mutate", phase_mutate, ctx, report)
            _free_cuda()
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
    if "families" in phases:
        timed("families", phase_families, report)
    if "train" in phases:
        timed("train", phase_train, report)
    if "examples" in phases:
        timed("examples", phase_examples, report)
    if "cost" in phases:
        timed("cost", phase_cost, report, cost_runs)
    # profiler sessions that device_ms read empty and read again
    report["profiler_empty_sessions"] = dict(EMPTY_SESSIONS)
    print(f"profiler sessions read empty and read again: "
          f"{sum(EMPTY_SESSIONS.values())} "
          f"{report['profiler_empty_sessions']}", flush=True)
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
