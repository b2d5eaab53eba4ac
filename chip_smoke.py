#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card and
check it, end to end.

    python3 chip_smoke.py                 # the full run, one card
    python3 chip_smoke.py --n 100000 --queries 200 --phases main,kernels

Phases:
  device    the card's name and power limit; the kernels' build time
  parity    a 20,000 x 128 clustered store, indexes built once; every
            quickstart method runs on CPU tensors (the plain versions) and on
            CUDA tensors (the kernels): recall@10 within 0.01 and the mean of
            each of the seven Table-6 counters within 1 %
  main      the main path at full size: a SIFT1M-shaped store (1M x 128,
            1,000 queries), build_graph_blocked and build_scann on the card,
            two workloads, all six methods through make_executor(...).search;
            kernel launch counts are reset just before and read just after
  kernels   each kernel against its plain version on the card at the main
            path's shapes, with its time, the plain version's, one PyTorch
            library call's and the least time the card could take
  profile   (only when named in --phases) one search per method under
            torch.profiler: the device's busy share and its top kernels

The line before the last is the `kernels` JSON record; the last line is
`{"ok": true, "device": {...}}`.  Any failed check ends the run with a
non-zero exit and no result.  Without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 (non-tensor)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

METHODS = ("sweeping", "acorn", "navix", "iterative_scan", "scann",
           "bruteforce")
GRAPH_METHODS = METHODS[:4]
COUNTERS = ("distance_comps", "filter_checks", "hops", "page_accesses_index",
            "page_accesses_heap", "tmap_lookups", "reorder_rows")

PARITY_N, PARITY_QUERIES = 20_000, 200

# kernel-vs-plain tolerance on finite distances: both sum ~128 float32
# products in different orders; ||q||^2 + ||x||^2 is a few units here, so a
# few ulp of it is ~1e-6 and 1e-4 leaves ample room without hiding a bug
# (a wrong row or term is off by O(0.1))
RTOL, ATOL = 1e-5, 1e-4


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def sync(dev="cuda"):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` over `iters` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) on an H100 SXM for this work, and what sets it."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def main_params():
    from repro_torch.core import SearchParams
    return SearchParams(k=10, ef_search=96, beam_width=512, max_hops=2048,
                        num_leaves_to_search=40, reorder_factor=4,
                        scann_query_block=64)


def counter_means(res) -> dict[str, float]:
    from repro_torch.core import stats_table_row
    return stats_table_row(res.stats)


# ---------------------------------------------------------------------------
# parity: the same inputs through the plain versions (CPU) and the kernels
# ---------------------------------------------------------------------------

def phase_parity(n: int, nq: int, report: dict, dev="cuda") -> None:
    from repro_torch.core import (WorkloadSpec, build_graph_blocked,
                                  build_scann, filtered_knn,
                                  generate_bitmaps, make_executor,
                                  recall_at_k, to_device)
    from repro_torch.data import DatasetSpec, make_dataset

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
    bitmaps = generate_bitmaps(store, queries, WorkloadSpec(0.10, "med_pos"),
                               seed=2, device=dev)
    sides = {
        "card": (store, graph, scann, queries, bitmaps),
        "cpu": (to_device(store, "cpu"), to_device(graph, "cpu"),
                to_device(scann, "cpu"), queries.cpu(), bitmaps.cpu()),
    }
    _, truth = filtered_knn(*[sides["cpu"][i] for i in (0, 3, 4)], 10)
    print(f"   setup {time.perf_counter() - t0:.1f} s", flush=True)
    p = main_params()
    rows = {}
    for method in METHODS:
        got = {}
        for side, (st, g, sc, q, bm) in sides.items():
            t0 = time.perf_counter()
            res = make_executor(method, st, graph=g, index=sc,
                                device=st.device).search(q, bm, p)
            sync(st.device)
            got[side] = (float(recall_at_k(res.ids.cpu(), truth, 10).mean()),
                        counter_means(res), time.perf_counter() - t0)
        (rc, cc, tc), (rg, cg, tg) = got["cpu"], got["card"]
        worst = max(abs(cg[k] - cc[k]) / max(abs(cc[k]), 1e-9)
                    if cc[k] or cg[k] else 0.0 for k in COUNTERS)
        print(f"   {method:15s} recall cpu {rc:.4f} card {rg:.4f} | worst "
              f"counter drift {worst:.5f} | cpu {tc:.1f} s card {tg:.2f} s",
              flush=True)
        rows[method] = {"recall_cpu": rc, "recall_card": rg,
                        "counters_cpu": cc, "counters_card": cg,
                        "worst_counter_drift": worst}
        check(abs(rc - rg) <= 0.01, f"parity {method}: recall {rc} vs {rg}")
        check(worst <= 0.01, f"parity {method}: counters drift {worst}")
    report["parity"] = rows


# ---------------------------------------------------------------------------
# main path at full size
# ---------------------------------------------------------------------------

def phase_main(n: int, nq: int, report: dict, dev="cuda") -> dict:
    import torch
    from repro_torch.core import (SYSTEM, WorkloadSpec, build_graph_blocked,
                                  build_scann, cycle_breakdown, filtered_knn,
                                  generate_bitmaps, make_executor,
                                  recall_at_k)
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
        inputs.append((ws, bm, truth))
        print(f"   workload sel={ws.selectivity} {ws.correlation}: bitmaps "
              f"+ ground truth {time.perf_counter() - t0:.1f} s", flush=True)

    ops.reset_launches()
    results = []
    for ws, bm, truth in inputs:
        for method in METHODS:
            ex = make_executor(method, store, graph=graph, index=scann,
                               device=dev)
            before = ops.launches()
            sync(dev)
            t0 = time.perf_counter()
            res = ex.search(queries, bm, p)
            sync(dev)
            wall = time.perf_counter() - t0
            after = ops.launches()
            delta = {k: after[k] - before[k] for k in after}
            rec = float(recall_at_k(res.ids, truth, p.k).mean())
            row = counter_means(res)
            cyc = cycle_breakdown(res.stats, store.dim, SYSTEM)["total"] / 1e6
            ids = res.ids
            check(tuple(ids.shape) == (nq, p.k), f"{method}: ids shape")
            check(bool(torch.isfinite(res.dists[ids >= 0]).all()),
                  f"{method}: non-finite distance for a returned id")
            if method in GRAPH_METHODS:
                check(delta["frontier_scan"] > 0,
                      f"{method} never launched frontier_scan")
            if method == "scann":
                check(delta["distance_matrix"] > 0
                      and delta["leaf_scan_batched"] > 0,
                      "scann did not launch its kernels")
            if method == "bruteforce":
                check(rec == 1.0, f"bruteforce recall {rec} != 1.0")
            print(f"   sel={ws.selectivity:<5} {ws.correlation:8s} "
                  f"{method:15s} recall {rec:.4f} "
                  f"dc {row['distance_comps']:.1f}"
                  f" fc {row['filter_checks']:.1f} hops {row['hops']:.1f} "
                  f"pai {row['page_accesses_index']:.1f} pah "
                  f"{row['page_accesses_heap']:.1f} tm "
                  f"{row['tmap_lookups']:.1f} rr {row['reorder_rows']:.1f} "
                  f"Mcycles {cyc:.4f} wall {wall:.3f} s QPS {nq / wall:.1f} "
                  f"launches {delta}", flush=True)
            results.append({"selectivity": ws.selectivity,
                            "correlation": ws.correlation, "method": method,
                            "recall": rec, "counters": row, "mcycles": cyc,
                            "wall_s": wall, "qps": nq / wall,
                            "launches": delta})
    counts = ops.launches()
    print(f"   launches on the main path: {counts}", flush=True)
    for k, v in counts.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    report["main"] = {"n": n, "queries": nq, "builds": builds,
                      "sizes": sizes, "results": results,
                      "launches": counts}
    return {"store": store, "graph": graph, "scann": scann,
            "queries": queries, "bitmaps": inputs[0][1], "launches": counts}


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
    from repro_torch.kernels.frontier_scan import frontier_scan_cuda
    from repro_torch.kernels.leaf_scan import leaf_scan_batched_cuda

    print("== kernels: each against its plain version on the card ==",
          flush=True)
    store, graph, scann = ctx["store"], ctx["graph"], ctx["scann"]
    queries, bitmaps = ctx["queries"], ctx["bitmaps"]
    p = main_params()
    d = store.dim
    out = []

    # frontier_scan: (Q, deg) 1-hop candidate blocks of the graph; eight
    # different blocks in turn, so the gathered rows (~130 MB) do not stay
    # in the 50 MB L2 from one launch to the next
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qn = queries.shape[0]
    blocks = [graph.neighbors[0, torch.randint(store.n, (qn,), generator=gen,
                                               device="cuda")].contiguous()
              for _ in range(8)]
    errs = []
    for ids in blocks:
        dk, pk = frontier_scan_cuda(queries, store.vectors, store.norms_sq,
                                    ids, bitmaps, store.metric)
        dp, pp = ref.frontier_scan_ref(queries, store.vectors,
                                       store.norms_sq, ids, bitmaps,
                                       store.metric)
        errs.append(_compare("frontier_scan", dk, dp, [(pk, pp)]))
    it = iter(range(10 ** 9))

    def pick():
        return blocks[next(it) % len(blocks)]

    ms = cuda_ms(lambda: frontier_scan_cuda(queries, store.vectors,
                                            store.norms_sq, pick(), bitmaps,
                                            store.metric), iters=40)
    plain_ms = cuda_ms(lambda: ref.frontier_scan_ref(
        queries, store.vectors, store.norms_sq, pick(), bitmaps,
        store.metric), iters=40)
    lib_ms = cuda_ms(lambda: torch.bmm(
        store.vectors[pick().clamp(min=0).long()], queries[:, :, None]),
        iters=40)
    nbytes, flops = [], []
    for ids in blocks:
        valid = ids >= 0
        nv = int(valid.sum())
        uniq = int(torch.unique(ids[valid]).numel())
        # queries + ids in; each distinct row and its norm once; one bitmap
        # word per probe; distances (f32) and pass flags (1 byte) out
        nbytes.append(qn * d * 4 + ids.numel() * 4 + uniq * (d + 1) * 4
                      + nv * 4 + ids.numel() * 5)
        flops.append(2 * d * nv + 2 * d * qn)
    b_ms, b_by = bound(sum(nbytes) / len(nbytes), sum(flops) / len(flops))
    out.append({"name": "frontier_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/frontier_scan.cu",
                "replaces": "src/repro/kernels/frontier_scan.py:52",
                "launches": ctx["launches"]["frontier_scan"],
                "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "shape": f"Q={qn} C={blocks[0].shape[1]} d={d} "
                         f"n={store.n}"})

    # distance_matrix: one query block against the 2000 leaf centroids
    qb = queries[:p.scann_query_block]
    qp = project_query(scann, qb).contiguous()
    cents = scann.leaf_centroids
    got = distance_matrix_cuda(qp, cents, scann.metric)
    err = _compare("distance_matrix", got,
                   ref.distance_matrix_ref(qp, cents, scann.metric))
    ms = cuda_ms(lambda: distance_matrix_cuda(qp, cents, scann.metric))
    plain_ms = cuda_ms(lambda: ref.distance_matrix_ref(qp, cents,
                                                       scann.metric))
    base = (qp * qp).sum(1, keepdim=True) + (cents * cents).sum(1)[None, :]
    lib_ms = cuda_ms(lambda: torch.addmm(base, qp, cents.T, beta=1,
                                         alpha=-2))
    nq_b, nc = qp.shape[0], cents.shape[0]
    b_ms, b_by = bound((nq_b * d + nc * d + nq_b * nc) * 4,
                       2 * nq_b * nc * d + 2 * (nq_b + nc) * d)
    out.append({"name": "distance_matrix", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/distance.cu",
                "replaces": "src/repro/kernels/distance.py:22",
                "launches": ctx["launches"]["distance_matrix"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "shape": f"Q={nq_b} N={nc} d={d}"})

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
    ms = cuda_ms(lambda: leaf_scan_batched_cuda(*args))
    plain_ms = cuda_ms(lambda: ref.leaf_scan_batched_ref(*args), iters=5)
    u, c, _ = tiles.shape
    lib_ms = cuda_ms(lambda: torch.matmul(
        qp, (tiles.to(torch.float32) * scann.scale + scann.mean)
        .reshape(u * c, d).T), iters=5)
    valid = rowids >= 0
    words = int(torch.unique(rowids[valid] >> 5).numel())
    # queries, tiles, rowids, norms, scale/mean in once; each query's
    # bitmap words over the union's rows; (Q, U, C) scores out
    nbytes = (nq_b * d * 4 + u * c * d + u * c * 8 + 2 * d * 4
              + nq_b * words * 4 + nq_b * u * c * 4)
    flops = 2 * nq_b * u * c * d + 2 * u * c * d
    b_ms, b_by = bound(nbytes, flops)
    out.append({"name": "leaf_scan_batched", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/leaf_scan.cu",
                "replaces": "src/repro/kernels/leaf_scan.py:102",
                "launches": ctx["launches"]["leaf_scan_batched"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "shape": f"Q={nq_b} U={u} C={c} d={d}"})
    for k in out:
        print(f"   {k['name']:18s} {k['shape']:28s} kernel {k['ms']:.4f} ms"
              f" plain {k['plain_ms']:.4f} ms library {k['library_ms']:.4f}"
              f" ms bound {k['bound_ms']:.4f} ms ({k['bound_by']}) "
              f"max|err| {k['max_abs_err']:.3g} launches {k['launches']}",
              flush=True)
    report["kernels"] = out
    return out


def phase_profile(ctx: dict, report: dict) -> None:
    """One search per method (first workload) under torch.profiler: the
    device's busy share of the wall time and the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import make_executor

    print("== profile: device busy share per method (first workload) ==",
          flush=True)
    p = main_params()
    rows = {}
    for method in METHODS:
        ex = make_executor(method, ctx["store"], graph=ctx["graph"],
                           index=ctx["scann"], device="cuda")
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.search(ctx["queries"], ctx["bitmaps"], p)
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        per_name = {}
        for e in prof.key_averages():
            # device-side events only (kernels, copies, sets): a CPU op's
            # self device time repeats its kernels'; "Command Buffer Full"
            # is a launch-queue stall, not device work
            if e.device_type != DeviceType.CUDA \
                    or e.key.startswith("Command Buffer Full"):
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            if dev_us > 0:
                per_name[e.key] = per_name.get(e.key, 0.0) + dev_us
        busy_us = sum(per_name.values())
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        rows[method] = {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
                        "busy_share": busy_us / wall_us,
                        "top": [(k[:60], v / 1e3) for k, v in top]}
        print(f"   {method:15s} wall {wall_us / 1e3:.1f} ms (profiled) "
              f"device {busy_us / 1e3:.1f} ms busy {busy_us / wall_us:.3f}"
              f" | top: " + "; ".join(f"{k[:40]} {v / 1e3:.1f} ms"
                                     for k, v in top[:4]), flush=True)
    report["profile"] = rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "on one card and check it.")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--phases", default="parity,main,kernels")
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
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
    if "parity" in phases:
        phase_parity(PARITY_N, PARITY_QUERIES, report)
    kernels = []
    if "main" in phases:
        ctx = phase_main(args.n, args.queries, report)
        if "kernels" in phases:
            kernels = phase_kernels(ctx, report)
        if "profile" in phases:
            phase_profile(ctx, report)
    report["total_s"] = time.perf_counter() - t_start
    print(f"total {report['total_s']:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "shape"} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
