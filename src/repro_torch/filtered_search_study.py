"""The paper's core experiment in miniature: the selectivity x correlation
grid on one dataset, five methods, with the system-tax cost model (a
small Fig. 9 + Fig. 12 in one run).

The counterpart of examples/filtered_search_study.py: a 12,000 x 128
clustered store (48 clusters), an HNSW graph and a ScaNN index, the 3 x 3
grid of selectivities (0.05, 0.2, 0.5) and correlations (high_pos, none,
negative), and for each cell navix, sweeping, iterative_scan, scann and
the adaptive planner (printed as `adaptive>strategy`, the strategy it
chose): recall@10 and the modeled QPS under the SYSTEM and the LIBRARY
cost constants.

    PYTHONPATH=src python -m repro_torch.filtered_search_study   # on the card
    PYTHONPATH=src python -m repro_torch.filtered_search_study --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (LIBRARY, SYSTEM, SearchParams, WorkloadSpec,
                              build_graph, build_scann, filtered_knn,
                              generate_bitmaps, make_executor, modeled_qps,
                              recall_at_k, resolve_device)
from repro_torch.data import DatasetSpec, make_dataset

SELS = (0.05, 0.2, 0.5)
CORRS = ("high_pos", "none", "negative")
METHODS = ("navix", "sweeping", "iterative_scan", "scann", "adaptive")
PARAMS = SearchParams(k=10, ef_search=96, beam_width=512, max_hops=2048,
                      num_leaves_to_search=24)
BITMAP_SEED = 7


def study(store, queries: torch.Tensor, graph, index,
          bitmaps: dict[tuple[str, float], torch.Tensor]) -> list[dict]:
    """The grid on built state: `bitmaps[(corr, sel)]` are the cell's
    (Q, W) filters.  Prints one row a (cell, method) and returns them:
    corr, sel, method (`adaptive>strategy` for the planner), recall@10
    (the batch mean), sys_qps and lib_qps."""
    dev = store.device
    print(f"{'corr':9s} {'sel':>5s} {'method':15s} {'recall':>6s} "
          f"{'sysQPS':>8s} {'libQPS':>8s}")
    rows = []
    for corr in CORRS:
        for sel in SELS:
            bm = bitmaps[(corr, sel)]
            _, tid = filtered_knn(store, queries, bm, 10)
            for m in METHODS:
                ex = make_executor(m, store, graph=graph, index=index,
                                   device=dev)
                res = ex.search(queries, bm, PARAMS)
                rec = float(recall_at_k(res.ids, tid, 10).mean())
                qs = modeled_qps(res.stats, store.dim, SYSTEM)
                ql = modeled_qps(res.stats, store.dim, LIBRARY)
                tag = m if m != "adaptive" else f"adaptive>{res.strategy}"
                print(f"{corr:9s} {sel:5.2f} {tag:15s} {rec:6.3f} "
                      f"{qs:8.0f} {ql:8.0f}")
                rows.append({"corr": corr, "sel": sel, "method": tag,
                             "recall": rec, "sys_qps": qs, "lib_qps": ql})
    return rows


def main(device="cuda", n: int = 12_000, dim: int = 128, clusters: int = 48,
         num_queries: int = 8, num_leaves: int = 96, seed: int = 0
         ) -> list[dict]:
    """Build the store, indexes and the grid's bitmaps on `device`, run
    `study` and return its rows."""
    dev = resolve_device(device)
    spec = DatasetSpec("study", n, dim, "l2", clusters=clusters)
    store, queries = make_dataset(spec, num_queries=num_queries, seed=seed,
                                  device=dev)
    graph = build_graph(store, m=16, ef_construction=64, seed=0, device=dev)
    scann = build_scann(store, num_leaves=num_leaves, levels=2, seed=0,
                        device=dev)
    bitmaps = {(c, s): generate_bitmaps(store, queries, WorkloadSpec(s, c),
                                        seed=BITMAP_SEED, device=dev)
               for c in CORRS for s in SELS}
    rows = study(store, queries, graph, scann, bitmaps)
    print("\nThe SYSTEM/LIBRARY QPS columns reproduce Fig. 1's point: the "
          "method ranking differs between the two regimes.")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=12_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=8)
    a = ap.parse_args()
    main(device=a.device, n=a.n, dim=a.dim, num_queries=a.queries)
