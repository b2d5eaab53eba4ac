"""Quickstart of the port: filtered vector search, six methods, one table.

The counterpart of examples/quickstart.py: a clustered dataset, an HNSW
graph and a ScaNN index, a 10 % medium-positively-correlated workload,
every method behind the one executor API (steps 1-4), and the adaptive
planner's choice at three selectivities (step 5).

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (SYSTEM, SearchParams, WorkloadSpec, build_graph,
                              build_scann, cycle_breakdown, filtered_knn,
                              generate_bitmaps, make_executor, recall_at_k,
                              resolve_device, stats_table_row)
from repro_torch.data import DatasetSpec, make_dataset

METHODS = ("sweeping", "acorn", "navix", "iterative_scan", "scann",
           "bruteforce")


def main(device="cuda", n: int = 10_000, dim: int = 96, clusters: int = 32,
         num_queries: int = 8, num_leaves: int = 96, seed: int = 0
         ) -> dict[str, dict]:
    """Run steps 1-5 and print the tables.  Returns, per method, its
    recall@10, the seven Table-6 counters (batch means) and Mcycles, and
    under "adaptive" the planner's choice and predicted Mcycles per
    selectivity."""
    dev = resolve_device(device)
    print("== 1. dataset (clustered, Table-2-shaped) ==")
    spec = DatasetSpec("quickstart", n, dim, "l2", clusters=clusters)
    store, queries = make_dataset(spec, num_queries=num_queries, seed=seed,
                                  device=dev)
    print(f"   {store.n} vectors, d={store.dim}, {queries.shape[0]} queries "
          f"on {dev}")

    print("== 2. indexes ==")
    graph = build_graph(store, m=16, ef_construction=64, seed=seed,
                        device=dev)
    scann = build_scann(store, num_leaves=num_leaves, levels=2, seed=seed,
                        device=dev)
    print(f"   HNSW: {graph.num_levels} levels | ScaNN: "
          f"{scann.num_leaves} leaves")

    print("== 3. workload: 10% selectivity, medium positive correlation ==")
    ws = WorkloadSpec(selectivity=0.10, correlation="med_pos")
    bitmaps = generate_bitmaps(store, queries, ws, seed=seed + 1, device=dev)
    _, true_ids = filtered_knn(store, queries, bitmaps, 10)

    print("== 4. strategies behind the one executor API ==")
    p = SearchParams(k=10, ef_search=96, beam_width=512, max_hops=2048,
                     num_leaves_to_search=24, reorder_factor=4)
    print(f"   {'method':16s} {'recall':>6s} {'dist':>7s} {'filter':>8s} "
          f"{'hops':>6s} {'pages':>7s} {'Mcycles':>8s}")
    out = {}
    for method in METHODS:
        ex = make_executor(method, store, graph=graph, index=scann,
                           device=dev)
        res = ex.search(queries, bitmaps, p)
        rec = float(recall_at_k(res.ids, true_ids, 10).mean())
        row = stats_table_row(res.stats)
        cyc = cycle_breakdown(res.stats, store.dim, SYSTEM)["total"] / 1e6
        pages = row["page_accesses_index"] + row["page_accesses_heap"]
        print(f"   {method:16s} {rec:6.3f} {row['distance_comps']:7.0f} "
              f"{row['filter_checks']:8.0f} {row['hops']:6.0f} "
              f"{pages:7.0f} {cyc:8.2f}")
        out[method] = {"recall": rec, "counters": row, "mcycles": cyc}

    print("== 5. the system-aware adaptive planner ==")
    planner = make_executor("adaptive", store, graph=graph, index=scann,
                            device=dev)
    out["adaptive"] = {}
    for sel in (0.01, 0.10, 0.8):
        bm = generate_bitmaps(store, queries, WorkloadSpec(sel, "none"),
                              seed=2, device=dev)
        res = planner.search(queries, bm, p)
        preds = {m: round(c / 1e6, 2)
                 for m, c in res.plan.predicted_cycles.items()}
        print(f"   sel={sel:<5} -> chose {res.plan.strategy:15s} "
              f"(predicted Mcycles: {preds})")
        out["adaptive"][sel] = {"chosen": res.plan.strategy,
                                "predicted_mcycles": preds}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--queries", type=int, default=8)
    a = ap.parse_args()
    res = main(device=a.device, n=a.n, dim=a.dim, num_queries=a.queries)
    print("mean recall", float(np.mean([res[m]["recall"] for m in METHODS])))
