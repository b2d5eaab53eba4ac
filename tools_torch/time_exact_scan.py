"""Time the exact filtered scan on one card: `filtered_knn` (every
distance at one fixed GEMM shape, `workload.exact_distances`) against the
same scan with one GEMM a query chunk (`workload.full_distances`, what
`filtered_knn` computed before the mutable index needed shape-independent
bits), on `chip_smoke.py`'s store and workload A.

    python3 tools_torch/time_exact_scan.py [--n 1000000] [--queries 1000]

Prints, beside the card's name and power limit, one JSON line: each
version's seconds for the whole batch (three runs each, in turns), and
whether the two agree (ids equal, distances within (1e-5, 1e-4)).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1000)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_exact_scan: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import (WorkloadSpec, filtered_knn,
                                  full_distances, generate_bitmaps,
                                  topk_smallest, unpack_bitmap)
    from repro_torch.core.workload import QUERY_CHUNK
    from repro_torch.data import DatasetSpec, make_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    store, queries = make_dataset(DatasetSpec("sift1m", args.n, 128, "l2",
                                              clusters=128),
                                  num_queries=args.queries, seed=0,
                                  device="cuda")
    bm = generate_bitmaps(store, queries, WorkloadSpec(0.10, "med_pos"),
                          seed=10, device="cuda")

    def one_gemm():
        ds, ids = [], []
        for s in range(0, queries.shape[0], QUERY_CHUNK):
            d = full_distances(store, queries[s:s + QUERY_CHUNK])
            ok = unpack_bitmap(bm[s:s + QUERY_CHUNK], store.n)
            d = torch.where(ok, d, torch.full_like(d, float("inf")))
            dk, idx = topk_smallest(d, 10)
            ds.append(dk)
            ids.append(torch.where(torch.isinf(dk),
                                   torch.full_like(idx, -1), idx))
        return torch.cat(ds), torch.cat(ids)

    def fixed_shape():
        return filtered_knn(store, queries, bm, 10)

    runs = {"fixed_shape": [], "one_gemm": []}
    out = {}
    for name in ("one_gemm", "fixed_shape", "fixed_shape", "one_gemm") * 3:
        fn = one_gemm if name == "one_gemm" else fixed_shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        runs[name].append(time.perf_counter() - t0)
    (da, ia), (db, ib) = out["fixed_shape"], out["one_gemm"]
    fin = torch.isfinite(db)
    agree = bool(torch.equal(ia, ib) and torch.allclose(
        da[fin], db[fin], rtol=1e-5, atol=1e-4))
    print(smi)
    print(json.dumps({"n": args.n, "queries": args.queries,
                      "seconds": runs, "agree": agree,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
