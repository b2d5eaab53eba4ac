"""Time the exact HNSW build (`build_graph`, the recipe `MutableIndex`
builds, compacts and recovers with) on one card.

Builds `chip_smoke.py`'s SIFT1M-shaped store (1M x 128, 128 clusters, seed
0) and the exact graph (m 16, ef_construction 32, seed 0) on its first n
rows for each `--n`, `--repeat` times; prints one JSON line with each
build's seconds and a digest of each graph (equal digests: the same
graph), beside the card's name and power limit.

    python3 tools_torch/time_graph_build.py [--n 100000 1000000] [--repeat 2]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[100_000, 1_000_000])
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_graph_build: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import VectorStore, build_graph
    from repro_torch.data import DatasetSpec, make_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    store, _ = make_dataset(DatasetSpec("sift1m", max(args.n), 128, "l2",
                                        clusters=128),
                            num_queries=10, seed=0, device="cuda")
    rows = []
    for n in args.n:
        sub = VectorStore.build(store.vectors[:n].clone(), device="cuda")
        seconds, digests = [], []
        for _ in range(args.repeat):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = build_graph(sub, m=16, ef_construction=32, seed=0,
                                device="cuda")
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            h = hashlib.sha256(graph.neighbors.cpu().numpy().tobytes())
            h.update(graph.node_level.cpu().numpy().tobytes())
            digests.append(h.hexdigest()[:16])
        rows.append({"n": n, "build_s": seconds, "digests": digests})
        print(json.dumps(rows[-1]), flush=True)
    print(smi)
    print(json.dumps({"builds": rows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
