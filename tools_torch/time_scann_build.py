"""Time the port's ScaNN build on one card.

Builds `chip_smoke.py`'s SIFT1M-shaped store (1M x 128, 128 clusters, seed
0) and then the main path's ScaNN index on it (2000 leaves, 2 levels, seed
0) a few times; prints one JSON line with each build's seconds and a
digest of each index (equal digests: the same index).

    python3 tools_torch/time_scann_build.py [--src DIR]

`--src` is the `src` directory whose `repro_torch` is timed (default: this
checkout's), so that two commits can be timed one after the other on one
card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1_000_000
REPEAT = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_scann_build: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import build_scann
    from repro_torch.data import DatasetSpec, make_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    store, _ = make_dataset(DatasetSpec("sift1m", N, 128, "l2",
                                        clusters=128),
                            num_queries=10, seed=0, device="cuda")
    seconds, digests = [], []
    for _ in range(REPEAT):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_scann(store, num_leaves=2000, levels=2, seed=0,
                            device="cuda")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        h = hashlib.sha256()
        for t in (index.leaf_rowids, index.leaf_centroids):
            h.update(t.cpu().numpy().tobytes())
        digests.append(h.hexdigest()[:16])
    print(json.dumps({"src": args.src, "n": N, "build_s": seconds,
                      "digests": digests,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
