"""Time two hand kernels beside the library calls their kernel-table rows
name, in turns, over several profiler sessions each, on one card.

    python3 tools_torch/time_library_calls.py [--sessions 5]

- frontier_scan (kernel table row 1) at the main path's shape, (Q, C, d)
  = (1000, 32, 128) over a 1M-row f32 store, the candidate blocks and
  bitmaps of `time_kernel_redesign.frontier_inputs`; the library call is
  the row's: `torch.bmm(rows[ids.clamp(min=0)], queries[:, :, None])`;
- topk (row 8) at `time_kernel_redesign.TOPK_CASES`, n = 56,640, k = 40
  (96 % +inf) and n = 1M, k = 10; the library call `torch.topk`.

Each session is one `measure.device_ms` reading (torch.profiler, every
kernel and copy a call runs); the kernel and the library call alternate
(kernel, library, library, kernel, ...).  The library call's device time
by kernel name is printed from one more session, so a reading that moves
between runs can be split into the gather and the product.  Prints one
JSON line: every session's reading, their medians, the card's name and
its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _turns(kern, lib, sessions: int, device_ms, iters: int) -> dict:
    """`sessions` readings of each, in turns."""
    got = {"kernel": [], "library": []}
    order = [("kernel", kern), ("library", lib)]
    for s in range(sessions):
        for name, fn in (order if s % 2 == 0 else order[::-1]):
            got[name].append(device_ms(fn, iters=iters))
    got["median"] = {k: statistics.median(got[k]) for k in
                     ("kernel", "library")}
    return got


def _by_name(fn, iters: int = 40) -> dict[str, float]:
    """Device ms a call by kernel name, one session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.measure import device_us_by_name
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {k: v / iters / 1e3 for k, v in device_us_by_name(prof).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_library_calls: no CUDA device is available",
              file=sys.stderr)
        return 2
    from time_kernel_redesign import TOPK_CASES, frontier_inputs

    from repro_torch.kernels import build
    from repro_torch.kernels.frontier_scan import frontier_scan_cuda
    from repro_torch.kernels.ref import frontier_scan_ref
    from repro_torch.kernels.topk import topk_cuda
    from repro_torch.measure import EMPTY_SESSIONS, device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    build.build_all(["frontier_scan", "topk"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"nvidia_smi": smi, "sessions": args.sessions}

    qn, c, d, n = 1000, 32, 128, 1_000_000
    rows = torch.randn((n, d), device="cuda", generator=gen)
    norms = (rows * rows).sum(1)
    queries = torch.randn((qn, d), device="cuda", generator=gen)
    blocks, bitmaps = frontier_inputs(gen, qn, c, n)
    it = iter(range(10 ** 9))

    def pick():
        return blocks[next(it) % len(blocks)]

    got = frontier_scan_cuda(queries, rows, norms, blocks[0], bitmaps)
    want = frontier_scan_ref(queries, rows, norms, blocks[0], bitmaps)
    if not (torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
            and torch.equal(got[1], want[1])):
        raise RuntimeError("frontier_scan: kernel and plain version differ")

    def lib():
        return torch.bmm(rows[pick().clamp(min=0).long()],
                         queries[:, :, None])

    key = f"frontier_scan Q={qn} C={c} d={d} n={n}"
    out[key] = _turns(lambda: frontier_scan_cuda(queries, rows, norms,
                                                 pick(), bitmaps),
                      lib, args.sessions, device_ms, 40)
    out[key]["library_by_name"] = _by_name(lib)
    del rows, norms, blocks, bitmaps
    torch.cuda.empty_cache()

    for n, k in TOPK_CASES:
        v = torch.randn(n, device="cuda", generator=gen).abs() * 100.0
        if n < 100_000:
            v[torch.rand(n, device="cuda", generator=gen) < 0.96] = \
                float("inf")
        tv, ti = topk_cuda(v, k)
        lv, _ = torch.topk(v, k, largest=False)
        if not torch.equal(tv, torch.sort(lv).values):
            raise RuntimeError(f"topk n={n} k={k}: kernel and torch.topk "
                               "differ")
        key = f"topk n={n} k={k}"
        out[key] = _turns(lambda: topk_cuda(v, k),
                          lambda: torch.topk(v, k, largest=False),
                          args.sessions, device_ms, 200)
        out[key]["library_by_name"] = _by_name(
            lambda: torch.topk(v, k, largest=False), 200)
    out["profiler_empty_sessions"] = dict(EMPTY_SESSIONS)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
