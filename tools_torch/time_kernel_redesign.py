"""Time a parent commit's flash_attention and distance_matrix kernels beside
this checkout's, in one process on one card.

    mkdir -p build/parent
    git show <parent>:src/repro_torch/kernels/csrc/flash_attention.cu \
        > build/parent/flash_attention.cu
    git show <parent>:src/repro_torch/kernels/csrc/distance.cu \
        > build/parent/distance.cu
    python3 tools_torch/time_kernel_redesign.py --parent build/parent

Builds the parent's two sources with the port's nvcc flags into
`build/parent_kernels/` while this checkout's own sources build, then at
the main path's shapes times parent, new, new, parent: flash attention on
q, k, v (2, 8192, 16, 80) bf16, non-causal, the hubert-xlarge encoder's
prefill (the parent's FP32 FMA template, the new tensor-core route), and
distance_matrix at (64, 2000, 128) and (64, 44, 128), L2.  Device
milliseconds per call from torch.profiler, as `chip_smoke.py` takes them.
Checks that the parent and the new kernel agree (relative L2 1e-2 for
flash attention, whose new route rounds P to bf16; allclose(1e-5, 1e-4)
for the distances) and prints one JSON line with every time, the card's
name and its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# q, k, v of one encoder prefill: (batch, frames, heads, head width)
FLASH_SHAPE = (2, 8192, 16, 80)
PARENT_SOURCES = ("flash_attention", "distance")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "build", "parent"),
                    help="directory holding the parent's flash_attention.cu "
                         "and distance.cu")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_kernel_redesign: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.distance import distance_matrix_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.measure import device_ms, rel_l2

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    parent_dir = os.path.abspath(args.parent)
    parent_out = os.path.join(ROOT, "build", "parent_kernels")
    with ThreadPoolExecutor() as pool:
        builds = [pool.submit(build.build_all),
                  pool.submit(build.build_all, PARENT_SOURCES, parent_dir,
                              parent_out)]
        for b in builds:
            b.result()
    parent = {name: build.load_from(parent_dir, name, parent_out)
              for name in PARENT_SOURCES}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)

    # flash attention at the encoder's shape
    b, t, h, hd = FLASH_SHAPE
    q, k, v = (torch.randn(FLASH_SHAPE, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    out = torch.empty_like(q)

    def flash_parent():
        status = parent["flash_attention"].flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            t, h, h, hd, 0, 1, stream())
        if status:
            raise RuntimeError(f"parent flash_attention: error {status}")
        return out

    def flash_new():
        return flash_attention_cuda(q, k, v, False)

    flash_parent()
    rel, _ = rel_l2(flash_new(), out)
    if rel > 1e-2:
        raise RuntimeError(f"flash_attention: parent and new differ, "
                           f"relative L2 {rel}")
    times = {"flash_attention": {"parent": [], "new": []}}
    for who, fn in (("parent", flash_parent), ("new", flash_new),
                    ("new", flash_new), ("parent", flash_parent)):
        times["flash_attention"][who].append(
            device_ms(fn, iters=3 if who == "parent" else 20, warmup=1))
        print(f"flash_attention {who}: {times['flash_attention'][who][-1]} "
              "ms", flush=True)
    del q, k, v, out

    # distance_matrix at the centroid levels' shapes
    for n in (2000, 44):
        qd = torch.randn(64, 128, device="cuda", generator=gen)
        xd = torch.randn(n, 128, device="cuda", generator=gen)
        od = torch.empty(64, n, device="cuda")

        def dist_parent():
            status = parent["distance"].distance_matrix_f32(
                qd.data_ptr(), xd.data_ptr(), od.data_ptr(), 64, n, 128, 0,
                stream())
            if status:
                raise RuntimeError(f"parent distance_matrix: error {status}")
            return od

        def dist_new():
            return distance_matrix_cuda(qd, xd, "l2")

        dist_parent()
        if not torch.allclose(dist_new(), od, rtol=1e-5, atol=1e-4):
            raise RuntimeError(f"distance_matrix N={n}: parent and new "
                               "differ")
        key = f"distance_matrix N={n}"
        times[key] = {"parent": [], "new": []}
        for who, fn in (("parent", dist_parent), ("new", dist_new),
                        ("new", dist_new), ("parent", dist_parent)):
            times[key][who].append(device_ms(fn, iters=200))
            print(f"{key} {who}: {times[key][who][-1]} ms", flush=True)
    print(json.dumps({"device_ms": times, "flash_shape": FLASH_SHAPE,
                      "nvidia_smi": smi,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
