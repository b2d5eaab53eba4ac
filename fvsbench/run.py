"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 fvsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With `--trace 0` the line holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a torch.profiler trace of
the window and from the program's counters.  The run needs a CUDA card
and the program (`src/repro_torch`) beside it; it builds the program's
kernels under `build/` in this checkout the first time.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout, so only
# the first run of a checkout compiles.  The program's nvcc builds go to
# build/kernels (fixed by the program) already.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from fvsbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START, cell=cell)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules that may not be loaded were: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
