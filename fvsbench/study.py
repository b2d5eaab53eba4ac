"""The readings the limits of `correct` are set from: the program's runs
on many seeds, the control's and the planted faults' on a few, at the
cell's own size and load, in one process (set-up is the long part of a
run, so the index is built once and every job searches it).

    python3 fvsbench/study.py --workload <cell> --seconds <s> \\
        --seeds 1,2,3 --control-seeds 4,5,6 \\
        [--faults pass_dropped --fault-seeds 7,8,9] \\
        [--table-seeds 0,1,2] [--out readings.jsonl]

Each run prints one JSON line: who ran (program, control or the fault's
name), the seed, `correct`, and each number compared with the limit it
has now.  `--table-seeds` prints, for a ScaNN cell, how wide the index's
leaves come out on the configuration's table drawn from each data seed:
every leaf tile is padded to the largest leaf.  The benchmark's own runs
never run the control or a fault.
"""
import argparse
import dataclasses
import itertools
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def reused(factory):
    """`factory` that builds the program's executor once and hands the
    same one to every later run (the table and index are the
    configuration's, the same in every run)."""
    built = {}

    def make(cell, rows, seed, device):
        if "ex" not in built:
            built["ex"] = factory(cell, rows, seed, device)
        return built["ex"]
    return make


def readings(cell, jobs, seconds: float, device="cuda"):
    """One record a job; a job is (who, seed): who is "program",
    "control" or the name of a fault planted in the program."""
    from fvsbench import faults, harness
    from fvsbench.reference.control import control_factory
    program = reused(harness.build_executor)
    for who, seed in jobs:
        t0 = time.perf_counter()
        if who == "control":
            line = harness.run_cell(ROOT, cell.name, seed, seconds, False,
                                    device=device, t_start=t0, cell=cell,
                                    factory=control_factory)
        elif who == "program":
            line = harness.run_cell(ROOT, cell.name, seed, seconds, False,
                                    device=device, t_start=t0, cell=cell,
                                    factory=program)
        else:
            with faults.planted(who, cell, program) as factory:
                line = harness.run_cell(ROOT, cell.name, seed, seconds,
                                        False, device=device, t_start=t0,
                                        cell=cell, factory=factory)
        yield {"who": who, "workload": cell.name, "seed": seed,
               "correct": line["correct"], "attempted": line["attempted"],
               "failed": line["failed"], "checks": line["checks"],
               "metrics": {k: v["value"]
                           for k, v in line["metrics"].items()},
               "wall_s": time.perf_counter() - t0}


def leaf_widths(cell, data_seeds, device="cuda"):
    """The ScaNN index over the configuration's table drawn from each
    data seed: leaves, the padded leaf width, and the share of padding."""
    import torch
    from fvsbench import datagen, harness
    for ds in data_seeds:
        cfg = dict(cell.config, data_seed=ds)
        rows, _ = datagen.make_vectors(cfg, 1, ds, torch.device(device))
        ex = harness.build_executor(dataclasses.replace(cell, config=cfg),
                                    rows, ds, torch.device(device))
        rowids = ex.index.leaf_rowids
        sizes = (rowids >= 0).sum(1).float()
        L, C = rowids.shape
        yield {"who": "table", "workload": cell.name, "data_seed": ds,
               "leaves": L, "width": C, "largest": int(sizes.max()),
               "p99": float(sizes.quantile(0.99)),
               "mean": float(sizes.mean()),
               "padding_share": 1.0 - cfg["n"] / (L * C)}
        del ex, rows
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--table-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from fvsbench import harness
    if not torch.cuda.is_available():
        print("the study runs on a CUDA card", file=sys.stderr)
        return 2
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = harness.load_cell(ROOT, args.workload)
    jobs = [("program", s) for s in ints(args.seeds)] + \
        [("control", s) for s in ints(args.control_seeds)] + \
        [(f, s) for f in args.faults.split(",") if f
         for s in ints(args.fault_seeds)]
    recs = itertools.chain(readings(cell, jobs, args.seconds),
                           leaf_widths(cell, ints(args.table_seeds)))
    for rec in recs:
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
