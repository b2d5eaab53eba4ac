"""Run the gloo rank script of
`tests/test_torch_moe.py::test_ep_combine_on_gloo_ranks_equals_plain_combine`
many times at once on the CPU, to look for a rank that dies under load.

    python3 tools_torch/stress_gloo_ranks.py [--at-once 8] [--rounds 3]
        [--world 4] [--tests tests/test_torch_moe.py]

Each round starts `--at-once` copies of the test's `_EP_RANKS` script
(read from `--tests` without importing it, so no JAX), each spawning
`--world` gloo ranks in a directory of its own, and waits for all of
them.  Prints one JSON line: runs, failures, and the first lines of each
failure's stderr that name a signal or an error.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_script(path: str) -> str:
    """The `_EP_RANKS` string of a test file, by its syntax tree."""
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_EP_RANKS" for t in node.targets):
            return ast.literal_eval(node.value.args[0])
    raise ValueError(f"{path} has no _EP_RANKS")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--at-once", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--tests", default=os.path.join(ROOT, "tests",
                                                    "test_torch_moe.py"))
    args = ap.parse_args(argv)
    import textwrap
    script = textwrap.dedent(rank_script(args.tests))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    runs, failures = 0, []
    with tempfile.TemporaryDirectory() as top:
        for r in range(args.rounds):
            procs = []
            for i in range(args.at_once):
                d = os.path.join(top, f"{r}_{i}")
                os.makedirs(d)
                path = os.path.join(d, "ranks.py")
                with open(path, "w") as f:
                    f.write(script)
                procs.append(subprocess.Popen(
                    [sys.executable, path, d, str(args.world)], cwd=d,
                    env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True))
            for p in procs:
                _, err = p.communicate(timeout=600)
                runs += 1
                if p.returncode:
                    failures.append([line for line in err.splitlines()
                                     if "SIG" in line or "rror" in line
                                     or "terminate" in line][:4])
    print(json.dumps({"runs": runs, "at_once": args.at_once,
                      "world": args.world, "failures": len(failures),
                      "stderr": failures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
