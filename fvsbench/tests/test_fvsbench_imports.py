"""Nothing the harness loads is JAX or the JAX package: a fresh process
loads the harness, every config, cell, metric and reference module and
runs a cell at test size, then lists its modules by top-level name."""
import os
import subprocess
import sys

from fvsbench_testkit import ROOT

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1], sys.argv[1] + "/fvsbench/tests"]
import fvsbench_testkit as kit
from fvsbench import harness
from fvsbench.reference import control, exact
spec = json.load(open(sys.argv[1] + "/BENCHMARK.json"))
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.metric_reader(m["name"])
for name in kit.CELLS:
    harness.load_cell(kit.ROOT, name)
kit.run_tiny(kit.CELLS[0])
kit.run_tiny(kit.CELLS[1])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_and_no_jax_package_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(__import__("json").loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "fvsbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
