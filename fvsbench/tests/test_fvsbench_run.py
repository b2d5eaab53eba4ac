"""A whole run of each cell on the CPU at test size: the last line's keys,
the control put in the program's place, and the timed path broken
underneath, each of which has to come out as not correct."""
import dataclasses
import json
import subprocess
import sys

import pytest

from fvsbench_testkit import CELLS, ROOT, harness, run_tiny, tiny
from fvsbench import faults
from fvsbench.reference.control import control_factory

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("traced", (False, True))
@pytest.mark.parametrize("name", CELLS)
def test_run_line(name, traced):
    line = run_tiny(name, traced=traced)
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["checks"]) == {"bad_answers", "dist_err", "recall_miss"}
    cell = harness.load_cell(ROOT, name)
    want = cell.per_layer if traced else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for metric, v in line["metrics"].items():
        assert v["unit"] == units[metric]
    if not traced:   # CPU runs have no device peak and no device trace
        assert set(line["metrics"]) == set(units) - {"peak_gib"}
    else:
        assert "breakdown" in line and "busy_s" in line["device"]
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    line = run_tiny(name, factory=control_factory)
    assert not line["correct"]
    assert line["checks"]["dist_err"]["value"] > \
        line["checks"]["dist_err"]["limit"]


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in faults.names(harness.load_cell(ROOT, name))])
def test_broken_timed_path_is_not_correct(name, fault):
    cell = tiny(name)
    with faults.planted(fault, cell) as factory:
        line = run_tiny(name, factory=factory)
    assert not line["correct"], line["checks"]
    if fault in faults.RECALL[faults.engine(cell)]:
        # the rows returned give the fault away
        assert line["checks"]["recall_miss"]["value"] > \
            line["checks"]["recall_miss"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_study_reads_program_control_and_faults(name):
    """The study's jobs in one process on one index: the program reads
    correct, the control and a recall fault do not."""
    from fvsbench import study
    cell = tiny(name)
    fault = faults.RECALL[faults.engine(cell)][0]
    recs = list(study.readings(cell, [("program", 3), ("control", 3),
                                      (fault, 3), ("program", 4)],
                               0.2, device="cpu"))
    assert [r["correct"] for r in recs] == [True, False, False, True]
    json.dumps(recs)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing."""
    p = subprocess.run(
        [sys.executable, str(ROOT / "fvsbench" / "run.py"), "--workload",
         CELLS[0], "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("extra", (
    {"storage": {"capacity_frac": 0.5, "policy": "lru"}},
    {"arrivals": {"kind": "poisson", "rate_qps": 200.0}},
    {"filters": [{"selectivity": 0.1, "correlation": "none", "share": 1},
                 {"selectivity": 0.5, "correlation": "low_pos",
                  "share": 1}]}), ids=("storage", "open_loop", "mix"))
def test_traffic_as_data(extra):
    """A storage engine, an open-loop schedule and a mix of filters are
    data in a traffic file, run by the same harness."""
    from fvsbench_testkit import tiny
    cell = tiny(CELLS[0])
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **extra))
    line = harness.run_cell(ROOT, cell.name, 9, 0.3, False, device="cpu",
                            cell=cell)
    assert line["correct"] and line["attempted"] > 0
