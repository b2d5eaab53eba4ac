"""BENCHMARK.json against the benchmark's contract, and every config,
traffic mix, cell and metric found by name."""
import json
import re

import pytest

from fvsbench_testkit import CELLS, ROOT, harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = [m["name"] for m in SPEC["end_to_end"]]
ALL_METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "fvsbench/run.py"]
    assert SPEC["paths"] == ["fvsbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in ALL_METRICS]
    assert len(names) == len(set(names))
    for m in ALL_METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for e in SPEC["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for p in SPEC["per_layer"]:
        assert p["moves"] in E2E and "bound" not in p
        assert set(p) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert "setup_s" in E2E


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.load_cell(ROOT, name)
    assert cell.chips == 1
    assert cell.config["metric"] == "l2"
    assert cell.traffic["batch"] <= cell.traffic["pool"]
    assert cell.limits["dist_err"] > 0
    assert 0 < cell.limits["recall_miss"] < 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:      # the metric it moves is reported here
        assert m["moves"] in reported


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert entry["file"].startswith("fvsbench/")
    assert cfg["reduced"] == entry["reduced"]
    # cuts of build effort or scale only; the shapes stay the source's
    assert set(cfg["reduced"]) <= {"hnsw", "n"}
    for key in ("n", "dim", "metric", "clusters", "cluster_spread",
                "data_seed", "hnsw", "scann", "assumed", "guarantees"):
        assert key in cfg


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric["name"]))
    for w in metric.get("workloads", []):
        assert w in CELLS


def test_free_text_fields():
    texts = [e["why"] for e in SPEC["workloads"] + SPEC["configs"]] + \
        [c["source"] for c in SPEC["configs"]] + \
        [p["layer"] for p in SPEC["per_layer"]] + SPEC["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
