"""Each metric's arithmetic on hand-made runs, both rooflines' work
formulas, and the trace reduction on hand-made device events."""
import numpy as np
import pytest

from fvsbench_testkit import harness
from fvsbench import devtrace, peaks

COUNTERS = ("distance_comps", "filter_checks", "hops", "page_accesses_index",
            "page_accesses_heap", "tmap_lookups", "reorder_rows")


def batch(submitted, done, hops, dc=100, fc=1000, due=None):
    q = len(hops)
    stats = {c: np.zeros(q, np.int64) for c in COUNTERS}
    stats.update(hops=np.asarray(hops), distance_comps=np.full(q, dc),
                 filter_checks=np.full(q, fc))
    return harness.Batch(qidx=np.arange(q), submitted=submitted, done=done,
                         due=due, ids=np.zeros((q, 10), np.int32),
                         dists=np.zeros((q, 10), np.float32), stats=stats)


def make_run(method="acorn", trace=None, batches=None):
    cell = harness.Cell(name="c", chips=1, config={}, limits={},
                        traffic={"method": method}, end_to_end=[],
                        per_layer=[])
    batches = batches or [batch(0.0, 2.0, [3, 5, 4, 1]),
                          batch(2.0, 3.0, [2, 2, 6, 1])]
    run = harness.Run(cell=cell, dim=128, n=1000, k=10, setup_s=12.5,
                      window_s=4.0, batches=batches, peak_bytes=3 * 2 ** 30,
                      recall=np.array([1.0, 0.9, 0.8, 0.7, 1, 1, 1, 1]))
    run.trace = trace
    return run


def read(name, run):
    return harness.metric_reader(name)(run)


def test_end_to_end_metrics():
    run = make_run()
    assert read("qps", run) == pytest.approx(8 / 4.0)
    assert read("setup_s", run) == 12.5
    assert read("peak_gib", run) == pytest.approx(3.0)
    assert read("recall_at_10", run) == pytest.approx(7.4 / 8)
    # latencies: four queries at 2.0 s, four at 1.0 s
    assert read("p95_ms", run) == pytest.approx(2000.0)


def test_open_loop_latency_counts_from_due():
    b = batch(1.0, 1.5, [1, 1], due=np.array([0.2, 0.9]))
    run = make_run(batches=[b])
    assert list(run.latencies()) == pytest.approx([1.3, 0.6])


def test_counter_metrics():
    run = make_run()
    assert read("supersteps_per_batch", run) == pytest.approx((5 + 6) / 2)
    assert read("filter_checks_per_query", run) == 1000
    assert read("distance_comps_per_query", run) == 100
    assert read("supersteps_per_batch", make_run("scann")) is None


def test_trace_metrics_need_a_trace():
    run = make_run()
    for name in ("host_ms_per_superstep", "idle_share",
                 "graph_search_roofline", "scann_search_roofline"):
        assert read(name, run) is None


def test_trace_metrics():
    run = make_run(trace={"busy_s": 1.0, "window_s": 4.0})
    # batch walls 2.0 + 1.0 s, device busy 1.0 s, 5 + 6 supersteps
    assert read("host_ms_per_superstep", run) == pytest.approx(2000 / 11)
    assert read("idle_share", run) == pytest.approx(75.0)
    assert read("scann_search_roofline", run) is None


def test_graph_roofline_formula():
    least = harness.metric_reader("graph_search_roofline").__globals__[
        "least_seconds"]
    # bytes bound: 100 rows x 128 x 4 + 1000 words x 4 + 10 results x 8
    nbytes = 100 * 128 * 4 + 1000 * 4 + 80
    assert least(100, 1000, 10, 128) == pytest.approx(
        nbytes / peaks.HBM_BYTES_PER_S)
    # a flop-bound case: many rows of one dimension
    assert least(10 ** 9, 0, 0, 1) == pytest.approx(
        max(2e9 / peaks.FP32_FLOPS_PER_S, 4e9 / peaks.HBM_BYTES_PER_S))
    run = make_run(trace={"busy_s": 1e-3, "window_s": 4.0})
    want = least(800, 8000, 80, 128) / 1e-3 * 100
    assert read("graph_search_roofline", run) == pytest.approx(want)


def test_scann_roofline_formula():
    least = harness.metric_reader("scann_search_roofline").__globals__[
        "least_seconds"]
    nbytes = 100 * 768 + 1000 * 4 + 80
    flops = 2 * 768 * 100
    assert least(100, 1000, 10, 768) == pytest.approx(
        max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FP32_FLOPS_PER_S))
    run = make_run("scann", trace={"busy_s": 1e-3, "window_s": 4.0})
    want = least(800, 8000, 80, 128) / 1e-3 * 100
    assert read("scann_search_roofline", run) == pytest.approx(want)
    assert read("graph_search_roofline", run) is None


def test_trace_summary():
    ev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (70, 75, "c"),
          (80, 90, "c")]
    s = devtrace.summarize(ev)
    assert s["busy_s"] == pytest.approx((20 + 10 + 5 + 10) / 1e9)
    assert s["device_ops"][0] == ["a", pytest.approx(20e-9)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps == {"before a": pytest.approx(10e-9),
                    "before c": pytest.approx(35e-9)}
    assert devtrace.summarize([])["busy_s"] == 0
