"""The benchmark's run of one cell: set-up, the measured window, the
reference's checks and the metrics, all driven by data.

A cell is an entry of `BENCHMARK.json`'s `workloads`: a configuration
(`configs/<config>.json`: the dataset's shape and the index settings) and
a traffic mix (`traffic/<traffic>.json`: method, filters, batch, pool,
arrivals, search parameters).  `cells/<cell>.json` holds the limits of the
numbers that decide `correct`.  Each metric is a reader of its own in
`metrics/<name>.py`, with a `read(run)` that returns a number, or None
where it finds nothing to read; `BENCHMARK.json` says which metrics a
cell reports and in what unit.  So a new configuration, traffic mix, cell
or metric is a new file and a new entry, never an edit.

The timed path is the program's entry point: `make_executor(method, store,
graph= / index=).search(queries, bitmaps, SearchParams(...))`, a batch at
a time, until the ids and distances are on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

from fvsbench import datagen
from fvsbench import devtrace
from fvsbench import traffic as traffic_mod
from fvsbench.reference import exact

HERE = pathlib.Path(__file__).resolve().parent

GRAPH_METHODS = ("sweeping", "acorn", "navix", "iterative_scan")
# Seed streams: one for each kind of draw from the run's seed.
QUERIES, FILTERS, ORDER, ARRIVALS, WARMUP = range(5)
# Module names that may not be loaded in the process that prints a result:
# the JAX package of this repository and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """Everything one workload of BENCHMARK.json names, read from files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def method(self) -> str:
        return self.traffic["method"]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: pathlib.Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"]
                     if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(HERE / "cells" / f"{name}.json")["limits"],
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])


def metric_reader(name: str):
    """`read` of metrics/<name>.py (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "fvsbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Batch:
    qidx: np.ndarray          # (B,) pool indices
    submitted: float          # host seconds since the window opened
    done: float
    due: Optional[np.ndarray]  # (B,) open loop: when each query fell due
    ids: np.ndarray           # (B, k) int32
    dists: np.ndarray         # (B, k) f32
    stats: dict               # counter name -> (B,) int64

    @property
    def latencies(self) -> np.ndarray:
        start = self.due if self.due is not None else \
            np.full(len(self.qidx), self.submitted)
        return self.done - start


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    dim: int
    n: int
    k: int
    setup_s: float
    window_s: float
    batches: list
    peak_bytes: int
    recall: Optional[np.ndarray] = None      # (A,) per answered query
    trace: Optional[dict] = None             # trace.summarize + window_s

    @property
    def answered(self) -> int:
        return sum(len(b.qidx) for b in self.batches)

    def counter(self, name: str) -> np.ndarray:
        return np.concatenate([b.stats[name] for b in self.batches])

    def latencies(self) -> np.ndarray:
        return np.concatenate([b.latencies for b in self.batches])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def search_params(traffic: dict):
    from repro_torch.core.types import SearchParams
    return SearchParams(**traffic["params"])


def build_executor(cell: Cell, rows: torch.Tensor, seed: int, device):
    """The program's store, the index the method needs and its executor."""
    from repro_torch.core.executor import make_executor
    from repro_torch.core.types import VectorStore
    cfg, method = cell.config, cell.method
    store = VectorStore.build(rows, metric=cfg["metric"], device=device)
    graph = index = None
    if method in GRAPH_METHODS or method.endswith("_sq8"):
        from repro_torch.core.hnsw import build_graph_blocked
        graph = build_graph_blocked(store, seed=seed, device=device,
                                    **cfg["hnsw"])
    elif method.startswith("scann"):
        from repro_torch.core.scann import build_scann
        index = build_scann(store, seed=seed, device=device, **cfg["scann"])
    storage = None
    if "storage" in cell.traffic:
        from repro_torch.storage.engine import make_storage_engine
        storage = make_storage_engine(store, index=index, graph=graph,
                                      **cell.traffic["storage"])
    return make_executor(method, store, graph=graph, index=index,
                         storage=storage, device=device)


class Window:
    """The measured loop.  Closed: the next batch of `batch` pool queries
    goes out when the last is back, until `seconds` have passed.  Open:
    each query falls due on its schedule, a batch takes those due (at most
    `batch`), and every query due inside the window is served."""

    def __init__(self, cell: Cell, queries, bitmaps, order: np.ndarray,
                 due: Optional[np.ndarray], params, device):
        self.batch = cell.traffic["batch"]
        if self.batch > len(order):
            raise ValueError("batch larger than the query pool")
        self.queries, self.bitmaps, self.params = queries, bitmaps, params
        self.order = np.concatenate([order, order])
        self.order_dev = torch.as_tensor(self.order, device=device)
        self.due = due
        self.pos = 0

    def _take(self, count: int):
        p = self.pos % (len(self.order) // 2)
        self.pos += count
        return self.order[p:p + count], self.order_dev[p:p + count]

    def run_batch(self, executor, count: int, t0: float,
                  due: Optional[np.ndarray]) -> Batch:
        qidx, qdev = self._take(count)
        submitted = time.perf_counter() - t0
        res = executor.search(self.queries[qdev], self.bitmaps[qdev],
                              self.params)
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        done = time.perf_counter() - t0
        return Batch(qidx=qidx, submitted=submitted, done=done, due=due,
                     ids=ids, dists=dists, stats=res.stats)

    def run(self, executor, seconds: float) -> tuple[list, float]:
        batches = []
        t0 = time.perf_counter()
        if self.due is None:
            while time.perf_counter() - t0 < seconds:
                batches.append(self.run_batch(executor, self.batch, t0, None))
        else:
            due = self.due[self.due < seconds]
            sent = 0
            while sent < len(due):
                now = time.perf_counter() - t0
                ready = int(np.searchsorted(due, now, side="right"))
                if ready == sent:
                    time.sleep(due[sent] - now)
                    continue
                count = min(ready - sent, self.batch)
                batches.append(self.run_batch(executor, count, t0,
                                              due[sent:sent + count]))
                sent += count
        window_s = time.perf_counter() - t0
        for b in batches:   # counters come to the host after the window
            b.stats = {f.name: getattr(b.stats, f.name).cpu().numpy()
                       .astype(np.int64)
                       for f in dataclasses.fields(b.stats)}
        return batches, window_s


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def check(rows, queries, bitmaps, run: Run, device) -> dict:
    """The reference's numbers, each beside its limit, and recall."""
    n = rows.shape[0]
    qidx = torch.as_tensor(np.concatenate([b.qidx for b in run.batches]),
                           device=device)
    ids = torch.as_tensor(np.concatenate([b.ids for b in run.batches]),
                          device=device).long()
    dists = torch.as_tensor(np.concatenate([b.dists for b in run.batches]),
                            device=device)
    passing = exact.popcount(bitmaps)
    bad = exact.bad_answers(bitmaps, passing, n, qidx, ids, dists)
    err = exact.answer_error(rows, queries, qidx, ids, dists)
    # recall against the exact filtered top-k of each pool query answered
    uniq, inv = torch.unique(qidx, return_inverse=True)
    _, truth = exact.exact_knn(rows, queries[uniq], bitmaps[uniq], run.k)
    truth = truth[inv]
    hit = ((ids[:, :, None] == truth[:, None, :]) & (ids[:, :, None] >= 0)
           ).any(2).sum(1)
    want = passing[qidx].clamp(max=run.k)
    run.recall = (hit.double() / want.clamp(min=1).double()).cpu().numpy()
    # which rows came back: the share of the exact top-k that every
    # answered query together missed
    miss = 1.0 - float(run.recall.mean())
    limits = run.cell.limits
    return {"failed": int(bad.sum()),
            "checks": {"bad_answers": {"value": int(bad.sum()), "limit": 0},
                       "dist_err": {"value": err,
                                    "limit": limits["dist_err"]},
                       "recall_miss": {"value": miss,
                                       "limit": limits["recall_miss"]}}}


def run_cell(root: pathlib.Path, name: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: Optional[float] = None,
             cell: Optional[Cell] = None, factory=build_executor) -> dict:
    """One run of a cell; returns the result line (a dict).  `factory`
    makes what the window drives from (cell, rows, seed, device): the
    program's executor, or, for the control and the fault tests, what
    stands in its place."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(root, name) if cell is None else cell
    cfg, tr = cell.config, cell.traffic
    if cfg["metric"] != "l2":
        raise ValueError("the reference judges L2 configurations")
    dev = torch.device(device)

    # inputs: the benchmark's own; the table from the configuration, the
    # queries and their filters from the seed
    rows, queries = datagen.make_vectors(cfg, tr["pool"],
                                         traffic_mod.sub_seed(seed, QUERIES),
                                         dev)
    bitmaps, _ = traffic_mod.pool_bitmaps(
        rows, queries, tr, traffic_mod.sub_seed(seed, FILTERS))
    order = traffic_mod.query_order(tr["pool"],
                                    traffic_mod.sub_seed(seed, ORDER))
    due = traffic_mod.due_times(
        tr.get("arrivals", {}), int(4 * seconds * tr.get("arrivals", {})
                                    .get("rate_qps", 0)) + 1,
        traffic_mod.sub_seed(seed, ARRIVALS))
    sync(dev)
    note(f"inputs made at {time.perf_counter() - t_start:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # the program: index, executor, one warm-up batch
    executor = factory(cell, rows, cfg["data_seed"], dev)
    sync(dev)
    note(f"index built at {time.perf_counter() - t_start:.3f} s")
    params = search_params(tr)
    window = Window(cell, queries, bitmaps, order, due, params, dev)
    warm = traffic_mod.query_order(tr["pool"],
                                   traffic_mod.sub_seed(seed, WARMUP))
    warm = torch.as_tensor(warm[:tr["batch"]], device=dev)
    res = executor.search(queries[warm], bitmaps[warm], params)
    res.ids.cpu()
    sync(dev)
    setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if dev.type == "cuda"
                                   else ProfilerActivity.CPU])
    with prof if prof is not None else contextlib.nullcontext():
        batches, window_s = window.run(executor, seconds)
        sync(dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    # the program's state goes before the reference runs
    del executor, res, window
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell=cell, dim=cfg["dim"], n=cfg["n"], k=tr["params"]["k"],
              setup_s=setup_s, window_s=window_s, batches=batches,
              peak_bytes=peak)
    if prof is not None:
        t_tr = time.perf_counter()
        run.trace = devtrace.summarize(devtrace.device_events(prof))
        run.trace["window_s"] = window_s
        note(f"trace: {run.trace['events']} device events read in "
             f"{time.perf_counter() - t_tr:.3f} s")
    t_ref = time.perf_counter()
    verdict = check(rows, queries, bitmaps, run, dev)
    walls = [round((b.done - b.submitted) * 1e3, 1) for b in batches]
    note(f"batch ms: median {np.median(walls)}, first {walls[:40]}")
    note(f"set-up {setup_s:.3f} s, window {window_s:.3f} s, "
         f"{len(batches)} batches, reference {time.perf_counter() - t_ref:.3f}"
         " s")

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = verdict["checks"]
    correct = verdict["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    line: dict[str, Any] = {
        "correct": correct, "attempted": run.answered,
        "failed": verdict["failed"], "metrics": metrics,
        "device": device_info(dev, peak, run.trace)}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def device_info(dev: torch.device, peak: int, tr: Optional[dict]) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if tr is not None:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info
