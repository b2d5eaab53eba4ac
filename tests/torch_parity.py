"""Shared fixtures and comparisons of the port's parity tests.

Two fixture kinds, each built once per test process:

* exact: integer vectors and queries in [-127, 127] (2,000 x 32), every
  dimension reaching both ends, so SQ8 has scale 1 and mean 0 and every
  float32 product and partial sum is an exact integer.  The ScaNN index's
  centroids are rounded to integers on both sides.  Distances tie often,
  which tests the tie order.  Here ids, distances and all seven counters
  must be equal bit for bit.
* float: the clustered 4,000 x 48 store of `conftest.small_dataset` with
  its m=12 graph, where sums in another order may move the last bits.

Both hold the reference objects (numpy/JAX) and their port counterparts on
the CPU, carried across through `repro_torch.interop`.
"""
from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch import interop

# The suite runs in several worker processes at once; one intra-op thread
# per process keeps PyTorch from oversubscribing the cores the reference's
# XLA runtime also uses (the port's test tensors are small).
torch.set_num_threads(1)

COUNTERS = ("distance_comps", "filter_checks", "hops", "page_accesses_index",
            "page_accesses_heap", "tmap_lookups", "reorder_rows")


def exact_vectors(n: int = 2000, dim: int = 32, nq: int = 16, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, size=(n, dim)).astype(np.float32)
    x[0, :], x[1, :] = -127, 127           # every dimension hits both ends
    q = rng.randint(-127, 128, size=(nq, dim)).astype(np.float32)
    return x, q


def torch_params(p: "R.SearchParams") -> T.SearchParams:
    return T.SearchParams(**{f.name: getattr(p, f.name)
                             for f in dataclasses.fields(p)})


def _carry(jstore, jq, jgraph, jscann, bitmaps) -> dict:
    return dict(
        jstore=jstore, jq=jnp.asarray(jq), jgraph=jgraph, jscann=jscann,
        jbitmaps={k: jnp.asarray(v) for k, v in bitmaps.items()},
        store=interop.vector_store(jstore, "cpu"),
        q=torch.as_tensor(np.array(jq)),
        graph=interop.hnsw_graph(jgraph, "cpu"),
        scann=interop.scann_index(jscann, "cpu"),
        bitmaps={k: interop.bitmaps(v, "cpu") for k, v in bitmaps.items()})


def _workload_bitmaps(jstore, jq) -> dict:
    return {
        "med_pos_0.1": np.asarray(R.generate_bitmaps(
            jstore, jnp.asarray(jq), R.WorkloadSpec(0.10, "med_pos"), 1)),
        "none_0.02": np.asarray(R.generate_bitmaps(
            jstore, jnp.asarray(jq), R.WorkloadSpec(0.02, "none"), 2)),
    }


@functools.lru_cache(maxsize=None)
def exact_fixture() -> dict:
    x, q = exact_vectors()
    jstore = R.VectorStore.build(x)
    jgraph = R.build_graph(jstore, m=8, ef_construction=32, seed=0)
    jscann = R.build_scann(jstore, num_leaves=32, levels=2, seed=0)
    jscann = dataclasses.replace(
        jscann, leaf_centroids=jnp.round(jscann.leaf_centroids),
        branch_centroids=jnp.round(jscann.branch_centroids))
    assert np.all(np.asarray(jscann.scale) == 1.0)
    assert np.all(np.asarray(jscann.mean) == 0.0)
    return _carry(jstore, q, jgraph, jscann, _workload_bitmaps(jstore, q))


@functools.lru_cache(maxsize=None)
def float_fixture() -> dict:
    # the same store and graph as conftest's small_dataset / small_graph
    from repro.data import DatasetSpec, make_dataset
    jstore, jq = make_dataset(DatasetSpec("t-small", 4000, 48, "l2",
                                          clusters=16), num_queries=8,
                              seed=0)
    jgraph = R.build_graph(jstore, m=12, ef_construction=48, seed=0)
    jscann = R.build_scann(jstore, num_leaves=48, levels=2, seed=0)
    return _carry(jstore, jq, jgraph, jscann, _workload_bitmaps(jstore, jq))


FIXTURES = {"exact": exact_fixture, "float": float_fixture}


@pytest.fixture(params=sorted(FIXTURES), scope="module")
def fixture_kind(request):
    return request.param


def run_both(fx: dict, method: str, params: "R.SearchParams",
             workload: str = "med_pos_0.1"):
    jres = R.make_executor(method, fx["jstore"], graph=fx["jgraph"],
                           index=fx["jscann"]).search(
        fx["jq"], fx["jbitmaps"][workload], params)
    tres = T.make_executor(method, fx["store"], graph=fx["graph"],
                           index=fx["scann"], device="cpu").search(
        fx["q"], fx["bitmaps"][workload], torch_params(params))
    return jres, tres


def stats_np(stats) -> dict:
    return {k: np.asarray(v) for k, v in stats.as_dict().items()}


def assert_same(jres, tres) -> None:
    """ids, distances and every counter equal, bit for bit."""
    np.testing.assert_array_equal(np.asarray(jres.ids), tres.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jres.dists).view(np.int32),
                                  tres.dists.numpy().view(np.int32))
    js, ts = stats_np(jres.stats), stats_np(tres.stats)
    for k in COUNTERS:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)


def recall_vs(ids_a, ids_b, k: int = 10) -> float:
    """Mean share of the reference's valid ids (`ids_b`) found in `ids_a`;
    a query with no valid reference id counts 1."""
    a, b = np.asarray(ids_a)[:, :k], np.asarray(ids_b)[:, :k]
    hit = [len(set(x[x >= 0]) & set(y[y >= 0])) / max(int((y >= 0).sum()), 1)
           for x, y in zip(a, b)]
    return float(np.mean(hit))


def assert_close(jres, tres, counter_rtol: float = 0.02) -> None:
    """Float fixtures: recall against the reference's ids within 0.01 and
    each counter's batch mean within `counter_rtol` (sums taken in another
    order can flip a near-tie and move a traversal by a step)."""
    assert recall_vs(tres.ids.numpy(), jres.ids) >= 0.99
    js, ts = stats_np(jres.stats), stats_np(tres.stats)
    for k in COUNTERS:
        a, b = float(js[k].mean()), float(ts[k].mean())
        assert abs(a - b) <= counter_rtol * max(abs(a), 1.0), (k, a, b)


def check(kind: str, jres, tres) -> None:
    if kind == "exact":
        assert_same(jres, tres)
    else:
        assert_close(jres, tres)
