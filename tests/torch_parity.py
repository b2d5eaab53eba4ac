"""Shared fixtures and comparisons of the port's parity tests.

Three fixture kinds, each built once per test process:

* exact: integer vectors and queries in [-127, 127] (2,000 x 32), every
  dimension reaching both ends, so SQ8 has scale 1 and mean 0 and every
  float32 product and partial sum is an exact integer.  The ScaNN index's
  centroids are rounded to integers on both sides.  Distances tie often,
  which tests the tie order.  Here ids, distances and all seven counters
  must be equal bit for bit.
* float: the clustered 4,000 x 48 store of `conftest.small_dataset` with
  its m=12 graph, where sums in another order may move the last bits.
* sq8_exact: the exact fixture's store with its SQ8 shadow attached on
  both sides.  Every column spans [-127, 127], so `sq8_quantize` gives
  scale 1 and mean 0 exactly and the dequantized rows are the integers:
  the SQ8 tier, the exclusion radii and the family subgraphs are bit-equal
  to the reference here too.

Each holds the reference objects (numpy/JAX) and their port counterparts on
the CPU, carried across through `repro_torch.interop`.  `tiers` adds the
selectivity-aware artifacts of a fixture: four predicate families, a
family query batch, the reference's exclusion index and partitioned graph,
each carried across.
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


@functools.lru_cache(maxsize=None)
def sq8_exact_fixture() -> dict:
    fx = dict(exact_fixture())
    jstore = R.quantize_store(fx["jstore"])
    assert np.all(np.asarray(jstore.q_scale) == 1.0)
    assert np.all(np.asarray(jstore.q_mean) == 0.0)
    fx.update(jstore=jstore, store=interop.vector_store(jstore, "cpu"))
    return fx


FIXTURES["sq8_exact"] = sq8_exact_fixture
FAMILY_SEL = 0.05


@functools.lru_cache(maxsize=None)
def tiers(kind: str) -> dict:
    """The fixture plus its selectivity-aware artifacts (reference-built,
    carried across): "family" workload bitmaps, exclusion, partitions."""
    fx = dict(FIXTURES[kind]())
    fams = R.generate_families(fx["jstore"], FAMILY_SEL, num_families=4,
                               seed=0)
    bm, assign = R.assign_family_bitmaps(fams, int(fx["jq"].shape[0]),
                                         seed=1)
    jexcl = R.build_exclusion(fx["jstore"], families=fams)
    # partitions carry the SQ8 shadow, so partitioned_sq8 runs on them
    jparts = R.build_graph_partitioned(R.quantize_store(fx["jstore"]), fams,
                                       m=8, ef_construction=32, seed=0)
    fx["jbitmaps"] = dict(fx["jbitmaps"], family=jnp.asarray(bm))
    fx["bitmaps"] = dict(fx["bitmaps"], family=interop.bitmaps(bm, "cpu"))
    fx.update(jfams=fams, fams=interop.families(fams, "cpu"), assign=assign,
              jexcl=jexcl, excl=interop.exclusion_index(jexcl, "cpu"),
              jparts=jparts,
              parts=interop.partitioned_graph(jparts, "cpu"))
    return fx


def run_both(fx: dict, method: str, params: "R.SearchParams",
             workload: str = "med_pos_0.1", storage=None, **kw):
    """The method on both sides on the same data; `kw` may name
    planner_candidates, `storage` a (reference, port) pair of storage
    engines.  Exclusion and partitions ride along when the fixture has
    them."""
    jkw, tkw = dict(kw), dict(kw)
    if storage is not None:
        jkw["storage"], tkw["storage"] = storage
    if "jexcl" in fx:
        jkw.update(exclusion=fx["jexcl"], partitions=fx["jparts"])
        tkw.update(exclusion=fx["excl"], partitions=fx["parts"])
    jres = R.make_executor(method, fx["jstore"], graph=fx["jgraph"],
                           index=fx["jscann"], **jkw).search(
        fx["jq"], fx["jbitmaps"][workload], params)
    tres = T.make_executor(method, fx["store"], graph=fx["graph"],
                           index=fx["scann"], device="cpu", **tkw).search(
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
    if kind in ("exact", "sq8_exact"):
        assert_same(jres, tres)
    else:
        assert_close(jres, tres)
