"""Faults planted in the program's timed path, each of which has to turn
`correct` false.  The CPU tests plant every fault of a cell at test size;
`study.py --faults` plants them at the cell's own size on the card, where
the faults that leave every answer valid give the upper readings of the
`recall_miss` limit.

    with planted("pass_dropped", cell) as factory:
        line = harness.run_cell(..., cell=cell, factory=factory)

Answers checked one by one (`bad_answers`, `dist_err`) catch the first
three; the last ones return rows that pass their filters with exact
distances and fail only on which rows they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types

import torch

from fvsbench import harness

COMMON = ("state_unchanged", "half_left_out", "answer_altered")
# Faults that change which rows are returned and nothing else.
RECALL = {"graph": ("pass_dropped",),
          "scann": ("centroids_permuted", "sq8_scale_perturbed",
                    "sq8_scale_sign")}


def engine(cell: harness.Cell) -> str:
    return "scann" if cell.method.startswith("scann") else "graph"


def names(cell: harness.Cell) -> tuple[str, ...]:
    return COMMON + RECALL[engine(cell)]


@contextlib.contextmanager
def _patched(obj, attr: str, new):
    old = getattr(obj, attr)
    setattr(obj, attr, new)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _half_left_out(ex):
    """Half the batch searched; the other half given the first half's
    answers."""
    search = ex.search

    def half(queries, bitmaps, params):
        h = queries.shape[0] // 2
        r = search(queries[:h], bitmaps[:h], params)
        rep = lambda t: torch.cat([t, t[:queries.shape[0] - h]])  # noqa
        stats = type(r.stats)(*(rep(getattr(r.stats, f.name))
                                for f in dataclasses.fields(r.stats)))
        return types.SimpleNamespace(ids=rep(r.ids), dists=rep(r.dists),
                                     stats=stats)
    ex.search = half
    return ex


def _state_unchanged(stack, kind):
    """The engine's step leaves its result state as it found it: a
    superstep keeps its result beam, a leaf scan scores nothing."""
    from repro_torch.core import graph_search
    from repro_torch.kernels import ops
    if kind == "scann":
        real = ops.leaf_scan_batched
        stack.enter_context(_patched(
            ops, "leaf_scan_batched",
            lambda *a, **k: torch.full_like(real(*a, **k), float("inf"))))
        return
    base, it = graph_search._base_superstep, graph_search._iter_superstep

    def base_fault(*a, **k):
        s = a[6]
        return dataclasses.replace(base(*a, **k), w_d=s.w_d, w_id=s.w_id)

    def iter_fault(*a, **k):
        s = a[5]
        out = it(*a, **k)
        return (dataclasses.replace(out[0], w_d=s.w_d, w_id=s.w_id),) \
            + out[1:]
    stack.enter_context(_patched(graph_search, "_base_superstep",
                                 base_fault))
    stack.enter_context(_patched(graph_search, "_iter_superstep",
                                 iter_fault))


def _answer_altered(stack, kind):
    """A distance altered by 1e-3 where the program produces it: the
    frontier scan's, or the ScaNN reorder's exact rescoring."""
    from repro_torch.core import scann
    from repro_torch.kernels import ops
    if kind == "scann":
        real = scann.distance
        stack.enter_context(_patched(
            scann, "distance", lambda *a, **k: real(*a, **k) * 1.001))
        return
    real = ops.frontier_scan

    def scan(*a, **k):
        d, ok = real(*a, **k)
        return d * 1.001, ok
    stack.enter_context(_patched(ops, "frontier_scan", scan))


def _pass_dropped(stack, kind):
    """The graph engine's filter probes drop every odd row id:
    `frontier_scan`'s pass mask on the 1-hop frontier and the bitmap probe
    of the 2-hop one.  The search answers from half of the passing rows."""
    from repro_torch.core import graph_search
    from repro_torch.kernels import ops
    scan, probe = ops.frontier_scan, graph_search.probe_batch

    def scan_fault(queries, rows, norms, ids, bitmaps, *a, **k):
        d, ok = scan(queries, rows, norms, ids, bitmaps, *a, **k)
        return d, ok & (ids % 2 == 0)

    def probe_fault(bitmaps, ids, *a, **k):
        return probe(bitmaps, ids, *a, **k) & (ids % 2 == 0)
    stack.enter_context(_patched(ops, "frontier_scan", scan_fault))
    stack.enter_context(_patched(graph_search, "probe_batch", probe_fault))


def _centroids_permuted(stack, kind):
    """`distance_matrix`'s rows rolled by one query: each query opens the
    leaves its neighbour in the block would open."""
    from repro_torch.kernels import ops
    real = ops.distance_matrix
    stack.enter_context(_patched(
        ops, "distance_matrix",
        lambda *a, **k: real(*a, **k).roll(1, dims=0)))


def _sq8_scaled(stack, factor):
    """`leaf_scan_batched` scores the SQ8 tiles with its dequantization
    scale times `factor(scale)`."""
    from repro_torch.kernels import ops
    real = ops.leaf_scan_batched

    def scan(queries, tiles, rowids, scale, mean, *a, **k):
        return real(queries, tiles, rowids, scale * factor(scale), mean,
                    *a, **k)
    stack.enter_context(_patched(ops, "leaf_scan_batched", scan))


def _sq8_scale_perturbed(stack, kind):
    """The SQ8 scale off by a factor from 0 to 2 a dimension (a fixed
    draw)."""
    def factor(scale):
        gen = torch.Generator().manual_seed(0)
        return 2 * torch.rand(scale.shape, generator=gen).to(scale.device)
    _sq8_scaled(stack, factor)


def _sq8_scale_sign(stack, kind):
    """The SQ8 scale's sign flipped on every odd dimension."""
    def factor(scale):
        odd = torch.arange(scale.shape[0], device=scale.device) % 2 == 1
        return 1.0 - 2.0 * odd.to(scale.dtype)
    _sq8_scaled(stack, factor)


_PLANT = {"state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered,
          "pass_dropped": _pass_dropped,
          "centroids_permuted": _centroids_permuted,
          "sq8_scale_perturbed": _sq8_scale_perturbed,
          "sq8_scale_sign": _sq8_scale_sign}


@contextlib.contextmanager
def planted(name: str, cell: harness.Cell, factory=harness.build_executor):
    """Plant fault `name` in the cell's engine inside the block; yields
    the factory that makes what the window drives.  The index is built
    sound, and the fault is planted once it is."""
    if name not in names(cell):
        raise ValueError(f"no fault {name!r} for {cell.name}")
    with contextlib.ExitStack() as stack:
        def make(*args):
            ex = factory(*args)
            if name == "half_left_out":
                return _half_left_out(ex)
            _PLANT[name](stack, engine(cell))
            return ex
        yield make
