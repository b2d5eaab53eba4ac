"""The frontier-scan CUDA kernels (csrc/frontier_scan.cu) and their plain
versions.

Score each in-flight query's candidate ids of one graph superstep and probe
its filter bitmap: on full-precision rows (`frontier_scan`), on the SQ8
shadow rows dequantized in the kernel (`frontier_scan_sq8`), and either of
the two with the FAVOR keep mask (`frontier_scan_excl`,
`frontier_scan_excl_sq8`).  The kernels gather every candidate row and
radius by id from the (n, d) store and the (R + F, n) radius table, so no
(Q, C, d) block and no (Q, n) radius block is ever built.  All four share
one launch: a resident wave of one-warp (query, 32-candidate) items with
no limit of its own on Q, C or d beyond the C ints that carry them; an
empty batch launches nothing and counts no launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import frontier_scan_ref as plain  # noqa: F401


def _common(name, queries, rows, row_dtype, norms, ids, bitmaps, metric):
    """Check the arguments every variant takes; returns the kernel's int
    arguments (Q, C, d, W, n, metric code, vec4)."""
    code = build.metric_code(metric, name)
    qn, d = queries.shape
    n = rows.shape[0]
    c = ids.shape[1]
    w = bitmaps.shape[1]
    build.require(queries, torch.float32, (qn, d), "queries")
    build.require(rows, row_dtype, (n, d), "rows")
    build.require(norms, torch.float32, (n,), "norms")
    build.require(ids, torch.int32, (qn, c), "ids")
    build.require(bitmaps, torch.int32, (bitmaps.shape[0], w), "bitmaps")
    if bitmaps.shape[0] != qn or w * 32 < n:
        raise ValueError("bitmaps must be (Q, ceil(n/32)) words")
    if max(qn, c, d) >= 2 ** 31:
        # the grid strides over (query, 32-candidate) items with no limit
        # of its own; Q, C and d are C ints
        raise ValueError(f"{name} kernel: Q={qn}, C={c}, d={d} too large")
    for t in (rows, norms, ids, bitmaps):
        if t.device != queries.device:
            raise ValueError(f"{name}: tensors on different devices")
    align = 16 if row_dtype == torch.float32 else 4
    vec4 = int(d % 4 == 0 and rows.data_ptr() % align == 0)
    return qn, c, d, w, n, code, vec4


def _dequant_args(scale, mean, d, dev):
    build.require(scale, torch.float32, (d,), "scale")
    build.require(mean, torch.float32, (d,), "mean")
    if scale.device != dev or mean.device != dev:
        raise ValueError("scale/mean on another device than the queries")


def _excl_args(table, radius_row, tau, qn, n, dev):
    build.require(table, torch.float32, (table.shape[0], n), "radius table")
    build.require(radius_row, torch.int32, (qn,), "radius_row")
    build.require(tau, torch.float32, (qn,), "tau")
    for t in (table, radius_row, tau):
        if t.device != dev:
            raise ValueError("radii on another device than the queries")


def _launch(entry: str, name: str, inputs, ints, margin=None):
    """Allocate (dists, pass) and, with a margin, keep; launch `entry` on
    the inputs' and outputs' pointers, the margin and the ints; count the
    launch under `name`.  An empty batch launches nothing and counts
    nothing.  The stream is read as a raw handle: no Stream object a call."""
    dev = inputs[0].device
    qn, c = ints[:2]
    outs = [torch.empty((qn, c), dtype=torch.float32, device=dev),
            torch.empty((qn, c), dtype=torch.bool, device=dev)]
    if margin is not None:
        outs.append(torch.empty((qn, c), dtype=torch.bool, device=dev))
    if qn and c:
        status = getattr(build.load("frontier_scan"), entry)(
            *(t.data_ptr() for t in (*inputs, *outs)),
            *(() if margin is None else (float(margin),)), *ints,
            torch._C._cuda_getCurrentRawStream(dev.index))
        build.check(status, name)
    return tuple(outs)


def frontier_scan_cuda(queries: torch.Tensor, rows: torch.Tensor,
                       norms: torch.Tensor, ids: torch.Tensor,
                       bitmaps: torch.Tensor, metric: str = "l2"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, d) f32, rows (n, d) f32, norms (n,) f32, ids (Q, C)
    int32, bitmaps (Q, W) int32, all on one CUDA device and contiguous
    -> (dists (Q, C) f32, pass (Q, C) bool)."""
    ints = _common("frontier_scan", queries, rows, torch.float32, norms, ids,
                   bitmaps, metric)
    return _launch("frontier_scan_f32", "frontier_scan",
                   (queries, rows, norms, ids, bitmaps), ints)


def frontier_scan_sq8_cuda(queries, qrows, scale, mean, norms, ids, bitmaps,
                           metric: str = "l2"):
    """As `frontier_scan_cuda` on SQ8 shadow rows: qrows (n, d) int8,
    scale/mean (d,) f32, norms (n,) the dequantized rows' ||x̂||^2."""
    ints = _common("frontier_scan_sq8", queries, qrows, torch.int8, norms,
                   ids, bitmaps, metric)
    _dequant_args(scale, mean, ints[2], queries.device)
    return _launch("frontier_scan_sq8", "frontier_scan_sq8",
                   (queries, qrows, scale, mean, norms, ids, bitmaps), ints)


def frontier_scan_excl_cuda(queries, rows, norms, ids, bitmaps, table,
                            radius_row, tau, metric: str = "l2",
                            margin: float = 0.5):
    """`frontier_scan_cuda` plus the keep mask: table (R + F, n) f32
    squared radii, radius_row (Q,) int32, tau (Q,) f32
    -> (dists, pass, keep)."""
    ints = _common("frontier_scan_excl", queries, rows, torch.float32, norms,
                   ids, bitmaps, metric)
    _excl_args(table, radius_row, tau, ints[0], ints[4], queries.device)
    return _launch("frontier_scan_excl_f32", "frontier_scan_excl",
                   (queries, rows, norms, ids, bitmaps, table, radius_row,
                    tau), ints, margin)


def frontier_scan_excl_sq8_cuda(queries, qrows, scale, mean, norms, ids,
                                bitmaps, table, radius_row, tau,
                                metric: str = "l2", margin: float = 0.5):
    """`frontier_scan_sq8_cuda` plus the keep mask on the quantized
    distances."""
    ints = _common("frontier_scan_excl_sq8", queries, qrows, torch.int8,
                   norms, ids, bitmaps, metric)
    _dequant_args(scale, mean, ints[2], queries.device)
    _excl_args(table, radius_row, tau, ints[0], ints[4], queries.device)
    return _launch("frontier_scan_excl_sq8", "frontier_scan_excl_sq8",
                   (queries, qrows, scale, mean, norms, ids, bitmaps, table,
                    radius_row, tau), ints, margin)
