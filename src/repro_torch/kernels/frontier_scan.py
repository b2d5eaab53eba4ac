"""The frontier-scan CUDA kernels (csrc/frontier_scan.cu) and their plain
versions.

Score each in-flight query's candidate ids of one graph superstep and probe
its filter bitmap: on full-precision rows (`frontier_scan`), on the SQ8
shadow rows dequantized in the kernel (`frontier_scan_sq8`), and either of
the two with the FAVOR keep mask (`frontier_scan_excl`,
`frontier_scan_excl_sq8`).  The kernels gather every candidate row and
radius by id from the (n, d) store and the (R + F, n) radius table, so no
(Q, C, d) block and no (Q, n) radius block is ever built.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import frontier_scan_ref as plain  # noqa: F401


def _common(name, queries, rows, row_dtype, norms, ids, bitmaps, metric,
            staged: bool):
    """Check the arguments every variant takes; returns (metric code,
    Q, C, d, W, n, vec4).  `staged`: the kernel stages the query in shared
    memory, one block row a query (the exclusion variants)."""
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
    if staged:
        # grid.y is the query, and the query (and, for SQ8, scale and mean)
        # fits the 48 KB of shared memory a launch gets by default
        if qn > 65535 or d > (12288 if row_dtype == torch.float32
                              else 4096):
            raise ValueError(f"{name} kernel: Q={qn}, d={d} too large")
    elif max(qn, c, d) >= 2 ** 31:
        # the grid strides over (query, 32-candidate) items with no limit
        # of its own; Q, C and d are C ints
        raise ValueError(f"{name} kernel: Q={qn}, C={c}, d={d} too large")
    for t in (rows, norms, ids, bitmaps):
        if t.device != queries.device:
            raise ValueError(f"{name}: tensors on different devices")
    align = 16 if row_dtype == torch.float32 else 4
    vec4 = int(d % 4 == 0 and rows.data_ptr() % align == 0)
    return code, qn, c, d, w, n, vec4


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


def _outputs(qn, c, dev, keep: bool):
    outs = [torch.empty((qn, c), dtype=torch.float32, device=dev),
            torch.empty((qn, c), dtype=torch.bool, device=dev)]
    if keep:
        outs.append(torch.empty((qn, c), dtype=torch.bool, device=dev))
    return outs


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def frontier_scan_cuda(queries: torch.Tensor, rows: torch.Tensor,
                       norms: torch.Tensor, ids: torch.Tensor,
                       bitmaps: torch.Tensor, metric: str = "l2"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, d) f32, rows (n, d) f32, norms (n,) f32, ids (Q, C)
    int32, bitmaps (Q, W) int32, all on one CUDA device and contiguous
    -> (dists (Q, C) f32, pass (Q, C) bool)."""
    code, qn, c, d, w, n, vec4 = _common(
        "frontier_scan", queries, rows, torch.float32, norms, ids, bitmaps,
        metric, staged=False)
    dev = queries.device
    dist, ok = _outputs(qn, c, dev, keep=False)
    if qn == 0 or c == 0:         # nothing to launch, nothing to count
        return dist, ok
    # the stream is read as a raw handle: no Stream object a call
    status = build.load("frontier_scan").frontier_scan_f32(
        queries.data_ptr(), rows.data_ptr(), norms.data_ptr(),
        ids.data_ptr(), bitmaps.data_ptr(), dist.data_ptr(), ok.data_ptr(),
        qn, c, d, w, n, code, vec4,
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(status, "frontier_scan")
    return dist, ok


def frontier_scan_sq8_cuda(queries, qrows, scale, mean, norms, ids, bitmaps,
                           metric: str = "l2"):
    """As `frontier_scan_cuda` on SQ8 shadow rows: qrows (n, d) int8,
    scale/mean (d,) f32, norms (n,) the dequantized rows' ||x̂||^2."""
    code, qn, c, d, w, n, vec4 = _common(
        "frontier_scan_sq8", queries, qrows, torch.int8, norms, ids, bitmaps,
        metric, staged=False)
    dev = queries.device
    _dequant_args(scale, mean, d, dev)
    dist, ok = _outputs(qn, c, dev, keep=False)
    if qn == 0 or c == 0:
        return dist, ok
    status = build.load("frontier_scan").frontier_scan_sq8(
        queries.data_ptr(), qrows.data_ptr(), scale.data_ptr(),
        mean.data_ptr(), norms.data_ptr(), ids.data_ptr(),
        bitmaps.data_ptr(), dist.data_ptr(), ok.data_ptr(),
        qn, c, d, w, n, code, vec4,
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(status, "frontier_scan_sq8")
    return dist, ok


def frontier_scan_excl_cuda(queries, rows, norms, ids, bitmaps, table,
                            radius_row, tau, metric: str = "l2",
                            margin: float = 0.5):
    """`frontier_scan_cuda` plus the keep mask: table (R + F, n) f32
    squared radii, radius_row (Q,) int32, tau (Q,) f32
    -> (dists, pass, keep)."""
    code, qn, c, d, w, n, vec4 = _common(
        "frontier_scan_excl", queries, rows, torch.float32, norms, ids,
        bitmaps, metric, staged=True)
    dev = queries.device
    _excl_args(table, radius_row, tau, qn, n, dev)
    dist, ok, keep = _outputs(qn, c, dev, keep=True)
    status = build.load("frontier_scan").frontier_scan_excl_f32(
        queries.data_ptr(), rows.data_ptr(), norms.data_ptr(),
        ids.data_ptr(), bitmaps.data_ptr(), table.data_ptr(),
        radius_row.data_ptr(), tau.data_ptr(), dist.data_ptr(),
        ok.data_ptr(), keep.data_ptr(), float(margin),
        qn, c, d, w, n, code, vec4, _stream(dev))
    build.check(status, "frontier_scan_excl")
    return dist, ok, keep


def frontier_scan_excl_sq8_cuda(queries, qrows, scale, mean, norms, ids,
                                bitmaps, table, radius_row, tau,
                                metric: str = "l2", margin: float = 0.5):
    """`frontier_scan_sq8_cuda` plus the keep mask on the quantized
    distances."""
    code, qn, c, d, w, n, vec4 = _common(
        "frontier_scan_excl_sq8", queries, qrows, torch.int8, norms, ids,
        bitmaps, metric, staged=True)
    dev = queries.device
    _dequant_args(scale, mean, d, dev)
    _excl_args(table, radius_row, tau, qn, n, dev)
    dist, ok, keep = _outputs(qn, c, dev, keep=True)
    status = build.load("frontier_scan").frontier_scan_excl_sq8(
        queries.data_ptr(), qrows.data_ptr(), scale.data_ptr(),
        mean.data_ptr(), norms.data_ptr(), ids.data_ptr(),
        bitmaps.data_ptr(), table.data_ptr(), radius_row.data_ptr(),
        tau.data_ptr(), dist.data_ptr(), ok.data_ptr(), keep.data_ptr(),
        float(margin), qn, c, d, w, n, code, vec4, _stream(dev))
    build.check(status, "frontier_scan_excl_sq8")
    return dist, ok, keep
