"""The frontier-scan CUDA kernel (csrc/frontier_scan.cu) and its plain version.

Scores each in-flight query's candidate ids of one graph superstep and
probes its filter bitmap.  The kernel gathers every candidate row by id
from the (n, d) store, so no (Q, C, d) block is ever built.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import frontier_scan_ref as plain  # noqa: F401


def frontier_scan_cuda(queries: torch.Tensor, rows: torch.Tensor,
                       norms: torch.Tensor, ids: torch.Tensor,
                       bitmaps: torch.Tensor, metric: str = "l2"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, d) f32, rows (n, d) f32, norms (n,) f32, ids (Q, C)
    int32, bitmaps (Q, W) int32, all on one CUDA device and contiguous
    -> (dists (Q, C) f32, pass (Q, C) bool)."""
    code = build.metric_code(metric, "frontier_scan")
    qn, d = queries.shape
    n = rows.shape[0]
    c = ids.shape[1]
    w = bitmaps.shape[1]
    build.require(queries, torch.float32, (qn, d), "queries")
    build.require(rows, torch.float32, (n, d), "rows")
    build.require(norms, torch.float32, (n,), "norms")
    build.require(ids, torch.int32, (qn, c), "ids")
    build.require(bitmaps, torch.int32, (bitmaps.shape[0], w), "bitmaps")
    if bitmaps.shape[0] != qn or w * 32 < n:
        raise ValueError("bitmaps must be (Q, ceil(n/32)) words")
    if qn > 65535 or d > 12288:
        raise ValueError(f"frontier_scan kernel: Q={qn}, d={d} too large")
    dev = queries.device
    for t in (rows, norms, ids, bitmaps):
        if t.device != dev:
            raise ValueError("frontier_scan: tensors on different devices")
    dist = torch.empty((qn, c), dtype=torch.float32, device=dev)
    ok = torch.empty((qn, c), dtype=torch.bool, device=dev)
    vec4 = int(d % 4 == 0 and rows.data_ptr() % 16 == 0)
    lib = build.load("frontier_scan")
    status = lib.frontier_scan_f32(
        queries.data_ptr(), rows.data_ptr(), norms.data_ptr(),
        ids.data_ptr(), bitmaps.data_ptr(), dist.data_ptr(), ok.data_ptr(),
        qn, c, d, w, n, code, vec4,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "frontier_scan")
    return dist, ok

