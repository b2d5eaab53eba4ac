"""The distance-matrix CUDA kernel (csrc/distance.cu) and its plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import distance_matrix_ref as plain  # noqa: F401


def distance_matrix_cuda(queries: torch.Tensor, rows: torch.Tensor,
                         metric: str = "l2") -> torch.Tensor:
    """queries (Q, d) f32, rows (N, d) f32 on one CUDA device -> (Q, N)
    f32 distances (L2 or negated inner product)."""
    code = build.metric_code(metric, "distance_matrix")
    qn, d = queries.shape
    nr = rows.shape[0]
    build.require(queries, torch.float32, (qn, d), "queries")
    build.require(rows, torch.float32, (nr, d), "rows")
    if rows.device != queries.device:
        raise ValueError("distance_matrix: tensors on different devices")
    if -(-qn // 64) > 65535:
        raise ValueError(f"distance_matrix kernel: Q={qn} too large")
    out = torch.empty((qn, nr), dtype=torch.float32, device=queries.device)
    lib = build.load("distance")
    status = lib.distance_matrix_f32(
        queries.data_ptr(), rows.data_ptr(), out.data_ptr(), qn, nr, d,
        code,
        torch.cuda.current_stream(queries.device).cuda_stream)
    build.check(status, "distance_matrix")
    return out
