"""Dispatch of the three kernels the search path runs.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, which raises when it cannot build
or launch.  There is no fallback between the two.  `launches()` reads how
often each kernel ran since `reset_launches()`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.distance import distance_matrix_cuda
from repro_torch.kernels.frontier_scan import frontier_scan_cuda
from repro_torch.kernels.leaf_scan import leaf_scan_batched_cuda

KERNELS = tuple(build.LAUNCHES)


def launches() -> dict[str, int]:
    return dict(build.LAUNCHES)


def reset_launches() -> None:
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {t.device}")


def distance_matrix(queries: torch.Tensor, rows: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """(Q, N) distances between queries (Q, d) and rows (N, d)."""
    if _on_cuda(queries, "distance_matrix"):
        return distance_matrix_cuda(queries.contiguous(), rows.contiguous(),
                                    metric)
    return ref.distance_matrix_ref(queries, rows, metric)


def leaf_scan_batched(queries, tiles, rowids, scale, mean, bitmaps,
                      row_norms_sq, metric: str = "l2") -> torch.Tensor:
    """(Q, U, C) filtered scores of every query against every row of the U
    opened int8 leaf tiles."""
    if _on_cuda(queries, "leaf_scan_batched"):
        return leaf_scan_batched_cuda(
            queries.contiguous(), tiles.contiguous(), rowids.contiguous(),
            scale.contiguous(), mean.contiguous(), bitmaps.contiguous(),
            row_norms_sq.contiguous(), metric)
    return ref.leaf_scan_batched_ref(queries, tiles, rowids, scale, mean,
                                     bitmaps, row_norms_sq, metric)


def frontier_scan(queries, rows, norms, ids, bitmaps, metric: str = "l2"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists (Q, C), pass (Q, C)) of each query's candidate ids, gathered
    from the (n, d) store rows; +inf / False at -1 padding."""
    if _on_cuda(queries, "frontier_scan"):
        return frontier_scan_cuda(queries.contiguous(), rows.contiguous(),
                                  norms.contiguous(),
                                  ids.to(torch.int32).contiguous(),
                                  bitmaps.contiguous(), metric)
    return ref.frontier_scan_ref(queries, rows, norms, ids, bitmaps, metric)
