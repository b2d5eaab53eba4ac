"""Dispatch of the kernels the search path and the encoder prefill run.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, which raises when it cannot build
or launch.  There is no fallback between the two.  The one dispatch by
metric is the reference's: the frontier scans have no cos kernel, and a
cos store's graph search runs their plain versions on either device, as
the reference's `frontier_scan*` send cos to the oracle always.  `launches()` reads how
often each kernel ran since `reset_launches()`, `routes()` how often each
route of a kernel with several (flash attention's) did.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.distance import distance_matrix_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.frontier_scan import (frontier_scan_cuda,
                                               frontier_scan_excl_cuda,
                                               frontier_scan_excl_sq8_cuda,
                                               frontier_scan_sq8_cuda)
from repro_torch.kernels.leaf_scan import (leaf_scan_batched_cuda,
                                           leaf_scan_cuda)
from repro_torch.kernels.topk import topk_cuda

KERNELS = tuple(build.LAUNCHES)


def launches() -> dict[str, int]:
    return dict(build.LAUNCHES)


def routes() -> dict[str, int]:
    return dict(build.ROUTES)


def reset_launches() -> None:
    for counts in (build.LAUNCHES, build.ROUTES):
        for k in counts:
            counts[k] = 0


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


def leaf_scan(query, tiles, rowids, scale, mean, bitmap,
              metric: str = "l2") -> torch.Tensor:
    """One query's (nl, C) filtered scores against its nl opened int8 leaf
    tiles (the reference's single-query signature): query (d,), tiles
    (nl, C, d), rowids (nl, C), bitmap (W,)."""
    if _on_cuda(query, "leaf_scan"):
        ids = torch.arange(tiles.shape[0], dtype=torch.int32,
                           device=query.device)[None]
        return leaf_scan_cuda(query[None].contiguous(), ids,
                              tiles.contiguous(), _i32(rowids),
                              scale.contiguous(), mean.contiguous(),
                              bitmap[None].contiguous(), metric)[0]
    return ref.leaf_scan_ref(query, tiles, rowids, scale, mean, bitmap,
                             metric)


def leaf_scan_ids(queries, leaf_ids, tiles, rowids, scale, mean, bitmaps,
                  metric: str = "l2") -> torch.Tensor:
    """`leaf_scan` for a batch in one launch: query q against the leaves
    leaf_ids[q] (Q, nl) of the (L, C, d) tile and (L, C) rowid tables ->
    (Q, nl, C)."""
    if _on_cuda(queries, "leaf_scan"):
        return leaf_scan_cuda(queries.contiguous(), _i32(leaf_ids),
                              tiles.contiguous(), _i32(rowids),
                              scale.contiguous(), mean.contiguous(),
                              bitmaps.contiguous(), metric)
    return ref.leaf_scan_ids_ref(queries, leaf_ids, tiles, rowids, scale,
                                 mean, bitmaps, metric)


def topk_smallest(values: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of a 1-D array: (values (k,), indices (k,) int32),
    ascending, ties to the lowest index, index -1 at +inf and past n.  The
    search engines use `core.types.topk_smallest`; this is the reference's
    `kernels.ops.topk_smallest`."""
    if _on_cuda(values, "topk"):
        return topk_cuda(values.to(torch.float32).contiguous(), k)
    return ref.topk_partial_ref(values, k)


def frontier_scan(queries, rows, norms, ids, bitmaps, metric: str = "l2"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists (Q, C), pass (Q, C)) of each query's candidate ids, gathered
    from the (n, d) store rows; +inf / False at -1 padding."""
    if _on_cuda(queries, "frontier_scan") and metric != "cos":
        return frontier_scan_cuda(queries.contiguous(), rows.contiguous(),
                                  norms.contiguous(),
                                  ids.to(torch.int32).contiguous(),
                                  bitmaps.contiguous(), metric)
    return ref.frontier_scan_ref(queries, rows, norms, ids, bitmaps, metric)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def frontier_scan_sq8(queries, qrows, scale, mean, norms, ids, bitmaps,
                      metric: str = "l2"):
    """`frontier_scan` on the (n, d) int8 SQ8 shadow rows, dequantized
    with scale/mean (d,); norms (n,) are the dequantized rows' ||x̂||^2."""
    if _on_cuda(queries, "frontier_scan_sq8") and metric != "cos":
        return frontier_scan_sq8_cuda(
            queries.contiguous(), qrows.contiguous(), scale.contiguous(),
            mean.contiguous(), norms.contiguous(), _i32(ids),
            bitmaps.contiguous(), metric)
    return ref.frontier_scan_sq8_ref(queries, qrows, scale, mean, norms, ids,
                                     bitmaps, metric)


def frontier_scan_excl(queries, rows, norms, ids, bitmaps, table,
                       radius_row, tau, metric: str = "l2",
                       margin: float = 0.5):
    """`frontier_scan` plus the FAVOR keep mask: table (R + F, n) squared
    exclusion radii, radius_row (Q,) each query's table row, tau (Q,) its
    result-queue tail -> (dists, pass, keep)."""
    if _on_cuda(queries, "frontier_scan_excl") and metric != "cos":
        return frontier_scan_excl_cuda(
            queries.contiguous(), rows.contiguous(), norms.contiguous(),
            _i32(ids), bitmaps.contiguous(), table.contiguous(),
            _i32(radius_row), tau.contiguous(), metric, margin)
    return ref.frontier_scan_excl_ref(queries, rows, norms, ids, bitmaps,
                                      table, radius_row, tau, metric, margin)


def frontier_scan_excl_sq8(queries, qrows, scale, mean, norms, ids, bitmaps,
                           table, radius_row, tau, metric: str = "l2",
                           margin: float = 0.5):
    """`frontier_scan_sq8` plus the keep mask on the quantized distances."""
    if _on_cuda(queries, "frontier_scan_excl_sq8") and metric != "cos":
        return frontier_scan_excl_sq8_cuda(
            queries.contiguous(), qrows.contiguous(), scale.contiguous(),
            mean.contiguous(), norms.contiguous(), _i32(ids),
            bitmaps.contiguous(), table.contiguous(), _i32(radius_row),
            tau.contiguous(), metric, margin)
    return ref.frontier_scan_excl_sq8_ref(queries, qrows, scale, mean, norms,
                                          ids, bitmaps, table, radius_row,
                                          tau, metric, margin)


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Flash attention as the reference's Pallas kernel computes it: q (B,
    T, H, hd), k and v (B, S, KV, hd) -> (B, T, H, hd).  One card and no
    mesh, so no shard_map: the whole batch goes to one launch."""
    if _on_cuda(q, "flash_attention"):
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal)
    return ref.flash_attention_ref(q, k, v, causal)
