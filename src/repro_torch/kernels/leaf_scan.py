"""The ScaNN leaf-scan CUDA kernels (csrc/leaf_scan.cu) and their plain
versions.  `leaf_scan_batched`: every query of a block against every row of
the opened int8 leaf tiles, in persistent blocks that own a tile of 64
queries; the bitmaps are first turned into one 64-bit pass mask per (query
tile, row id), so a row is probed once for the whole tile.  `leaf_scan`:
the legacy per-query scan, every query against its own opened leaves, read
by leaf id from the index's tile table; the card groups the (query, slot)
pairs by leaf, so each opened leaf is read, dequantized and scored once
against all the queries that opened it, in persistent blocks that walk
(leaf, up to 32 queries, 256 rows) units."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (  # noqa: F401
    leaf_scan_batched_ref as plain, leaf_scan_ids_ref as plain_per_query)


def leaf_scan_cuda(queries: torch.Tensor, leaf_ids: torch.Tensor,
                   tiles: torch.Tensor, rowids: torch.Tensor,
                   scale: torch.Tensor, mean: torch.Tensor,
                   bitmaps: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """queries (Q, d) f32, leaf_ids (Q, nl) int32 into tiles (L, C, d) int8
    and rowids (L, C) int32, scale/mean (d,) f32, bitmaps (Q, W) int32, all
    contiguous on one CUDA device -> (Q, nl, C) f32 scores, +inf where a
    row is padded or filtered out or the leaf id lies outside [0, L).
    "ip" scores the negated inner product, every other metric L2.  Seven
    launches (the grouping's four, the bitmaps turned by row id, the +inf
    fill, the scan), counted as one call; none for an empty batch.
    d <= 1664."""
    qn, d = queries.shape
    nl = leaf_ids.shape[1]
    n_leaves, c, _ = tiles.shape
    w = bitmaps.shape[1]
    build.require(queries, torch.float32, (qn, d), "queries")
    build.require(leaf_ids, torch.int32, (qn, nl), "leaf_ids")
    build.require(tiles, torch.int8, (n_leaves, c, d), "tiles")
    build.require(rowids, torch.int32, (n_leaves, c), "rowids")
    build.require(scale, torch.float32, (d,), "scale")
    build.require(mean, torch.float32, (d,), "mean")
    build.require(bitmaps, torch.int32, (qn, w), "bitmaps")
    dev = queries.device
    for t in (leaf_ids, tiles, rowids, scale, mean, bitmaps):
        if t.device != dev:
            raise ValueError("leaf_scan: tensors on different devices")
    out = torch.empty((qn, nl, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.load("leaf_scan")
    # the grouping's scratch: bucket counts, live runs, slots, units
    n_scratch = lib.leaf_scan_scratch_ints(qn, nl, n_leaves, c)
    if n_scratch < 0:
        raise ValueError(f"leaf_scan kernel: Q={qn}, nl={nl}, L={n_leaves}, "
                         f"C={c} too large for one launch")
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    # the bitmaps by row id: one bit a query, a row's bits together in
    # whole 16-byte pieces
    by_row = torch.empty((32 * w, 4 * -(-qn // 128)), dtype=torch.int32,
                         device=dev)
    status = lib.leaf_scan_f32(
        queries.data_ptr(), leaf_ids.data_ptr(), tiles.data_ptr(),
        rowids.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        bitmaps.data_ptr(), scratch.data_ptr(), by_row.data_ptr(),
        out.data_ptr(), qn, nl, n_leaves, c, d, w,
        1 if metric == "ip" else 0, n_scratch,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "leaf_scan")
    return out


def leaf_scan_batched_cuda(queries: torch.Tensor, tiles: torch.Tensor,
                           rowids: torch.Tensor, scale: torch.Tensor,
                           mean: torch.Tensor, bitmaps: torch.Tensor,
                           row_norms_sq: torch.Tensor,
                           metric: str = "l2") -> torch.Tensor:
    """queries (Q, d) f32, tiles (U, C, d) int8, rowids (U, C) int32,
    scale/mean (d,) f32, bitmaps (Q, W) int32, row_norms_sq (U, C) f32, all
    contiguous on one CUDA device -> (Q, U, C) f32 scores, +inf where a row
    is padded or filtered out.  Two launches (the pass masks, the scan),
    counted as one call."""
    code = build.metric_code(metric, "leaf_scan_batched")
    qn, d = queries.shape
    u, c, _ = tiles.shape
    w = bitmaps.shape[1]
    build.require(queries, torch.float32, (qn, d), "queries")
    build.require(tiles, torch.int8, (u, c, d), "tiles")
    build.require(rowids, torch.int32, (u, c), "rowids")
    build.require(scale, torch.float32, (d,), "scale")
    build.require(mean, torch.float32, (d,), "mean")
    build.require(bitmaps, torch.int32, (qn, w), "bitmaps")
    build.require(row_norms_sq, torch.float32, (u, c), "row_norms_sq")
    dev = queries.device
    for t in (tiles, rowids, scale, mean, bitmaps, row_norms_sq):
        if t.device != dev:
            raise ValueError("leaf_scan_batched: tensors on different devices")
    if u * c >= 2 ** 31 or -(-qn // 64) > 65535 or w >= 2 ** 26:
        raise ValueError(f"leaf_scan_batched kernel: U={u}, C={c}, Q={qn}, "
                         f"W={w} too large")
    out = torch.empty((qn, u, c), dtype=torch.float32, device=dev)
    # scratch: one 64-bit pass mask per (64-query tile, row id)
    masks = torch.empty((-(-qn // 64), 32 * w), dtype=torch.int64,
                        device=dev)
    lib = build.load("leaf_scan")
    status = lib.leaf_scan_batched_f32(
        queries.data_ptr(), tiles.data_ptr(), rowids.data_ptr(),
        scale.data_ptr(), mean.data_ptr(), bitmaps.data_ptr(),
        row_norms_sq.data_ptr(), masks.data_ptr(), out.data_ptr(), qn, u, c,
        d, w, code, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "leaf_scan_batched")
    return out
