"""Dispatch of the kernels the search path and the encoder prefill run.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, which raises when it cannot build
or launch.  There is no fallback between the two.  The one dispatch by
metric is the reference's: the frontier scans have no cos kernel, and a
cos store's graph search runs their plain versions on either device, as
the reference's `frontier_scan*` send cos to the oracle always.  `launches()` reads how
often each kernel ran since `reset_launches()`, `routes()` how often each
route of a kernel with several (flash attention's) did.

While a cost counter (`launch.op_cost.CostCounter`) is open, each entry
point charges its call as the reference's cost model charges the
`pallas_call` it stands for (`_charge_*`: the operands the reference
passes its kernel, padded as it pads them, plus the outputs, and the
kernel's arithmetic) and then launches the kernel on the card; on the
meta device it returns empty outputs of the kernel's shapes, or, with the
counter's `fused_kernels` off, runs the plain version op by op, as it
does on the CPU.  With no counter open the only cost is one test of
`op_cost.ACTIVE`.
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
from repro_torch.launch import op_cost

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


def _up(n: int, m: int) -> int:
    return n + (-n) % m


def _counted(name: str, entry, args: tuple, plain, charge, fused=True):
    """A kernel entry point's call while a cost counter is open: charged
    as the kernel (`charge` = (flops, bytes, [(shape, dtype), ...] of the
    outputs)) on the card, on meta with `fused_kernels`, and on the CPU
    with `fused_kernels` (the plain version computing the values
    uncharged); else the plain version, its ops charged one by one."""
    counter = op_cost.ACTIVE
    dev = args[0].device.type
    if not fused or (dev in ("cpu", "meta") and not counter.fused_kernels):
        return plain(*args)
    flops, nbytes, outs = charge
    counter.kernel(name, flops, nbytes)
    with counter.paused():
        if dev == "meta":
            made = tuple(torch.empty(s, dtype=d, device="meta")
                         for s, d in outs)
            return made[0] if len(made) == 1 else made
        return entry(*args)


_F32, _I32 = torch.float32, torch.int32


def _charge_distance_matrix(queries, rows):
    """`distance_matrix_pallas`: Q padded to its block (min(128, max(8,
    Q))), N to 128, d to 128; one (bq, d) x (d, bn) product a step."""
    q0, n0, d0 = queries.shape[0], rows.shape[0], rows.shape[1]
    qp = _up(q0, min(128, max(8, q0)))
    np_, dp = _up(n0, 128), _up(d0, 128)
    return (2.0 * qp * np_ * dp, 4.0 * (qp * dp + np_ * dp + qp * np_),
            [((q0, n0), _F32)])


def _charge_leaf_scan_batched(queries, tiles, bitmaps):
    """`leaf_scan_batched_pallas`: Q padded to 8, C to 128, d to 128; one
    (Qp, d) x (d, C) product for each of the U tiles."""
    u, c, d = tiles.shape
    q0, w = queries.shape[0], bitmaps.shape[1]
    qp, cp, dp = _up(q0, 8), _up(c, 128), _up(d, 128)
    nbytes = (4.0 * qp * dp + u * cp * dp * tiles.element_size()
              + 4.0 * u * cp * 2 + 4.0 * 2 * dp + 4.0 * qp * w
              + 4.0 * u * qp * cp)
    return 2.0 * u * qp * cp * dp, nbytes, [((q0, u, c), _F32)]


def _charge_leaf_scan(nq: int, nl: int, tiles, w: int):
    """`leaf_scan_pallas` for each of `nq` queries (the reference vmaps
    it): C padded to 8, d to 128; the opened tiles (nq x nl of them, not
    the table), their rowids, the query, scale, mean and bitmap in, the
    (nl, C) scores out; one (C, d) x (d,) product a tile."""
    c, d = tiles.shape[1], tiles.shape[2]
    cp, dp = _up(c, 8), _up(d, 128)
    nbytes = nq * (4.0 * dp + nl * cp * dp * tiles.element_size()
                   + 4.0 * nl * cp + 4.0 * w + 4.0 * nl * cp) \
        + 4.0 * 2 * dp
    return 2.0 * nq * nl * cp * dp, nbytes


def _charge_topk(values, k: int):
    """`topk_pallas`: n padded to its block (min(1024, max(k, n))); the
    (1, n) values in, (nb, k) values and indices out; no FLOPs."""
    n = values.shape[0]
    blk = min(1024, max(k, n))
    np_ = _up(n, blk)
    return 0.0, 4.0 * np_ + 8.0 * (np_ // blk) * k, [((k,), _F32),
                                                    ((k,), _I32)]


def _charge_frontier(queries, ids, bitmaps, row_bytes: int, sq8: bool,
                     excl: bool):
    """The frontier scans: C padded to 128, d to 128; the gathered chunk
    (Q, C, d) at `row_bytes` an element, its norms and ids, the bitmaps
    (and scale / mean for SQ8; the gathered radii and tau for the keep
    mask) in; dists f32 and pass int8 (and keep int8) out; one (C, d) x
    (d,) product a query."""
    q0, d = queries.shape
    c, w = ids.shape[1], bitmaps.shape[1]
    cp, dp = _up(c, 128), _up(d, 128)
    nbytes = 4.0 * q0 * dp + q0 * cp * dp * row_bytes + 4.0 * q0 * cp * 2 \
        + 4.0 * q0 * w + q0 * cp * (4.0 + 1.0)
    if sq8:
        nbytes += 4.0 * 2 * dp
    outs = [((q0, c), _F32), ((q0, c), torch.bool)]
    if excl:
        nbytes += 4.0 * q0 * cp + 4.0 * q0 + 1.0 * q0 * cp
        outs.append(((q0, c), torch.bool))
    return 2.0 * q0 * cp * dp, nbytes, outs


def _charge_flash(q, k):
    """`flash_attention_pallas`, as `count_jaxpr` recognises it: T and S
    padded to their blocks (min(512, T), min(512, S)); 4 x B·KV x T x G x
    hd x S FLOPs (both products over the whole S, causal or not); q, k, v
    and the output in q's dtype."""
    b, t, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    tp = _up(t, min(512, t))
    sp = _up(s_len, min(512, s_len))
    es = q.element_size()
    nbytes = es * (2.0 * b * tp * h * hd + 2.0 * b * sp * kv * hd)
    return 4.0 * b * tp * h * hd * sp, nbytes, [(tuple(q.shape), q.dtype)]


def distance_matrix(queries: torch.Tensor, rows: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """(Q, N) distances between queries (Q, d) and rows (N, d)."""
    if op_cost.ACTIVE is not None:
        return _counted("distance_matrix", distance_matrix,
                        (queries, rows, metric), ref.distance_matrix_ref,
                        _charge_distance_matrix(queries, rows))
    if _on_cuda(queries, "distance_matrix"):
        return distance_matrix_cuda(queries.contiguous(), rows.contiguous(),
                                    metric)
    return ref.distance_matrix_ref(queries, rows, metric)


def leaf_scan_batched(queries, tiles, rowids, scale, mean, bitmaps,
                      row_norms_sq, metric: str = "l2") -> torch.Tensor:
    """(Q, U, C) filtered scores of every query against every row of the U
    opened int8 leaf tiles."""
    if op_cost.ACTIVE is not None:
        return _counted(
            "leaf_scan_batched", leaf_scan_batched,
            (queries, tiles, rowids, scale, mean, bitmaps, row_norms_sq,
             metric), ref.leaf_scan_batched_ref,
            _charge_leaf_scan_batched(queries, tiles, bitmaps))
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
    if op_cost.ACTIVE is not None:
        return _counted(
            "leaf_scan", leaf_scan,
            (query, tiles, rowids, scale, mean, bitmap, metric),
            ref.leaf_scan_ref,
            (*_charge_leaf_scan(1, tiles.shape[0], tiles, bitmap.shape[0]),
             [((tiles.shape[0], tiles.shape[1]), _F32)]))
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
    if op_cost.ACTIVE is not None:
        qn, nl = leaf_ids.shape
        return _counted(
            "leaf_scan", leaf_scan_ids,
            (queries, leaf_ids, tiles, rowids, scale, mean, bitmaps,
             metric), ref.leaf_scan_ids_ref,
            (*_charge_leaf_scan(qn, nl, tiles, bitmaps.shape[1]),
             [((qn, nl, tiles.shape[1]), _F32)]))
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
    if op_cost.ACTIVE is not None:
        return _counted("topk", topk_smallest, (values, k),
                        ref.topk_partial_ref, _charge_topk(values, k))
    if _on_cuda(values, "topk"):
        return topk_cuda(values.to(torch.float32).contiguous(), k)
    return ref.topk_partial_ref(values, k)


def frontier_scan(queries, rows, norms, ids, bitmaps, metric: str = "l2"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists (Q, C), pass (Q, C)) of each query's candidate ids, gathered
    from the (n, d) store rows; +inf / False at -1 padding."""
    if op_cost.ACTIVE is not None:
        return _counted(
            "frontier_scan", frontier_scan,
            (queries, rows, norms, ids, bitmaps, metric),
            ref.frontier_scan_ref,
            _charge_frontier(queries, ids, bitmaps, 4, False, False),
            fused=metric != "cos")
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
    if op_cost.ACTIVE is not None:
        return _counted(
            "frontier_scan_sq8", frontier_scan_sq8,
            (queries, qrows, scale, mean, norms, ids, bitmaps, metric),
            ref.frontier_scan_sq8_ref,
            _charge_frontier(queries, ids, bitmaps, 1, True, False),
            fused=metric != "cos")
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
    if op_cost.ACTIVE is not None:
        return _counted(
            "frontier_scan_excl", frontier_scan_excl,
            (queries, rows, norms, ids, bitmaps, table, radius_row, tau,
             metric, margin), ref.frontier_scan_excl_ref,
            _charge_frontier(queries, ids, bitmaps, 4, False, True),
            fused=metric != "cos")
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
    if op_cost.ACTIVE is not None:
        return _counted(
            "frontier_scan_excl_sq8", frontier_scan_excl_sq8,
            (queries, qrows, scale, mean, norms, ids, bitmaps, table,
             radius_row, tau, metric, margin),
            ref.frontier_scan_excl_sq8_ref,
            _charge_frontier(queries, ids, bitmaps, 1, True, True),
            fused=metric != "cos")
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
    if op_cost.ACTIVE is not None:
        return _counted("flash_attention", flash_attention_fused,
                        (q, k, v, causal), ref.flash_attention_ref,
                        _charge_flash(q, k))
    if _on_cuda(q, "flash_attention"):
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal)
    return ref.flash_attention_ref(q, k, v, causal)
