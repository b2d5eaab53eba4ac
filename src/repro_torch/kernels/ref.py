"""Plain PyTorch versions of the hand-written kernels.

They are the CPU path of `ops` and the yardstick `chip_smoke.py` holds each
CUDA kernel against on the card.  Their arithmetic follows the reference's
jnp oracles: the distance matrix and the leaf scans contract with a matrix
product, the frontier scan with an elementwise product and a last-axis sum
(the search engines' `distance`); the top-k is a stable sort; flash
attention is the Pallas kernel's blocked online softmax.
"""
from __future__ import annotations

import numpy as np
import torch

INF = float("inf")

# queries `leaf_scan_ids_ref` gathers at a time: a (16, nl, C, d) f32 block
LEAF_QUERY_BLOCK = 16


def probe_batch(bitmaps: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`core.types.probe_batch`, imported at call time: importing
    `repro_torch.core` loads the search engines, which import this module
    through `kernels.ops`, so a module-level import would make a kernels
    module imported first fail on the cycle."""
    from repro_torch.core.types import probe_batch as probe
    return probe(bitmaps, ids)


def distance_matrix_ref(queries: torch.Tensor, rows: torch.Tensor,
                        metric: str = "l2") -> torch.Tensor:
    """(Q, N) distances; lower = closer.  queries (Q, d), rows (N, d) f32."""
    ip = queries @ rows.T
    if metric == "ip":
        return -ip
    qn = (queries * queries).sum(1, keepdim=True)
    rn = (rows * rows).sum(1)[None, :]
    return qn + rn - 2.0 * ip


def probe_bitmap_ref(bitmap: torch.Tensor, row_ids: torch.Tensor
                     ) -> torch.Tensor:
    """One (W,) int32 bitmap probed at `row_ids`; negative ids -> False."""
    safe = row_ids.clamp(min=0).to(torch.int64)
    word = bitmap[safe >> 5]
    bit = torch.bitwise_right_shift(word, (safe & 31).to(word.dtype)) & 1
    return (bit == 1) & (row_ids >= 0)


def leaf_scan_batched_ref(queries: torch.Tensor, tiles: torch.Tensor,
                          rowids: torch.Tensor, scale: torch.Tensor,
                          mean: torch.Tensor, bitmaps: torch.Tensor,
                          row_norms_sq: torch.Tensor | None = None,
                          metric: str = "l2") -> torch.Tensor:
    """Query-batched filtered leaf scoring.

    queries (Q, d) f32, tiles (U, C, d) int8, rowids (U, C) int32 (-1
    padded), scale/mean (d,) f32 with x = tile * scale + mean, bitmaps
    (Q, W) int32, row_norms_sq (U, C) f32 or None
    -> (Q, U, C) f32, +inf where a row is padded or filtered out."""
    x = tiles.to(torch.float32) * scale + mean                 # (U, C, d)
    ip = torch.einsum("qd,ucd->quc", queries, x)
    if metric == "ip":
        d = -ip
    else:
        xn = row_norms_sq if row_norms_sq is not None else (x * x).sum(-1)
        qn = (queries * queries).sum(-1)
        d = qn[:, None, None] + xn[None] - 2.0 * ip
    u, c = rowids.shape
    ok = probe_batch(bitmaps, rowids.reshape(1, -1).expand(
        queries.shape[0], u * c)).reshape(-1, u, c)
    return torch.where(ok, d, torch.full_like(d, INF))


def leaf_scan_ref(query: torch.Tensor, tiles: torch.Tensor,
                  rowids: torch.Tensor, scale: torch.Tensor,
                  mean: torch.Tensor, bitmap: torch.Tensor,
                  metric: str = "l2") -> torch.Tensor:
    """One query's filtered leaf scoring: query (d,) f32, tiles (nl, C, d)
    int8, rowids (nl, C) int32 (-1 padded), scale/mean (d,) f32, bitmap
    (W,) int32 -> (nl, C) f32, +inf where a row is padded or filtered out.
    ||x||^2 is summed from the dequantized rows.  Every metric other than
    "ip" scores as L2, as the reference's kernel and oracle do."""
    x = dequantize(tiles, scale, mean)                      # (nl, C, d)
    ip = torch.einsum("lcd,d->lc", x, query)
    if metric == "ip":
        d = -ip
    else:
        d = (query * query).sum() + (x * x).sum(-1) - 2.0 * ip
    ok = probe_bitmap_ref(bitmap, rowids)
    return torch.where(ok, d, torch.full_like(d, INF))


def leaf_scan_ids_ref(queries: torch.Tensor, leaf_ids: torch.Tensor,
                      tiles: torch.Tensor, rowids: torch.Tensor,
                      scale: torch.Tensor, mean: torch.Tensor,
                      bitmaps: torch.Tensor, metric: str = "l2"
                      ) -> torch.Tensor:
    """`leaf_scan_ref` for a batch, each query against its own leaves:
    queries (Q, d), leaf_ids (Q, nl) into the (L, C, d) tiles and (L, C)
    rowids, bitmaps (Q, W) -> (Q, nl, C).  LEAF_QUERY_BLOCK queries at a
    time, so the gathered rows stay small."""
    qn, nl = leaf_ids.shape
    block = LEAF_QUERY_BLOCK
    out = torch.empty((qn, nl, tiles.shape[1]), dtype=torch.float32,
                      device=queries.device)
    for s in range(0, qn, block):
        lid = leaf_ids[s:s + block].to(torch.int64)
        q = queries[s:s + block]
        x = dequantize(tiles[lid], scale, mean)             # (b, nl, C, d)
        ip = torch.einsum("blcd,bd->blc", x, q)
        if metric == "ip":
            d = -ip
        else:
            d = (q * q).sum(-1)[:, None, None] + (x * x).sum(-1) - 2.0 * ip
        ok = probe_batch(bitmaps[s:s + block], rowids[lid])
        out[s:s + block] = torch.where(ok, d, torch.full_like(d, INF))
    return out


def topk_partial_ref(values: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of a 1-D array, ascending, ties to the lowest index
    (a stable sort): (values (k,), indices (k,) int32).  +inf entries and
    the slots past n report index -1."""
    n = values.shape[0]
    kk = min(k, n)
    vals, idx = torch.sort(values.to(torch.float32), stable=True)
    vals, idx = vals[:kk], idx[:kk].to(torch.int32)
    idx = torch.where(vals == INF, torch.full_like(idx, -1), idx)
    if kk < k:
        vals = torch.cat([vals, torch.full((k - kk,), INF,
                                           device=values.device)])
        idx = torch.cat([idx, torch.full((k - kk,), -1, dtype=torch.int32,
                                         device=values.device)])
    return vals, idx


def frontier_scan_chunk_ref(queries: torch.Tensor, vecs: torch.Tensor,
                            norms: torch.Tensor, ids: torch.Tensor,
                            bitmaps: torch.Tensor, metric: str = "l2"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frontier-chunk scoring on an already gathered block (the reference
    oracle's signature): queries (Q, d), vecs (Q, C, d), norms (Q, C),
    ids (Q, C), bitmaps (Q, W) -> (dists (Q, C) with +inf at padded ids,
    pass (Q, C) bool)."""
    q = queries[:, None, :]
    if metric == "ip":
        d = -(q * vecs).sum(-1)
    elif metric == "cos":
        qn = torch.linalg.norm(q, dim=-1) + 1e-12
        vn = torch.linalg.norm(vecs, dim=-1) + 1e-12
        d = 1.0 - (q * vecs).sum(-1) / (qn * vn)
    else:
        qn = (q * q).sum(-1)
        d = qn + norms - 2.0 * (q * vecs).sum(-1)
    ok = probe_batch(bitmaps, ids)
    return torch.where(ids >= 0, d, torch.full_like(d, INF)), ok


def frontier_scan_ref(queries: torch.Tensor, rows: torch.Tensor,
                      norms: torch.Tensor, ids: torch.Tensor,
                      bitmaps: torch.Tensor, metric: str = "l2"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frontier scan that gathers its candidates by id: queries (Q, d),
    rows (n, d), norms (n,), ids (Q, C) -1 padded, bitmaps (Q, W)."""
    safe = ids.clamp(min=0).to(torch.int64)
    return frontier_scan_chunk_ref(queries, rows[safe], norms[safe], ids,
                                   bitmaps, metric)


def dequantize(qrows: torch.Tensor, scale: torch.Tensor,
               mean: torch.Tensor) -> torch.Tensor:
    """SQ8 dequantization x̂ = t * scale + mean, the arithmetic every SQ8
    path of the port shares (shadow norms, scoring, zoom-in)."""
    return qrows.to(torch.float32) * scale + mean


def frontier_scan_sq8_ref(queries: torch.Tensor, qrows: torch.Tensor,
                          scale: torch.Tensor, mean: torch.Tensor,
                          norms: torch.Tensor, ids: torch.Tensor,
                          bitmaps: torch.Tensor, metric: str = "l2"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """SQ8 frontier scan: qrows (n, d) int8 shadow rows, scale/mean (d,),
    norms (n,) the precomputed ||x̂||^2 of the dequantized rows; the
    gathered rows are dequantized, then scored as `frontier_scan_ref`."""
    safe = ids.clamp(min=0).to(torch.int64)
    return frontier_scan_chunk_ref(queries, dequantize(qrows[safe], scale,
                                                       mean),
                                   norms[safe], ids, bitmaps, metric)


def excl_keep_mask(dists: torch.Tensor, excl: torch.Tensor,
                   tau: torch.Tensor, ok: torch.Tensor,
                   margin: float) -> torch.Tensor:
    """The FAVOR keep rule: keep a candidate when it passes the filter or
    sqrt(e) <= margin * (sqrt(d) + sqrt(tau)), all squared l2 clamped at
    0, tau = +inf keeping everything (the reference's `excl_keep_mask`)."""
    dr = torch.sqrt(dists.clamp(min=0.0))
    er = torch.sqrt(excl.clamp(min=0.0))
    tr = torch.sqrt(tau.clamp(min=0.0))
    m = torch.tensor(margin, dtype=torch.float32, device=dists.device)
    return ok | (er <= m * (dr + tr))


def gather_radii(table: torch.Tensor, radius_row: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """(Q, C) squared radii table[radius_row[q], ids[q, c]]; a -1 id reads
    column 0, as the reference's clamped gather does."""
    return table[radius_row.to(torch.int64)[:, None],
                 ids.clamp(min=0).to(torch.int64)]


def frontier_scan_excl_ref(queries, rows, norms, ids, bitmaps, table,
                           radius_row, tau, metric: str = "l2",
                           margin: float = 0.5):
    """`frontier_scan_ref` plus the keep mask: table (R + F, n) squared
    exclusion radii, radius_row (Q,) the table row of each query, tau (Q,)
    the query's result-queue tail -> (dists, pass, keep)."""
    d, ok = frontier_scan_ref(queries, rows, norms, ids, bitmaps, metric)
    e = gather_radii(table, radius_row, ids)
    return d, ok, excl_keep_mask(d, e, tau[:, None], ok, margin)


def frontier_scan_excl_sq8_ref(queries, qrows, scale, mean, norms, ids,
                               bitmaps, table, radius_row, tau,
                               metric: str = "l2", margin: float = 0.5):
    """`frontier_scan_sq8_ref` plus the keep mask on the quantized
    distances (the ones pool insertion uses)."""
    d, ok = frontier_scan_sq8_ref(queries, qrows, scale, mean, norms, ids,
                                  bitmaps, metric)
    e = gather_radii(table, radius_row, ids)
    return d, ok, excl_keep_mask(d, e, tau[:, None], ok, margin)


# the Pallas flash kernel's finite mask value
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_q: int = 512,
                        block_k: int = 512) -> torch.Tensor:
    """The reference's `flash_attention_pallas`, step for step: q (B, T, H,
    hd), k and v (B, S, KV, hd) -> (B, T, H, hd) in q's dtype.  T and S are
    padded to block multiples; each query block runs the online softmax
    over the key blocks in order (a causal block stops after the diagonal),
    with q cast to f32 and scaled by 1/sqrt(hd) rounded to f32, masked
    scores at the finite NEG_INF, f32 probabilities in P.V and the output
    acc / max(l, 1e-20).  Padded keys are masked, padded query rows
    dropped.  Positions count from 0 for queries and keys alike."""
    b, t, h, hd = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    block_q, block_k = min(block_q, t), min(block_k, s_len)
    tp = t + (-t) % block_q
    sp = s_len + (-s_len) % block_k
    qf = torch.nn.functional.pad(q.to(torch.float32),
                                 (0, 0, 0, 0, 0, tp - t)) * scale
    qf = qf.reshape(b, tp, kvh, g, hd)
    kf = torch.nn.functional.pad(k.to(torch.float32),
                                 (0, 0, 0, 0, 0, sp - s_len))
    vf = torch.nn.functional.pad(v.to(torch.float32),
                                 (0, 0, 0, 0, 0, sp - s_len))
    out = torch.empty((b, tp, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    kpos0 = torch.arange(block_k, device=q.device)
    for qi in range(tp // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qb = qf[:, rows]                                  # (B, BQ, KV, G, hd)
        qpos = qi * block_q + torch.arange(block_q, device=q.device)
        m = torch.full((b, block_q, kvh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        hi = min((qi + 1) * block_q + block_k - 1, sp) // block_k \
            if causal else sp // block_k
        for i in range(hi):
            keys = slice(i * block_k, (i + 1) * block_k)
            s = torch.einsum("bqkgh,bskh->bqkgs", qb, kf[:, keys])
            kpos = i * block_k + kpos0
            valid = (kpos < s_len)[None, :]
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] \
                + torch.einsum("bqkgs,bskh->bqkgh", p, vf[:, keys])
            m = m_new
        out[:, rows] = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, tp, h, hd)[:, :t].to(q.dtype)
