"""Exact filtered k-NN under L2, and the checks that decide `correct`.

Everything here is plain PyTorch on the rows and bitmaps the benchmark
made itself; nothing the program built (its store norms, graph, leaves,
SQ8 tiles) is read.  Matrix products run with TF32 off, so a float32
product is a float32 product on the card too.  The distances that judge
an answer are worked out again in float64 from the rows.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

QUERY_BLOCK = 64          # queries per (block, n) distance matrix
ANSWER_BLOCK = 65_536     # answers per float64 gather


@contextlib.contextmanager
def tf32_off():
    """Matrix products in full float32 inside the block, whatever the
    process had set."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int32 packed words -> (..., n) bool: bit r & 31 of word
    r >> 5 is row r."""
    shifts = torch.arange(32, device=words.device, dtype=words.dtype)
    bits = torch.bitwise_right_shift(words[..., :, None], shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].bool()


def passes(words: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor
           ) -> torch.Tensor:
    """(A, k) bool: row ids[a, j] passes the bitmap words[qidx[a]]; False
    for ids outside the bitmap."""
    n_bits = words.shape[1] * 32
    ok = (ids >= 0) & (ids < n_bits)
    safe = ids.clamp(0, n_bits - 1).long()
    w = words[qidx[:, None].long(), safe >> 5]
    return ok & ((torch.bitwise_right_shift(w, (safe & 31).to(w.dtype))
                  & 1) == 1)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """(Q,) passing rows per packed bitmap."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum(-1)


def exact_knn(rows: torch.Tensor, queries: torch.Tensor,
              words: torch.Tensor, k: int, operand=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists (Q, k) f32, ids (Q, k) int64) of each query's k nearest
    passing rows, -1 / +inf past the passing rows.  `operand`, where
    given, is applied to both sides of the cross term (the control's
    lower precision)."""
    n = rows.shape[0]
    xn = (rows * rows).sum(1)
    xr = rows if operand is None else operand(rows)
    dist_out, id_out = [], []
    with tf32_off():
        for s in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[s:s + QUERY_BLOCK]
            qr = q if operand is None else operand(q)
            d = (q * q).sum(1, keepdim=True) + xn[None, :] - 2.0 * (qr @ xr.T)
            d = torch.where(unpack(words[s:s + QUERY_BLOCK], n), d,
                            torch.full_like(d, float("inf")))
            top = torch.topk(d, k, dim=1, largest=False, sorted=True)
            dist_out.append(top.values)
            id_out.append(torch.where(torch.isinf(top.values),
                                      torch.full_like(top.indices, -1),
                                      top.indices))
    return torch.cat(dist_out), torch.cat(id_out)


def answer_error(rows: torch.Tensor, queries: torch.Tensor,
                 qidx: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor
                 ) -> float:
    """Largest |d - d_ref| / (|q|^2 + |x|^2) over the answers with a valid
    id, d_ref the float64 squared distance of the query to the row: the
    error of a returned distance against the scale its terms cancel at."""
    flat_q = qidx[:, None].expand_as(ids).reshape(-1)
    flat_id = ids.reshape(-1).long()
    flat_d = dists.reshape(-1)
    live = (flat_id >= 0) & (flat_id < rows.shape[0])
    flat_q, flat_id, flat_d = flat_q[live], flat_id[live], flat_d[live]
    worst = 0.0
    for s in range(0, flat_id.shape[0], ANSWER_BLOCK):
        q = queries[flat_q[s:s + ANSWER_BLOCK]].double()
        x = rows[flat_id[s:s + ANSWER_BLOCK]].double()
        ref = ((q - x) ** 2).sum(1)
        scale = (q * q).sum(1) + (x * x).sum(1)
        err = (flat_d[s:s + ANSWER_BLOCK].double() - ref).abs() / scale
        err = torch.where(torch.isnan(err), torch.full_like(err, np.inf), err)
        worst = max(worst, float(err.max()))
    return worst


def bad_answers(words: torch.Tensor, passing: torch.Tensor, n: int,
                qidx: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor
                ) -> torch.Tensor:
    """(A,) bool per answered query (pool index qidx, k answers): a row
    outside [0, n) or failing the query's filter, a row twice, a hole
    before a row, a distance that is NaN or out of ascending order, or
    fewer rows than min(k, passing rows).  `passing` is the pool's (P,)
    popcount."""
    k = ids.shape[1]
    ids = ids.long()
    live = ids >= 0
    wrong = live & ((ids >= n) | ~passes(words, qidx, ids))
    srt = torch.sort(torch.where(live, ids, torch.full_like(ids, -1)),
                     1).values
    twice = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    d = torch.where(live, dists, torch.full_like(dists, float("inf")))
    unordered = (d[:, 1:] < d[:, :-1]).any(1) | (live & torch.isnan(dists)
                                                 ).any(1)
    holes = (~live[:, :-1] & live[:, 1:]).any(1)
    short = live.sum(1) < passing[qidx.long()].clamp(max=k)
    return wrong.any(1) | twice | unordered | holes | short


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even), as
    the tensor cores round a float32 operand."""
    b = x.contiguous().view(torch.int32)
    bias = 0xFFF + (torch.bitwise_right_shift(b, 13) & 1)
    return torch.bitwise_and(b + bias, ~0x1FFF).view(torch.float32)
