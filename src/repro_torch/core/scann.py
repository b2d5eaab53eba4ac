"""Filtered ScaNN: clustering-based index (paper §2.3.7, §3.3).

Tree: an optional branch level over the leaves, built with k-means.  Leaves
are int8 (SQ8) tiles of their rows, padded to a common capacity.  An
optional PCA rotation precedes quantization.

Search, query-batched (paper Fig. 5/7): ① score the branch centroids, then
the leaf centroids of the best branches (the `distance_matrix` kernel) and
keep `num_leaves_to_search` leaves per query; ② scan the union of opened
leaves once for the whole query block (the `leaf_scan_batched` kernel:
dequantize, score, probe the bitmap); ③ per query, keep the best
k * reorder_factor candidates; ④ rescore them exactly from the
full-precision rows and return the top k.

Counters follow Table 6's ScaNN columns: filter checks = every valid row of
every opened leaf; distance comps = passing rows + centroids scored +
reordered rows; hops = leaves scanned; reorder_rows; page accesses =
quantized leaf pages + heap pages of the reordered rows.

`scann_search_batch_vmapped` is the reference's legacy per-query path,
its equivalence oracle: centroids scored with the engines' `distance`,
every query's own leaves scanned by the `leaf_scan` kernel (one launch for
the batch, tiles read by leaf id), per-query page counters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.costmodel import budget_cycle_weights
from repro_torch.core.types import (SearchParams, SearchStats, VectorStore,
                                    check_store_device, distance,
                                    heap_pages_per_vector, sq8_quantize,
                                    topk_smallest)
from repro_torch.kernels import ops
from repro_torch.storage.pages import scann_pages_per_leaf

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class ScannIndex:
    leaf_tiles: torch.Tensor       # (L, C, dp) int8
    leaf_rowids: torch.Tensor      # (L, C) int32, -1 padded
    leaf_centroids: torch.Tensor   # (L, dp) f32
    scale: torch.Tensor            # (dp,) f32, dequant x = tile*scale + mean
    mean: torch.Tensor             # (dp,) f32
    branch_centroids: torch.Tensor  # (B, dp) f32
    branch_leaves: torch.Tensor     # (B, Lb) int32, -1 padded
    pca: torch.Tensor               # (d + 1, dp) f32: projection + mean row
    row_norms_sq: torch.Tensor      # (L, C) f32 of the dequantized rows
    metric: str = "l2"
    levels: int = 2

    @property
    def num_leaves(self) -> int:
        return self.leaf_tiles.shape[0]


def _kmeans(x: torch.Tensor, k: int, iters: int = 12, seed: int = 0,
            block: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain Lloyd's on the device.  Returns (centroids (k, d) f32,
    assignment (n,) int64).  The initial centroids and the reseeding of
    empty clusters are drawn from numpy's RandomState(seed) as in the
    reference; like the reference, centroids are float64 after the first
    update."""
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    pick = torch.as_tensor(rng.choice(n, size=k, replace=False),
                           device=x.device)
    cent = x[pick].clone()
    assign = torch.zeros(n, dtype=torch.int64, device=x.device)
    for _ in range(iters):
        cn = (cent * cent).sum(1)
        for s in range(0, n, block):
            xb = x[s:s + block]
            d = (xb * xb).sum(1)[:, None] + cn[None, :] \
                - 2.0 * (xb.to(cent.dtype) @ cent.T)
            assign[s:s + block] = d.argmin(1)
        sums = _segment_sum(x.to(cent.dtype), assign, k)
        cnt = torch.bincount(assign, minlength=k).to(torch.float64)
        empty = cnt == 0
        cent = torch.where(empty[:, None], cent,
                           sums / cnt.clamp(min=1)[:, None])
        n_empty = int(empty.sum())
        if n_empty:   # reseed empty clusters on far points
            far = torch.as_tensor(rng.choice(n, size=n_empty, replace=False),
                                  device=x.device)
            cent[empty] = x[far].to(cent.dtype)
    return cent.to(torch.float32), assign


def _segment_sum(x: torch.Tensor, assign: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """(k, d) sums of the rows of x by group, each group's rows added one
    after another in ascending row order, from zero: the order of the
    reference's `np.add.at`, so the result is the same bytes on every run.
    (`index_add_` on a CUDA tensor adds with atomics in no fixed order.)
    The rows are sorted stably by group, and `segment_reduce` adds up each
    group's segment in that order, all groups in one launch."""
    counts = torch.bincount(assign, minlength=k)
    order = torch.sort(assign, stable=True).indices
    return torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)


def _place(assign: torch.Tensor, k: int) -> torch.Tensor:
    """(k, cap) table of the ids assigned to each group, in ascending id
    order within a group, -1 padded (cap = the largest group)."""
    counts = torch.bincount(assign, minlength=k)
    cap = int(counts.max())
    order = torch.sort(assign, stable=True).indices
    grp = assign[order]
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(assign.shape[0], device=assign.device) - start[grp]
    table = torch.full((k, cap), -1, dtype=torch.int64, device=assign.device)
    table[grp, rank] = order
    return table


def _row_norms_sq(tiles: torch.Tensor, scale: torch.Tensor,
                  mean: torch.Tensor, block: int = 256) -> torch.Tensor:
    """||x||² of every dequantized leaf row, (L, C) f32: the dequant and
    reduction the leaf scan's plain version applies."""
    out = torch.empty(tiles.shape[:2], dtype=torch.float32,
                      device=tiles.device)
    for s in range(0, tiles.shape[0], block):
        x = tiles[s:s + block].to(torch.float32) * scale + mean
        out[s:s + block] = (x * x).sum(-1)
    return out


def build_scann(store: VectorStore, num_leaves: int, levels: int = 2,
                pca_dims: int | None = None, seed: int = 0,
                kmeans_iters: int = 12, device="cuda") -> ScannIndex:
    dev = check_store_device(store, device)
    x = store.vectors
    n, d = x.shape

    if pca_dims is not None and pca_dims < d:
        mu = x.mean(0)
        xc = x - mu
        cov = (xc.T @ xc) / max(n - 1, 1)
        _, v = torch.linalg.eigh(cov)
        proj = torch.flip(v, [1])[:, :pca_dims].contiguous()
        xp = xc @ proj
        pca, pca_mu = proj, mu
    else:
        xp = x
        pca = torch.eye(d, dtype=torch.float32, device=dev)
        pca_mu = torch.zeros(d, dtype=torch.float32, device=dev)
    dp = xp.shape[1]

    cent, assign = _kmeans(xp, num_leaves, iters=kmeans_iters, seed=seed)
    rowids = _place(assign, num_leaves)
    cap = rowids.shape[1] + (-rowids.shape[1]) % 8      # 8-row alignment
    rowids = torch.nn.functional.pad(rowids, (0, cap - rowids.shape[1]),
                                     value=-1)

    # SQ8 over the dataset on the device, byte-identical to the
    # reference's quantizer
    q, scale, mean = sq8_quantize(xp)
    valid = rowids >= 0
    tiles = torch.zeros((num_leaves, cap, dp), dtype=torch.int8, device=dev)
    tiles[valid] = q[rowids[valid]]

    if levels >= 2 and num_leaves >= 16:
        nb = max(4, int(np.sqrt(num_leaves)))
        bcent, bassign = _kmeans(cent, nb, iters=kmeans_iters, seed=seed + 1)
        bleaves = _place(bassign, nb)
    else:
        levels = 1
        bcent = torch.zeros((1, dp), dtype=torch.float32, device=dev)
        bleaves = torch.arange(num_leaves, device=dev)[None, :]

    return ScannIndex(
        leaf_tiles=tiles,
        leaf_rowids=rowids.to(torch.int32),
        leaf_centroids=cent,
        scale=scale, mean=mean,
        branch_centroids=bcent,
        branch_leaves=bleaves.to(torch.int32),
        pca=torch.cat([pca, pca_mu[None, :] @ pca], 0),
        row_norms_sq=_row_norms_sq(tiles, scale, mean),
        metric=store.metric, levels=levels)


def project_query(index: ScannIndex, q: torch.Tensor) -> torch.Tensor:
    """Apply the (folded-centering) PCA projection to queries."""
    return q @ index.pca[:-1] - index.pca[-1]


def _quant_pages_per_leaf(index: ScannIndex) -> int:
    return scann_pages_per_leaf(index.leaf_tiles.shape[1],
                                index.leaf_tiles.shape[2])


def leaves_within_budget(index: ScannIndex, store: VectorStore,
                         params: SearchParams) -> tuple[int, bool]:
    """Plan-time anytime clamp: the largest `num_leaves_to_search` whose
    worst-case per-query cost fits the budgets in `params`.  Returns
    (nl, clamped); never less than one leaf."""
    L, C, _ = index.leaf_tiles.shape
    nl0 = min(params.num_leaves_to_search, L)
    if params.page_budget <= 0 and params.hop_budget <= 0 \
            and params.deadline_cycles <= 0:
        return nl0, False
    qppl = _quant_pages_per_leaf(index)
    ppv = heap_pages_per_vector(store.dim)
    cent = L + (index.branch_centroids.shape[0] if index.levels >= 2 else 0)
    w = budget_cycle_weights(store.dim)
    for nl in range(nl0, 0, -1):
        r = min(params.k * params.reorder_factor, nl * C)
        ok = True
        if params.hop_budget > 0:
            ok = nl <= params.hop_budget
        if ok and params.page_budget > 0:
            ok = nl * qppl + r * ppv <= params.page_budget
        if ok and params.deadline_cycles > 0:
            rows = nl * C
            cyc = (rows + cent + r) * w["distance_comps"] \
                + rows * w["filter_checks"] \
                + nl * qppl * w["page_accesses_index"] \
                + r * ppv * w["page_accesses_heap"] \
                + r * w["reorder_rows"]
            ok = cyc <= params.deadline_cycles
        if ok:
            return nl, nl < nl0
    return 1, nl0 > 1


def _unique_pad(ids: torch.Tensor, domain: int, cap: int | None = None):
    """Set union: the distinct values of `ids` (all in [0, domain)),
    ascending, padded to `cap` entries.  Returns (members (cap,),
    valid (cap,) bool, inv (domain,) with inv[members[i]] == i).

    `cap=None` sizes the union to the number of distinct values.  The
    reference pads to a static min(L, Q * nl) because its shapes are
    traced; padded members are leaves no query opened, which only ever
    score +inf and are never read back, so sizing the union to its members
    changes no id, distance or counter and scans no unopened leaf."""
    present = torch.zeros(domain, dtype=torch.int32, device=ids.device)
    present.scatter_(0, ids.to(torch.int64), 1)
    if cap is None:
        cap = int(present.sum())
    pv, members = torch.sort(present, descending=True, stable=True)
    members = members[:cap]
    inv = torch.zeros(domain, dtype=torch.int64, device=ids.device)
    inv.scatter_(0, members, torch.arange(cap, device=ids.device))
    return members, pv[:cap] > 0, inv


def _select_leaves(index: ScannIndex, qp: torch.Tensor, nl: int):
    """Stage ① of Fig. 5, batched: one distance_matrix call per centroid
    level.  Returns (leaves (Q, nl), centroids scored per query)."""
    L = index.leaf_tiles.shape[0]
    qn = qp.shape[0]
    if index.levels >= 2:
        B, _ = index.branch_leaves.shape
        bd = ops.distance_matrix(qp, index.branch_centroids, index.metric)
        nb = min(B, max(1, -(-nl * 2 * B // L)))
        _, bsel = topk_smallest(bd, nb)                          # (Q, nb)
        cand = index.branch_leaves[bsel].reshape(qn, -1).to(torch.int64)
        cl = cand.clamp(min=0)
        ldf = ops.distance_matrix(qp, index.leaf_centroids, index.metric)
        ld = torch.where(cand >= 0, torch.gather(ldf, 1, cl),
                         torch.full_like(cl, INF, dtype=ldf.dtype))
        _, pos = topk_smallest(ld, nl)
        return torch.gather(cl, 1, pos), B + cand.shape[1]
    ld = ops.distance_matrix(qp, index.leaf_centroids, index.metric)
    _, leaves = topk_smallest(ld, nl)
    return leaves, L


def scann_search_batch(index: ScannIndex, store: VectorStore,
                       queries: torch.Tensor, bitmaps: torch.Tensor,
                       params: SearchParams, collect_trace: bool = False):
    """Filtered ScaNN search, query-batched.  Returns (dists (Q, k),
    ids (Q, k), SearchStats with (Q,) counters).

    `params.scann_query_block` > 0 tiles the batch: each tile of that many
    queries runs the whole pipeline over its own leaf union, so the
    (Q, U, C) union-scan output stays bounded.  ids and dists do not depend
    on the tile size; "batch" index-page accounting amortizes per tile.

    `collect_trace=True` adds a fourth element, the storage trace
    `{"leaves": (Q, nl) opened in rank order, "cand_rows": (Q, r) reorder
    heap rows in candidate order, "cand_ok": (Q, r) validity}`."""
    if index.metric not in ("l2", "ip") or store.metric not in ("l2", "ip"):
        raise NotImplementedError(
            f"batched ScaNN pipeline supports 'l2'/'ip' metrics, got "
            f"index={index.metric!r} store={store.metric!r}")
    if params.scann_page_accounting not in ("batch", "per_query"):
        raise ValueError(
            f"scann_page_accounting must be 'batch' or 'per_query', got "
            f"{params.scann_page_accounting!r}")
    qn = queries.shape[0]
    B = params.scann_query_block
    if B < 0:
        raise ValueError(f"scann_query_block must be >= 0, got {B}")
    if not 0 < B < qn:
        return _scann_search_block(index, store, queries, bitmaps, params,
                                   collect_trace)
    outs = [_scann_search_block(index, store, queries[s:s + B],
                                bitmaps[s:s + B], params, collect_trace)
            for s in range(0, qn, B)]
    out = (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
           SearchStats.cat([o[2] for o in outs]))
    if collect_trace:
        out += ({k: torch.cat([o[3][k] for o in outs]) for k in outs[0][3]},)
    return out


def _scann_search_block(index: ScannIndex, store: VectorStore,
                        queries: torch.Tensor, bitmaps: torch.Tensor,
                        params: SearchParams, collect_trace: bool = False):
    """One query tile through stages ①–④."""
    qn = queries.shape[0]
    L, C, _ = index.leaf_tiles.shape
    nl = min(params.num_leaves_to_search, L)
    qp = project_query(index, queries)

    leaves, cent_scored = _select_leaves(index, qp, nl)

    # ② the union of opened leaves; each tile is scanned once for the whole
    # tile of queries
    uleaves, uvalid, inv = _unique_pad(leaves.reshape(-1), L)
    pos_in_u = inv[leaves]                                       # (Q, nl)
    rowids_u = torch.where(uvalid[:, None], index.leaf_rowids[uleaves], -1)
    norms_u = (torch.zeros_like(index.row_norms_sq[uleaves])
               if index.metric == "ip" else index.row_norms_sq[uleaves])
    scores_u = ops.leaf_scan_batched(qp, index.leaf_tiles[uleaves], rowids_u,
                                     index.scale, index.mean, bitmaps,
                                     norms_u, index.metric)      # (Q, U, C)

    # each query's opened leaves, in rank order, out of the union scan
    scores = torch.gather(scores_u, 1, pos_in_u[:, :, None].expand(qn, nl, C))
    rowids = rowids_u[pos_in_u].to(torch.int64)                  # (Q, nl, C)
    n_valid = (rowids >= 0).sum((1, 2))
    n_pass = torch.isfinite(scores).sum((1, 2))

    # ③ per-query candidate selection (paper §6.2.2)
    r = min(params.k * params.reorder_factor, nl * C)
    flat_s, flat_pos = topk_smallest(scores.reshape(qn, -1), r)
    cand_rows = torch.gather(rowids.reshape(qn, -1), 1, flat_pos)
    cand_ok = torch.isfinite(flat_s) & (cand_rows >= 0)

    # ④ exact rescoring of each query's r candidates from the heap rows
    safe = cand_rows.clamp(min=0)
    exact = distance(store.metric, queries[:, None, :], store.vectors[safe],
                     store.norms_sq[safe])
    exact = torch.where(cand_ok, exact, torch.full_like(exact, INF))
    dk, pos = topk_smallest(exact, params.k)
    ids = torch.where(torch.isinf(dk), torch.full_like(pos, -1),
                      torch.gather(cand_rows, 1, pos))
    n_reorder = cand_ok.sum(1)

    qppl = _quant_pages_per_leaf(index)
    if params.scann_page_accounting == "per_query":
        idx_pages = torch.full((qn,), nl * qppl, dtype=torch.int32,
                               device=queries.device)
    else:
        # each opened leaf's pages are charged once per tile, to the first
        # query (lowest index) that opened it
        opened = torch.zeros((qn, uleaves.shape[0]), dtype=torch.int32,
                             device=queries.device)
        opened.scatter_(1, pos_in_u, 1)
        first = torch.argmax(opened, 0)[uvalid]
        idx_pages = torch.bincount(first, minlength=qn) * qppl
    z = torch.zeros((qn,), dtype=torch.int32, device=queries.device)
    stats = SearchStats(
        distance_comps=(n_pass + cent_scored + n_reorder).to(torch.int32),
        filter_checks=n_valid.to(torch.int32),
        hops=z + nl,
        page_accesses_index=idx_pages.to(torch.int32),
        page_accesses_heap=(n_reorder * heap_pages_per_vector(store.dim)
                            ).to(torch.int32),
        tmap_lookups=z,
        reorder_rows=n_reorder.to(torch.int32))
    if collect_trace:
        return dk, ids.to(torch.int32), stats, {
            "leaves": leaves.to(torch.int32),
            "cand_rows": cand_rows.to(torch.int32), "cand_ok": cand_ok}
    return dk, ids.to(torch.int32), stats


def scann_search_batch_vmapped(index: ScannIndex, store: VectorStore,
                               queries: torch.Tensor, bitmaps: torch.Tensor,
                               params: SearchParams):
    """The legacy per-query ScaNN path (the reference's vmap of its
    single-query search), batch written out.  Each query scores the
    centroids with `distance` (elementwise product + sum, not the
    distance_matrix kernel), and its own nl leaves are scanned with the
    `leaf_scan` kernel, every tile re-read per query.  Counters are per
    query: nl x pages_per_leaf index pages.  Every metric but "ip" scans
    the leaves as L2, as the reference does."""
    qn = queries.shape[0]
    L, C, _ = index.leaf_tiles.shape
    nl = min(params.num_leaves_to_search, L)
    qp = project_query(index, queries)[:, None, :]              # (Q, 1, dp)
    if index.levels >= 2:
        B, _ = index.branch_leaves.shape
        bc = index.branch_centroids
        bd = distance(index.metric, qp, bc[None], (bc * bc).sum(-1)[None])
        # open enough branches to cover nl leaves (paper Fig. 5-①)
        nb = min(B, max(1, -(-nl * 2 * B // L)))
        _, bsel = topk_smallest(bd, nb)
        cand = index.branch_leaves[bsel].reshape(qn, -1).to(torch.int64)
        cl = cand.clamp(min=0)
        lc = index.leaf_centroids[cl]                           # (Q, m, dp)
        ld = distance(index.metric, qp, lc, (lc * lc).sum(-1))
        ld = torch.where(cand >= 0, ld, torch.full_like(ld, INF))
        _, pos = topk_smallest(ld, nl)
        leaves = torch.gather(cl, 1, pos)
        cent_scored = B + cand.shape[1]
    else:
        lc = index.leaf_centroids
        ld = distance(index.metric, qp, lc[None], (lc * lc).sum(-1)[None])
        _, leaves = topk_smallest(ld, nl)
        cent_scored = L
    scores = ops.leaf_scan_ids(qp[:, 0], leaves, index.leaf_tiles,
                               index.leaf_rowids, index.scale, index.mean,
                               bitmaps, index.metric)           # (Q, nl, C)
    rowids = index.leaf_rowids[leaves].to(torch.int64)          # (Q, nl, C)
    n_valid = (rowids >= 0).sum((1, 2))
    n_pass = torch.isfinite(scores).sum((1, 2))
    # candidate selection + full-precision reordering (paper §6.2.2)
    r = min(params.k * params.reorder_factor, nl * C)
    flat_s, flat_pos = topk_smallest(scores.reshape(qn, -1), r)
    cand_rows = torch.gather(rowids.reshape(qn, -1), 1, flat_pos)
    cand_ok = torch.isfinite(flat_s) & (cand_rows >= 0)
    safe = cand_rows.clamp(min=0)
    exact = distance(store.metric, queries[:, None, :], store.vectors[safe],
                     store.norms_sq[safe])
    exact = torch.where(cand_ok, exact, torch.full_like(exact, INF))
    dk, pos = topk_smallest(exact, params.k)
    ids = torch.where(torch.isinf(dk), torch.full_like(pos, -1),
                      torch.gather(cand_rows, 1, pos))
    n_reorder = cand_ok.sum(1)
    z = torch.zeros((qn,), dtype=torch.int32, device=queries.device)
    stats = SearchStats(
        distance_comps=(n_pass + cent_scored + n_reorder).to(torch.int32),
        filter_checks=n_valid.to(torch.int32),
        hops=z + nl,
        page_accesses_index=z + nl * _quant_pages_per_leaf(index),
        page_accesses_heap=(n_reorder * heap_pages_per_vector(store.dim)
                            ).to(torch.int32),
        tmap_lookups=z,
        reorder_rows=n_reorder.to(torch.int32))
    return dk, ids.to(torch.int32), stats
