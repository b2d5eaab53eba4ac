"""HNSW-family navigable graph: construction + container.

The construction is the reference's deterministic, vectorizable recipe:
geometric level assignment as in HNSW, per-level kNN candidates (exact on
small levels, cluster-routed on large ones), a few random long-range
candidates, the HNSW select-neighbors diversity heuristic, reverse-edge
augmentation and base-layer connectivity repair.

The dense work (distances and top-k of the kNN candidates, the routed
buckets, the candidate-pair block of the diversity heuristic) runs as torch
on the store's device; the neighbor table and its cheap bookkeeping
(reverse edges, connected components) stay in numpy on the host.  The
random draws come from numpy's RandomState(seed) in the reference's order,
so levels, routing centroids and long-range candidates are the same.

The graph is a padded neighbor table per level, (L, N, 2M) int32, -1
padded: reading row i of level l is one "index page access".
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import (VectorStore, check_store_device,
                                    match_bitmaps, to_device, unpack_bitmap)

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class HNSWGraph:
    """Padded neighbor tables. neighbors: (L, N, 2M) int32, -1 padded.
    Level 0 may use all 2M slots; levels >= 1 use at most M."""

    neighbors: torch.Tensor
    node_level: torch.Tensor   # (N,) int32
    entry_point: int
    m: int = 16

    @property
    def num_levels(self) -> int:
        return self.neighbors.shape[0]

    @property
    def n(self) -> int:
        return self.neighbors.shape[1]


def _pairwise_dists(x: torch.Tensor, y: torch.Tensor,
                    metric: str) -> torch.Tensor:
    if metric == "ip":
        return -x @ y.T
    if metric == "cos":
        xn = x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-12)
        yn = y / (torch.linalg.norm(y, dim=1, keepdim=True) + 1e-12)
        return 1.0 - xn @ yn.T
    d = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * (x @ y.T)
    return d.clamp(min=0.0)


def _knn_among(vectors: torch.Tensor, metric: str, k: int,
               block: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of each row among all rows (self excluded), ascending."""
    n = vectors.shape[0]
    k = min(k, n - 1)
    ids = torch.empty((n, k), dtype=torch.int64, device=vectors.device)
    dst = torch.empty((n, k), dtype=torch.float32, device=vectors.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        d = _pairwise_dists(vectors[s:e], vectors, metric)
        r = torch.arange(e - s, device=vectors.device)
        d[r, r + s] = INF                                     # drop self
        top = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids[s:e], dst[s:e] = top.indices, top.values
    return ids, dst


def _rows_dist(vectors: torch.Tensor, ids: torch.Tensor, metric: str,
               block: int = 131072) -> torch.Tensor:
    """Distance from row i to vectors[ids[i, j]], (n, k)."""
    out = torch.empty(ids.shape, dtype=torch.float32, device=vectors.device)
    for s in range(0, ids.shape[0], block):
        x = vectors[s:s + block, None, :]
        y = vectors[ids[s:s + block]]
        if metric == "ip":
            out[s:s + block] = -(x * y).sum(-1)
        elif metric == "cos":
            xn = x / (torch.linalg.norm(x, dim=2, keepdim=True) + 1e-12)
            yn = y / (torch.linalg.norm(y, dim=2, keepdim=True) + 1e-12)
            out[s:s + block] = 1.0 - (xn * yn).sum(-1)
        else:
            diff = y - x
            out[s:s + block] = (diff * diff).sum(-1)
    return out


def _components(level_nbrs: np.ndarray) -> np.ndarray:
    """Weakly-connected components via union-find over the edge list."""
    n = level_nbrs.shape[0]
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    src = np.repeat(np.arange(n), level_nbrs.shape[1])
    dst = level_nbrs.reshape(-1)
    ok = dst >= 0
    for u, v in zip(src[ok], dst[ok]):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    return np.array([find(i) for i in range(n)])


def _link(level_nbrs: np.ndarray, vectors: torch.Tensor, metric: str,
          a_ids: np.ndarray, b_ids: np.ndarray) -> None:
    """Link the nearest (a, b) pair bidirectionally, overwriting the last
    slot of a full row."""
    dev = vectors.device
    d = _pairwise_dists(vectors[torch.as_tensor(a_ids, device=dev)],
                        vectors[torch.as_tensor(b_ids, device=dev)], metric)
    flat = int(torch.argmin(d))
    a, b = int(a_ids[flat // d.shape[1]]), int(b_ids[flat % d.shape[1]])
    for u, v in ((a, b), (b, a)):
        row = level_nbrs[u]
        free = np.where(row < 0)[0]
        row[free[0] if len(free) else len(row) - 1] = v


def _repair_connectivity(level_nbrs: np.ndarray, vectors: torch.Tensor,
                         metric: str, max_iters: int = 64) -> None:
    """Make the base layer one weakly-connected component: link the
    smallest minor component to its nearest node of the major one, one
    component per iteration.  In place on level_nbrs."""
    for _ in range(max_iters):
        comp = _components(level_nbrs)
        ids, counts = np.unique(comp, return_counts=True)
        if len(ids) == 1:
            return
        major = ids[np.argmax(counts)]
        minor = ids[ids != major][np.argmin(counts[ids != major])]
        a_ids = np.where(comp == minor)[0]
        b_ids = np.where(comp == major)[0]
        sub = b_ids if len(b_ids) <= 20000 else \
            b_ids[np.random.RandomState(0).choice(len(b_ids), 20000, False)]
        _link(level_nbrs, vectors, metric, a_ids, sub)


def _repair_connectivity_blocked(level_nbrs: np.ndarray,
                                 vectors: torch.Tensor, metric: str,
                                 rng: np.random.RandomState,
                                 max_iters: int = 16) -> None:
    """The large-level twin of `_repair_connectivity`: one sparse
    connected-components pass per iteration, every minor component linked
    to the major one."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    n = level_nbrs.shape[0]
    for _ in range(max_iters):
        src = np.repeat(np.arange(n), level_nbrs.shape[1])
        dstf = level_nbrs.reshape(-1)
        ok = dstf >= 0
        g = sp.coo_matrix((np.ones(int(ok.sum()), np.int8),
                           (src[ok], dstf[ok])), shape=(n, n))
        ncomp, comp = connected_components(g, directed=False)
        if ncomp == 1:
            return
        ids, counts = np.unique(comp, return_counts=True)
        major = ids[np.argmax(counts)]
        b_ids = np.flatnonzero(comp == major)
        sub = b_ids if len(b_ids) <= 20000 else \
            rng.choice(b_ids, 20000, replace=False)
        for minor in ids[ids != major]:
            a_ids = np.flatnonzero(comp == minor)
            asub = a_ids if len(a_ids) <= 4096 else \
                rng.choice(a_ids, 4096, replace=False)
            _link(level_nbrs, vectors, metric, asub, sub)


def _diversity_prune(vectors: torch.Tensor, cand_ids: torch.Tensor,
                     cand_d: torch.Tensor, m: int, metric: str,
                     block: int = 16384) -> torch.Tensor:
    """HNSW select-neighbors heuristic, vectorized over nodes.

    Keep candidate c (in increasing-distance order) iff it is closer to the
    node than to every already-kept neighbor, at most m.  Then
    keepPrunedConnections: fill the free slots with the pruned candidates
    in order, skipping ids already chosen.  Returns (n, m) ids, -1 padded.
    """
    n, kc = cand_ids.shape
    dev = vectors.device
    out = torch.full((n, m), -1, dtype=torch.int64, device=dev)
    earlier = torch.ones((kc, kc), dtype=torch.bool, device=dev).tril(-1)
    for s in range(0, n, block):
        e = min(s + block, n)
        cids = cand_ids[s:e]                                  # (b, kc)
        cvec = vectors[cids]                                  # (b, kc, d)
        if metric == "ip":
            cc = -torch.bmm(cvec, cvec.transpose(1, 2))
        elif metric == "cos":
            cn = cvec / (torch.linalg.norm(cvec, dim=2, keepdim=True) + 1e-12)
            cc = 1.0 - torch.bmm(cn, cn.transpose(1, 2))
        else:
            sq = (cvec * cvec).sum(2)
            cc = sq[:, :, None] + sq[:, None, :] \
                - 2.0 * torch.bmm(cvec, cvec.transpose(1, 2))
        kept = torch.zeros((e - s, kc), dtype=torch.bool, device=dev)
        kept_cnt = torch.zeros(e - s, dtype=torch.int64, device=dev)
        for j in range(kc):
            d_to_kept = torch.where(kept, cc[:, j, :],
                                    torch.full_like(cc[:, j, :], INF))
            ok = (cand_d[s:e, j] < d_to_kept.min(1).values) & (kept_cnt < m)
            kept[:, j] = ok
            kept_cnt += ok
        # kept candidates first, then the pruned ones, each in order; a
        # pruned candidate whose id appeared earlier in that order is
        # skipped; the first m that remain are the neighbors
        perm = torch.sort((~kept).to(torch.int8), dim=1, stable=True).indices
        sid = torch.gather(cids, 1, perm)
        skept = torch.gather(kept, 1, perm)
        dup = ((sid[:, :, None] == sid[:, None, :]) & earlier).any(2)
        sel = skept | ~dup
        pos = torch.sort((~sel).to(torch.int8), dim=1,
                         stable=True).indices[:, :m]
        live = torch.arange(pos.shape[1], device=dev)[None, :] \
            < sel.sum(1, keepdim=True)
        out[s:e, :pos.shape[1]] = torch.where(
            live, torch.gather(sid, 1, pos), torch.full_like(pos, -1))
    return out


def _augment_reverse(level_nbrs: np.ndarray, members: np.ndarray,
                     pruned: np.ndarray, m_l: int) -> None:
    """Add reverse edges into free (-1) slots, capped at m_l per node."""
    src = np.repeat(members, pruned.shape[1])
    dst = pruned.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    counts = (level_nbrs[:, :m_l] >= 0).sum(1)
    order = np.argsort(dst, kind="stable")
    for s, d in zip(src[order], dst[order]):
        c = counts[d]
        if c < m_l and not np.any(level_nbrs[d, :c] == s):
            level_nbrs[d, c] = s
            counts[d] += 1


def _augment_reverse_blocked(level_nbrs: np.ndarray, members: np.ndarray,
                             pruned: np.ndarray, m_l: int) -> None:
    """Vectorized reverse-edge fill: rank edges within each destination
    group and scatter into the free slots at once (no dedup against the
    existing forward edges; a repeat only wastes the slot)."""
    src = np.repeat(members, pruned.shape[1])
    dst = pruned.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    if len(dst) == 0:
        return
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    first = np.concatenate([[True], dst[1:] != dst[:-1]])
    grp_start = np.flatnonzero(first)
    rank = np.arange(len(dst)) - grp_start[np.cumsum(first) - 1]
    slot = (level_nbrs[dst, :m_l] >= 0).sum(1) + rank
    keep = slot < m_l
    level_nbrs[dst[keep], slot[keep]] = src[keep]


def _knn_routed(mv: torch.Tensor, metric: str, kc: int,
                rng: np.random.RandomState, route_expand: int = 3,
                num_centroids: int | None = None, block: int = 65536
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate kNN among rows via sampled-centroid bucket routing: each
    row routes to its `route_expand` nearest of ~2√n sampled centroids and
    takes the exact kNN within the buckets it routes to."""
    n = mv.shape[0]
    dev = mv.device
    kc = min(kc, n - 1)
    C = num_centroids or int(np.clip(2 * np.sqrt(n), 64, 4096))
    C = min(C, n)
    expand = min(route_expand, C)
    cents = mv[torch.as_tensor(rng.choice(n, C, replace=False), device=dev)]
    routes = torch.empty((n, expand), dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        d = _pairwise_dists(mv[s:s + block], cents, metric)
        routes[s:s + block] = torch.topk(d, expand, dim=1, largest=False,
                                         sorted=True).indices
    primary = routes[:, 0]
    order = torch.sort(primary, stable=True).indices
    cgrid = torch.arange(C + 1, device=dev)
    bounds = torch.searchsorted(primary[order], cgrid).tolist()
    flat = routes.reshape(-1)
    q_order = torch.sort(flat, stable=True).indices
    q_rows = q_order // expand
    q_bounds = torch.searchsorted(flat[q_order], cgrid).tolist()
    ids = torch.full((n, kc), -1, dtype=torch.int64, device=dev)
    dst = torch.full((n, kc), INF, dtype=torch.float32, device=dev)
    for c in range(C):
        grp = order[bounds[c]:bounds[c + 1]]
        qr = q_rows[q_bounds[c]:q_bounds[c + 1]]
        if len(grp) == 0 or len(qr) == 0:
            continue
        d = _pairwise_dists(mv[qr], mv[grp], metric)
        d[qr[:, None] == grp[None, :]] = INF                   # drop self
        t = min(kc, len(grp))
        top = torch.topk(d, t, dim=1, largest=False, sorted=True)
        cat_d = torch.cat([dst[qr], top.values], 1)
        cat_i = torch.cat([ids[qr], grp[top.indices]], 1)
        best = torch.topk(cat_d, kc, dim=1, largest=False, sorted=True)
        dst[qr] = best.values
        ids[qr] = torch.gather(cat_i, 1, best.indices)
    # a row can reach the same neighbor through several buckets: mask the
    # repeats so the pruner never keeps one twice
    srt, inv = torch.sort(ids, dim=1, stable=True)
    dup_sorted = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                            srt[:, 1:] == srt[:, :-1]], 1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, inv, dup_sorted)
    dst[dup] = INF
    ids[dup] = -1
    o = torch.sort(dst, dim=1, stable=True).indices
    return torch.gather(ids, 1, o), torch.gather(dst, 1, o)


def build_graph(store: VectorStore, m: int = 16, ef_construction: int = 64,
                seed: int = 0, max_level: int | None = None,
                device="cuda") -> HNSWGraph:
    """The exact recipe: exact kNN candidates on every level."""
    return build_graph_blocked(store, m=m, ef_construction=ef_construction,
                               seed=seed, max_level=max_level,
                               exact_threshold=None, device=device)


def build_graph_blocked(store: VectorStore, m: int = 16,
                        ef_construction: int = 32, seed: int = 0,
                        max_level: int | None = None,
                        exact_threshold: int | None = 20_000,
                        route_expand: int = 3, device="cuda") -> HNSWGraph:
    """`build_graph` recipe with cluster-routed candidates on big levels.

    Levels with <= `exact_threshold` members (every level when it is None)
    take exact kNN candidates, the edge-by-edge reverse fill and the
    union-find repair; larger levels take `_knn_routed` and the vectorized
    reverse fill and repair."""
    check_store_device(store, device)
    vectors = store.vectors
    dev = vectors.device
    n = vectors.shape[0]
    exact_max = n if exact_threshold is None else exact_threshold
    rng = np.random.RandomState(seed)
    ml = 1.0 / np.log(max(m, 2))
    levels = np.minimum(
        np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int64),
        12)
    if max_level is not None:
        levels = np.minimum(levels, max_level)
    top = int(levels.max())
    entry = int(np.argmax(levels))
    mmax0 = 2 * m
    nbrs = np.full((top + 1, n, mmax0), -1, np.int64)

    for lvl in range(top + 1):
        members = np.where(levels >= lvl)[0]
        if len(members) <= 1:
            continue
        mv = vectors[torch.as_tensor(members, device=dev)]
        m_l = mmax0 if lvl == 0 else m
        kc = min(max(ef_construction, m_l + 8), len(members) - 1)
        exact = len(members) <= exact_max
        if exact:
            cand_local, cand_d = _knn_among(mv, store.metric, kc)
        else:
            cand_local, cand_d = _knn_routed(mv, store.metric, kc, rng,
                                             route_expand=route_expand)
        # long-range candidates (NSW semantics): random rows appended
        # before pruning, so the heuristic can keep a few long edges
        n_m = len(members)
        n_rand = min(8, n_m - 1)
        if n_rand > 0:
            rnd = rng.randint(0, n_m, size=(n_m, n_rand)).astype(np.int64)
            rnd = np.where(rnd == np.arange(n_m)[:, None],
                           (rnd + 1) % n_m, rnd)
            rnd = torch.as_tensor(rnd, device=dev)
            rd = _rows_dist(mv, rnd, store.metric)
            cand_local = torch.cat([cand_local, rnd], 1)
            cand_d = torch.cat([cand_d, rd], 1)
            order = torch.sort(cand_d, dim=1, stable=True).indices
            cand_local = torch.gather(cand_local, 1, order)
            cand_d = torch.gather(cand_d, 1, order)
        pruned_local = _diversity_prune(mv, cand_local, cand_d, m_l,
                                        store.metric).cpu().numpy()
        pruned = np.where(pruned_local >= 0,
                          members[np.clip(pruned_local, 0, None)], -1)
        nbrs[lvl, members, :m_l] = pruned[:, :m_l]
        if exact:
            _augment_reverse(nbrs[lvl], members, pruned, m_l)
        else:
            _augment_reverse_blocked(nbrs[lvl], members, pruned, m_l)
        if lvl == 0:
            if n <= exact_max:
                _repair_connectivity(nbrs[0], vectors, store.metric)
            else:
                _repair_connectivity_blocked(nbrs[0], vectors, store.metric,
                                             rng)

    return HNSWGraph(
        neighbors=torch.as_tensor(nbrs.astype(np.int32), device=dev),
        node_level=torch.as_tensor(levels.astype(np.int32), device=dev),
        entry_point=entry, m=m)


# ---------------------------------------------------------------------------
# Incremental reference builder (classic HNSW inserts) — small N only.
# ---------------------------------------------------------------------------

def _pairwise_dists_np(x: np.ndarray, y: np.ndarray,
                       metric: str) -> np.ndarray:
    """`_pairwise_dists` in numpy, for the insert-at-a-time builder."""
    if metric == "ip":
        return -x @ y.T
    if metric == "cos":
        xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
        yn = y / (np.linalg.norm(y, axis=1, keepdims=True) + 1e-12)
        return 1.0 - xn @ yn.T
    d = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * (x @ y.T)
    return np.maximum(d, 0.0)


def build_incremental(store: VectorStore, m: int = 16,
                      ef_construction: int = 64, seed: int = 0,
                      device="cuda") -> HNSWGraph:
    """Classic HNSW construction, one insert at a time (greedy descent,
    ef-bounded layer search, the diversity heuristic, neighbour re-pruning
    when a list is full), in numpy on the host: the reference's builder,
    draw for draw and distance for distance, for small stores.  Returns
    the graph on the store's device."""
    dev = check_store_device(store, device)
    vectors = store.vectors.cpu().numpy()
    n = vectors.shape[0]
    rng = np.random.RandomState(seed)
    ml = 1.0 / np.log(max(m, 2))
    levels = np.minimum(
        np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int64),
        12)
    top = int(levels.max())
    mmax0 = 2 * m
    nbrs = np.full((top + 1, n, mmax0), -1, np.int64)
    metric = store.metric

    def dist(a, b_ids):
        return _pairwise_dists_np(vectors[a][None], vectors[b_ids], metric)[0]

    def pair(a, b):
        return float(_pairwise_dists_np(vectors[a][None],
                                        vectors[np.array([b])], metric)[0, 0])

    def greedy(q, entry, lvl):
        cur, cur_d = entry, dist(q, np.array([entry]))[0]
        while True:
            nb = nbrs[lvl, cur]
            nb = nb[nb >= 0]
            if len(nb) == 0:
                return cur
            ds = dist(q, nb)
            j = int(np.argmin(ds))
            if ds[j] < cur_d:
                cur, cur_d = int(nb[j]), float(ds[j])
            else:
                return cur

    def search_layer(q, entry, lvl, ef):
        visited = {entry}
        ds0 = float(dist(q, np.array([entry]))[0])
        cand = [(ds0, entry)]
        result = [(ds0, entry)]
        while cand:
            cand.sort()
            d_c, c = cand.pop(0)
            result.sort()
            if d_c > result[min(len(result), ef) - 1][0] and len(result) >= ef:
                break
            nb = nbrs[lvl, c]
            nb = [int(x) for x in nb[nb >= 0] if int(x) not in visited]
            if not nb:
                continue
            visited.update(nb)
            ds = dist(q, np.array(nb))
            worst = result[min(len(result), ef) - 1][0]
            for dd, node in zip(ds, nb):
                if len(result) < ef or dd < worst:
                    cand.append((float(dd), node))
                    result.append((float(dd), node))
                    result.sort()
                    result = result[:ef]
                    worst = result[-1][0]
        return result

    def select(cand_pairs, m_l):
        kept: list[int] = []
        for d_c, c in sorted(cand_pairs):
            if len(kept) >= m_l:
                break
            if all(pair(c, k) > d_c for k in kept):
                kept.append(c)
        return kept

    entry = 0
    entry_level = int(levels[0])
    for i in range(1, n):
        lvl_i = int(levels[i])
        ep = entry
        for lvl in range(entry_level, lvl_i, -1):
            ep = greedy(i, ep, min(lvl, entry_level))
        for lvl in range(min(lvl_i, entry_level), -1, -1):
            res = search_layer(i, ep, lvl, ef_construction)
            m_l = mmax0 if lvl == 0 else m
            sel = select(res, m_l)
            nbrs[lvl, i, : len(sel)] = sel
            for s in sel:
                cur = nbrs[lvl, s]
                free = np.where(cur < 0)[0]
                if len(free):
                    cur[free[0]] = i
                else:
                    # re-prune the neighbour's full list with i included
                    cand = [(pair(s, int(c)), int(c)) for c in cur]
                    sel2 = select(cand + [(pair(s, i), i)], m_l)
                    cur[:] = -1
                    cur[: len(sel2)] = sel2
            ep = res[0][1]
        if lvl_i > entry_level:
            entry, entry_level = i, lvl_i

    return HNSWGraph(neighbors=torch.as_tensor(nbrs, dtype=torch.int32,
                                               device=dev),
                     node_level=torch.as_tensor(levels, dtype=torch.int32,
                                                device=dev),
                     entry_point=int(entry), m=m)


# ---------------------------------------------------------------------------
# JAG-style attribute-partitioned graphs.  For a hot predicate family (a
# filter bitmap shared by many queries) a dedicated subgraph over exactly
# the family's passing rows is traversed UNFILTERED: every row passes by
# construction, so the per-node filter checks vanish.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """One predicate family's subgraph.  rows: (n_f,) int64 ascending
    global row ids (local id i is global rows[i]); store and graph index
    the gathered rows."""

    tag: str
    bitmap: torch.Tensor        # (W,) int32 packed family bitmap
    rows: torch.Tensor          # (n_f,) int64 global row ids, ascending
    store: VectorStore          # gathered family rows (+ SQ8 shadow)
    graph: HNSWGraph            # subgraph over the local rows


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """The registered family subgraphs.  built_n is the base store's row
    count at build time: a store grown past it makes every partition
    stale."""

    partitions: tuple[GraphPartition, ...]
    built_n: int

    @property
    def tags(self) -> tuple[str, ...]:
        return tuple(p.tag for p in self.partitions)

    def to(self, device) -> "PartitionedGraph":
        """A copy with every partition's tensors on `device`."""
        return dataclasses.replace(self, partitions=tuple(
            dataclasses.replace(p, bitmap=p.bitmap.to(device),
                                rows=p.rows.to(device),
                                store=to_device(p.store, device),
                                graph=to_device(p.graph, device))
            for p in self.partitions))

    def match(self, bitmaps: torch.Tensor) -> torch.Tensor:
        """(Q,) int32 partition index whose bitmap equals each query's
        bitmap word for word, or -1; compared on the device."""
        if not self.partitions:
            return torch.full((bitmaps.shape[0],), -1, dtype=torch.int32,
                              device=bitmaps.device)
        return match_bitmaps(bitmaps, torch.stack(
            [p.bitmap for p in self.partitions]))


def gather_substore(store: VectorStore, rows: torch.Tensor) -> VectorStore:
    """Dense sub-store over `rows` (ascending global ids), carrying the SQ8
    shadow rows verbatim when present."""
    v = store.vectors[rows].contiguous()
    sub = VectorStore(vectors=v, norms_sq=(v * v).sum(-1),
                      metric=store.metric)
    if store.has_sq8:
        sub = dataclasses.replace(
            sub, q_vectors=store.q_vectors[rows].contiguous(),
            q_scale=store.q_scale, q_mean=store.q_mean,
            q_norms_sq=store.q_norms_sq[rows].contiguous())
    return sub


def build_graph_partitioned(store: VectorStore,
                            families: dict[str, torch.Tensor], m: int = 16,
                            ef_construction: int = 32, seed: int = 0,
                            blocked_threshold: int = 20_000,
                            device="cuda") -> PartitionedGraph:
    """One subgraph per predicate family (tag -> packed (W,) int32
    bitmap), each built on the store's device with the base graph's
    recipe: `build_graph` up to `blocked_threshold` rows, the
    cluster-routed `build_graph_blocked` above."""
    dev = check_store_device(store, device)
    n = store.n
    parts = []
    for i, tag in enumerate(sorted(families)):
        bm = families[tag].to(dev)
        rows = torch.nonzero(unpack_bitmap(bm, n)).flatten()
        if rows.numel() < 2:
            raise ValueError(f"family {tag!r} has {rows.numel()} passing "
                             "rows; a subgraph needs at least 2")
        sub = gather_substore(store, rows)
        build = (build_graph if rows.numel() <= blocked_threshold
                 else build_graph_blocked)
        g = build(sub, m=m, ef_construction=ef_construction, seed=seed + i,
                  device=dev)
        parts.append(GraphPartition(tag=tag, bitmap=bm, rows=rows,
                                    store=sub, graph=g))
    return PartitionedGraph(partitions=tuple(parts), built_n=n)
