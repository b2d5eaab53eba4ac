"""FAVOR-style selectivity-aware exclusion radii.

Filtered graph traversal drowns in per-node filter checks.  FAVOR's answer
is a build-time index of exclusion distances: for every node v, the
distance from v to its nearest row that could pass a predicate.  A scored
candidate whose radius proves that no passing row reachable through it can
beat the current result tail is kept out of the traversal pool (the keep
rule of the `frontier_scan_excl[_sq8]` kernels).

Two radius sources, both squared l2:

  * a ladder of K-th-NN radii for a static set of K values: for a
    predicate of selectivity s the engine takes the rung K ≈ 1/s;
  * family radii: for a registered predicate family (a bitmap shared by
    many queries), the exact distance from every node to its nearest
    passing row (0 for a passing row, +inf for an empty family).

The whole index is one (R + F, n) float32 table on the device (ladder rows
first), 52 MB at n = 1M; a batch selects one row per query
(`select_radii`), so no (Q, n) radius block is ever built.  The build runs
on the device: blocked full-float32 `torch.matmul` distance blocks, a
k-smallest selection for the ladder and a min over each family's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph_search import QueryRadii
from repro_torch.core.types import (METRIC_L2, VectorStore, bitmap_popcount,
                                    check_store_device, match_bitmaps,
                                    unpack_bitmap)

# Geometric K ladder: any selectivity in [1/n, 1] is within 2x of a rung.
# K=1 is the nearest *other* row (self excluded).
DEFAULT_LADDER_KS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class ExclusionIndex:
    """Per-node exclusion radii (squared l2).

    radii: (R + F, N) f32: row r < R is the ladder_ks[r]-th-NN radius
        (self excluded), row R + f the exact radius of family f.
    family_bitmaps: (F, W) int32 packed bitmaps of the registered
        families, matched word for word at plan time.
    """

    radii: torch.Tensor
    family_bitmaps: torch.Tensor
    ladder_ks: tuple[int, ...] = DEFAULT_LADDER_KS
    family_tags: tuple[str, ...] = ()

    @property
    def n(self) -> int:
        return self.radii.shape[1]

    @property
    def num_families(self) -> int:
        return len(self.family_tags)

    @property
    def ladder(self) -> torch.Tensor:
        """(R, N) view of the ladder rows."""
        return self.radii[:len(self.ladder_ks)]

    @property
    def family_radii(self) -> torch.Tensor:
        """(F, N) view of the family rows."""
        return self.radii[len(self.ladder_ks):]


def _sq_dists(block: torch.Tensor, bnorms: torch.Tensor, rows: torch.Tensor,
              rnorms: torch.Tensor) -> torch.Tensor:
    """Squared l2 from each block row to each row, clamped at 0."""
    # (bn + rn) - 2 ip with one rounding, as the reference's expression
    # has: the product by 2 is exact
    d = torch.addmm(bnorms[:, None] + rnorms[None, :], block, rows.T,
                    alpha=-2.0)
    return d.clamp_(min=0.0)


def build_exclusion(store: VectorStore,
                    families: Optional[Mapping[str, torch.Tensor]] = None,
                    ladder_ks: Sequence[int] = DEFAULT_LADDER_KS,
                    block: int = 1024, device="cuda") -> ExclusionIndex:
    """Build the K-th-NN ladder and the exact per-family radii on the
    store's device.  families maps tag -> packed (W,) int32 bitmap of the
    family's passing rows (the bitmap its queries carry).  Products run in
    full float32 (TF32 off for the build)."""
    dev = check_store_device(store, device)
    if store.metric != METRIC_L2:
        raise ValueError("exclusion radii require metric='l2' "
                         f"(got {store.metric!r})")
    ladder_ks = tuple(int(k) for k in ladder_ks)
    if not ladder_ks or any(k < 1 for k in ladder_ks):
        raise ValueError("ladder_ks must be >= 1")
    n = store.n
    x, norms = store.vectors, store.norms_sq
    families = dict(families or {})
    tags = tuple(sorted(families))
    words = (n + 31) // 32
    fam_words = (torch.stack([families[t].to(dev) for t in tags]) if tags
                 else torch.zeros((0, words), dtype=torch.int32, device=dev))
    fam_bits = unpack_bitmap(fam_words, n)                       # (F, n)
    fam_rows = [torch.nonzero(b).flatten() for b in fam_bits]
    r = len(ladder_ks)
    radii = torch.full((r + len(tags), n), float("inf"), dtype=torch.float32,
                       device=dev)
    kmax = min(max(ladder_ks), n - 1) if n > 1 else 0
    rungs = torch.as_tensor([min(k, n - 1) - 1 for k in ladder_ks],
                            device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            blk, bn = x[lo:hi], norms[lo:hi]
            if kmax > 0:
                d = _sq_dists(blk, bn, x, norms)
                idx = torch.arange(hi - lo, device=dev)
                d[idx, idx + lo] = float("inf")                  # drop self
                head = torch.topk(d, kmax, dim=1, largest=False,
                                  sorted=True).values
                radii[:r, lo:hi] = head[:, rungs].T
                del d, head
            for f, rows in enumerate(fam_rows):
                if rows.numel():
                    fd = _sq_dists(blk, bn, x[rows], norms[rows])
                    radii[r + f, lo:hi] = torch.where(
                        fam_bits[f, lo:hi], torch.zeros_like(bn),
                        fd.min(1).values)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return ExclusionIndex(radii=radii, family_bitmaps=fam_words,
                          ladder_ks=ladder_ks, family_tags=tags)


def ladder_rung(excl: ExclusionIndex, selectivity: float) -> int:
    """Ladder row whose K is nearest (in log space) to 1/selectivity."""
    target = 1.0 / max(float(selectivity), 1e-9)
    ks = np.asarray(excl.ladder_ks, np.float64)
    return int(np.argmin(np.abs(np.log(ks) - np.log(target))))


def match_families(excl: ExclusionIndex, bitmaps: torch.Tensor
                   ) -> torch.Tensor:
    """(Q,) int32 index of the registered family whose bitmap equals each
    query's bitmap word for word, or -1 (exact match only)."""
    return match_bitmaps(bitmaps, excl.family_bitmaps)


def select_radii(excl: ExclusionIndex, bitmaps: torch.Tensor,
                 selectivity: Optional[float] = None) -> QueryRadii:
    """Per-query radii: the exact family row where the query's bitmap
    matches a registered family, else the ladder rung for K ≈
    1/selectivity (selectivity defaults to the batch's mean popcount / n).
    Returned as the table and one row index per query; `.dense()` is the
    reference's (Q, n) block."""
    if selectivity is None:
        pop = bitmap_popcount(bitmaps).to(torch.float64)
        selectivity = float(pop.mean()) / max(excl.n, 1)
    rung = ladder_rung(excl, selectivity)
    fam = match_families(excl, bitmaps)
    rows = torch.where(fam >= 0, fam + len(excl.ladder_ks),
                       torch.full_like(fam, rung))
    return QueryRadii(excl.radii, rows.to(torch.int32))
