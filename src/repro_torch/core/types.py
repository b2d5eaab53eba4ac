"""Core datatypes of the filter-agnostic FVS framework, on PyTorch tensors.

The object model is the paper's: a vector collection ("heap" rows), one
packed filter bitmap per query (the index never sees predicates, only
row-id bitmaps) and the per-query system counters of the paper's Table 6.

Conventions every module of the port keeps:
  * uint32 bitmap words are held as bit-reinterpreted int32 (PyTorch has no
    right shift for uint32 on the CPU); bit b of row r is
    `(words[r >> 5] >> (r & 31)) & 1`, right for bit 31 because `& 1`
    discards the sign fill of the arithmetic shift;
  * row id -1 is padding everywhere: +inf distance, false filter pass;
  * `topk_smallest` is stable (ties keep the lowest index first), the order
    the reference's `lax.top_k` gives and the search engines rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.storage.pages import (heap_pages_per_vector,  # noqa: F401
                                       quant_heap_pages_per_vector)

METRIC_L2 = "l2"
METRIC_IP = "ip"
METRIC_COS = "cos"

INF = float("inf")


def resolve_device(device) -> torch.device:
    """The device rule of every entry point: CUDA unless the caller names
    another device, and no silent fallback when the card is missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class VectorStore:
    """A vector collection on one device.

    vectors: (N, d) float32 full-precision rows ("heap" in the paper).
    norms_sq: (N,) float32 squared norms (the L2 fast path).

    The SQ8 shadow is the graph engine's quantized-traversal tier:
    per-dimension affine int8 rows (dequantized as q_vectors * q_scale +
    q_mean) and the dequantized rows' squared norms.  None until
    `quantize_store` attaches it; the full-precision rows stay
    authoritative (exact rerank, ground truth).
    """

    vectors: torch.Tensor
    norms_sq: torch.Tensor
    metric: str = METRIC_L2
    q_vectors: Optional[torch.Tensor] = None     # (N, d) int8
    q_scale: Optional[torch.Tensor] = None       # (d,) f32
    q_mean: Optional[torch.Tensor] = None        # (d,) f32
    q_norms_sq: Optional[torch.Tensor] = None    # (N,) f32, dequantized rows

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def has_sq8(self) -> bool:
        return self.q_vectors is not None

    @staticmethod
    def build(vectors, metric: str = METRIC_L2,
              device="cuda") -> "VectorStore":
        dev = resolve_device(device)
        v = torch.as_tensor(np.asarray(vectors, np.float32)
                            if not isinstance(vectors, torch.Tensor)
                            else vectors, dtype=torch.float32, device=dev)
        v = v.contiguous()
        return VectorStore(vectors=v, norms_sq=(v * v).sum(-1), metric=metric)


def check_store_device(store: VectorStore, device) -> torch.device:
    """Resolve an entry point's `device` and require the store to be on it."""
    dev = resolve_device(device)
    if store.device.type != dev.type:
        raise ValueError(f"store is on {store.device}, but device={dev}")
    return store.device


def sq8_quantize(x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-dimension affine SQ8 over a dataset, on x's device.  Returns
    (q (n, d) int8, scale (d,) f32, mean (d,) f32) with dequantization
    x̂ = q * scale + mean.  Byte-identical to the reference's numpy
    quantizer: the same float32 operations in the same order (min/max are
    exact, division is correctly rounded, both roundings are
    half-to-even).  The divisor 254 is a tensor: CUDA divides by a Python
    scalar as a product with its rounded reciprocal, which is not
    correctly rounded."""
    lo, hi = x.min(0).values, x.max(0).values
    scale = ((hi - lo) / torch.full_like(hi, 254.0)).clamp(min=1e-8)
    mean = (hi + lo) / 2.0
    q = torch.round((x - mean) / scale).clamp(-127, 127).to(torch.int8)
    return q, scale, mean


def quantize_store(store: VectorStore) -> VectorStore:
    """The store with its SQ8 shadow attached, computed on the store's
    device (idempotent: a store that has one is returned as it is).
    q_norms_sq dequantizes as the plain SQ8 frontier scan does."""
    if store.has_sq8:
        return store
    q, scale, mean = sq8_quantize(store.vectors)
    deq = q.to(torch.float32) * scale + mean
    return dataclasses.replace(store, q_vectors=q, q_scale=scale,
                               q_mean=mean, q_norms_sq=(deq * deq).sum(-1))


def distance(metric: str, q: torch.Tensor, x: torch.Tensor,
             x_norm_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distance between query q (..., d) and rows x (..., d); lower is
    closer.  Elementwise product + last-axis sum, never a matrix product:
    the frontier kernel's plain version and the search engines share this
    arithmetic."""
    if metric == METRIC_L2:
        if x_norm_sq is None:
            x_norm_sq = (x * x).sum(-1)
        qn = (q * q).sum(-1)
        return qn + x_norm_sq - 2.0 * (q * x).sum(-1)
    if metric == METRIC_IP:
        return -(q * x).sum(-1)
    if metric == METRIC_COS:
        qn = torch.linalg.norm(q, dim=-1) + 1e-12
        xn = torch.linalg.norm(x, dim=-1) + 1e-12
        return 1.0 - (q * x).sum(-1) / (qn * xn)
    raise ValueError(f"unknown metric {metric!r}")


# ---------------------------------------------------------------------------
# Filter bitmaps: packed words over row ids, one bitmap per query.
# ---------------------------------------------------------------------------

def words_from_uint32(words: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 words (numpy) -> the port's bit-reinterpreted int32 tensor."""
    arr = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
    return torch.as_tensor(arr.copy(), device=resolve_device(device))


def words_to_uint32(words: torch.Tensor) -> np.ndarray:
    """The port's int32 words -> uint32 numpy words with the same bits."""
    return words.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_bool_bitmap(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n/32)) int32 packed words."""
    bits = bits.to(torch.bool)
    n = bits.shape[-1]
    pad = (-n) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    words = bits.reshape(bits.shape[:-1] + (-1, 32)).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, device=bits.device))
    return _wrap_int32((words * weights).sum(-1))


def pack_bitmap(passing_rows, n: int, device="cuda") -> torch.Tensor:
    """Pack a row-id set into a (ceil(n/32),) int32 bitmap."""
    dev = resolve_device(device)
    bits = torch.zeros(n, dtype=torch.bool, device=dev)
    bits[torch.as_tensor(np.asarray(passing_rows), device=dev,
                         dtype=torch.int64)] = True
    return pack_bool_bitmap(bits)


def probe_bitmap(bitmap: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
    """Filter check of one (W,) bitmap per row id; negative ids -> False."""
    safe = row_ids.clamp(min=0).to(torch.int64)
    word = bitmap[safe >> 5]
    bit = torch.bitwise_right_shift(word, (safe & 31).to(word.dtype)) & 1
    return (bit == 1) & (row_ids >= 0)


def probe_batch(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-query probe: (Q, W) words x (Q, ...) ids -> (Q, ...) bool."""
    flat = ids.reshape(ids.shape[0], -1)
    safe = flat.clamp(min=0).to(torch.int64)
    word = torch.gather(words, 1, safe >> 5)
    bit = torch.bitwise_right_shift(word, (safe & 31).to(word.dtype)) & 1
    return ((bit == 1) & (flat >= 0)).reshape(ids.shape)


def unpack_bitmap(bitmap: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n) bool."""
    shifts = torch.arange(32, device=bitmap.device, dtype=bitmap.dtype)
    bits = torch.bitwise_right_shift(bitmap[..., :, None], shifts) & 1
    return bits.reshape(bitmap.shape[:-1] + (-1,))[..., :n].to(torch.bool)


def bitmap_andnot(bitmap: torch.Tensor, minus: torch.Tensor) -> torch.Tensor:
    """bitmap AND NOT minus over packed words; words past either end of
    `minus` pass through unchanged."""
    w = min(bitmap.shape[-1], minus.shape[-1])
    out = bitmap.clone()
    out[..., :w] = bitmap[..., :w] & ~minus[..., :w].to(bitmap.dtype)
    return out


def bitmap_popcount(bitmaps: torch.Tensor) -> torch.Tensor:
    """Per-query popcount over packed words: (Q, W) -> (Q,) int32."""
    x = bitmaps.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & 0xFFFFFFFF
    return (x >> 24).sum(-1).to(torch.int32)


def match_bitmaps(bitmaps: torch.Tensor, catalog: torch.Tensor
                  ) -> torch.Tensor:
    """(Q,) int32 index of the catalog row (F, W) each query's bitmap
    (Q, W) equals word for word, or -1; the first match wins.  Compared
    on the device as one (Q, F, W) block."""
    q = bitmaps.shape[0]
    if catalog.shape[0] == 0:
        return torch.full((q,), -1, dtype=torch.int32, device=bitmaps.device)
    eq = (bitmaps[:, None, :] == catalog.to(bitmaps.device)[None]).all(-1)
    return torch.where(eq.any(1), eq.to(torch.int8).argmax(1).to(torch.int32),
                       torch.full((q,), -1, dtype=torch.int32,
                                  device=bitmaps.device))


def bitset_words(n: int) -> int:
    """Words needed for a packed bitset over n row ids."""
    return (n + 31) // 32


def bitset_zeros(n: int, device="cuda") -> torch.Tensor:
    return torch.zeros((bitset_words(n),), dtype=torch.int32,
                       device=resolve_device(device))


def bitset_mark(words: torch.Tensor, row_ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Set the bits of `row_ids[mask]` in a packed (W,) bitset.

    Contract (as in the reference): the masked ids are distinct and
    currently unset, because the update adds each bit's weight.  Negative
    ids are ignored whatever `mask` says."""
    live = mask & (row_ids >= 0)
    safe = row_ids.clamp(min=0).to(torch.int64).reshape(-1)
    one = torch.ones_like(safe, dtype=torch.int32)
    bit = torch.bitwise_left_shift(one, (safe & 31).to(torch.int32))
    bit = torch.where(live.reshape(-1), bit, torch.zeros_like(bit))
    return words.index_add(0, safe >> 5, bit)


# ---------------------------------------------------------------------------
# Search statistics: the columns of the paper's Table 6, one (Q,) int32
# tensor per counter.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchStats:
    distance_comps: torch.Tensor   # scored candidates
    filter_checks: torch.Tensor    # bitmap probes
    hops: torch.Tensor             # graph hops / leaves scanned (ScaNN)
    page_accesses_index: torch.Tensor
    page_accesses_heap: torch.Tensor
    tmap_lookups: torch.Tensor     # translation-map lookups
    reorder_rows: torch.Tensor     # ScaNN reordering candidates

    @staticmethod
    def zeros(shape=(), device="cuda") -> "SearchStats":
        z = torch.zeros(shape, dtype=torch.int32,
                        device=resolve_device(device))
        return SearchStats(*(z.clone() for _ in range(7)))

    def __add__(self, other: "SearchStats") -> "SearchStats":
        return SearchStats(*(getattr(self, f.name) + getattr(other, f.name)
                             for f in dataclasses.fields(self)))

    @staticmethod
    def cat(parts: list["SearchStats"]) -> "SearchStats":
        return SearchStats(*(torch.cat([getattr(p, f.name) for p in parts])
                             for f in dataclasses.fields(SearchStats)))

    def as_dict(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name).detach().cpu().numpy().tolist()
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Run-time knobs (paper §5 'Hyperparameter Tuning').  The same fields
    as the reference's SearchParams, so one object describes a run on both
    sides; knobs of tiers the port does not have yet are rejected by the
    executors that would need them."""

    k: int = 10
    ef_search: int = 64
    beam_width: int = 64
    max_hops: int = 512
    strategy: str = "sweeping"
    two_hop: bool = True
    adaptive_skip_2hop: bool = True
    translation_map: bool = True
    navix_heuristic: str = "adaptive"
    graph_exec_mode: str = "frontier"
    graph_quant: str = "none"
    frontier_chunk: int = 0
    frontier_chunk2: int = 64
    num_leaves_to_search: int = 32
    reorder_factor: int = 4
    scann_page_accounting: str = "batch"
    scann_query_block: int = 0
    batch_tuples: int = 128
    max_rounds: int = 16
    page_budget: int = 0
    hop_budget: int = 0
    deadline_cycles: float = 0.0
    sq8_rerank: bool = True
    beam_exchange_interval: int = 1
    exclusion: str = "none"
    exclusion_margin: float = 0.5


@dataclasses.dataclass
class AnytimeInfo:
    """Per-query anytime flags, derived on the host from final counters."""

    truncated: np.ndarray          # (Q,) bool
    budget_exhausted: np.ndarray   # (Q,) bool
    completion: np.ndarray         # (Q,) f32 in [0, 1]

    def as_dict(self) -> dict[str, Any]:
        return dict(truncated=self.truncated.tolist(),
                    budget_exhausted=self.budget_exhausted.tolist(),
                    completion=self.completion.tolist())


@dataclasses.dataclass
class SearchResult:
    """Return convention of every executor: ids/dists (Q, k), ids
    -1-padded where fewer than k rows pass; stats with (Q,) counters."""

    dists: torch.Tensor
    ids: torch.Tensor
    stats: Optional[SearchStats]
    strategy: str
    plan: Any = None
    storage: Any = None
    anytime: Any = None


def to_device(obj, device):
    """A copy of a frozen dataclass of tensors (VectorStore, HNSWGraph,
    ScannIndex) with every tensor field moved to `device`."""
    dev = resolve_device(device)
    moved = {f.name: getattr(obj, f.name).to(dev)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **moved)


def topk_smallest(values: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries along the last axis,
    ascending, ties broken by lowest index (a stable sort, sliced)."""
    vals, idx = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_topk(dists_a: torch.Tensor, ids_a: torch.Tensor,
               dists_b: torch.Tensor, ids_b: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K-way merge of two (Q, ka)/(Q, kb) top-k sets into one (Q, k) set.
    Padded slots carry +inf; exact ties keep `a` before `b`.  Slots past
    the finite candidates come back as (+inf, -1)."""
    dists = torch.cat([dists_a, dists_b], -1)
    ids = torch.cat([ids_a, ids_b], -1)
    best, pos = topk_smallest(dists, k)
    out = torch.gather(ids, -1, pos)
    return best, torch.where(torch.isinf(best), torch.full_like(out, -1), out)


def recall_at_k(found_ids: torch.Tensor, true_ids: torch.Tensor,
                k: int) -> torch.Tensor:
    """|found ∩ true| / k per query; ids may contain -1 padding."""
    f = found_ids[..., :k]
    t = true_ids[..., :k].to(f.device)
    eq = (f[..., :, None] == t[..., None, :]) & (f[..., :, None] >= 0)
    return eq.any(-1).sum(-1).to(torch.float32) / k
