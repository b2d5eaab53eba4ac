"""Synthetic vector datasets shaped like the paper's Table 2.

Clustered Gaussian mixtures with the paper datasets' shape parameters
(dimensionality, metric, in- or out-of-distribution queries).  The rows are
drawn with numpy from the caller's seed, in the same order as the reference
generator, so the same (spec, seed) gives byte-identical vectors and
queries on both sides; only then are they moved to the device.
`make_dataset_streamed` is the block-streamed twin for giant n, with the
two-pass SQ8 shadow.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.types import VectorStore, resolve_device
from repro_torch.kernels.ref import dequantize


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    dim: int
    metric: str
    clusters: int = 64
    ood_queries: bool = False       # text2image-style OOD query hardness
    cluster_spread: float = 0.8     # intra-cluster std (unit-norm centers)


PAPER_DATASETS = {
    "sift10m": DatasetSpec("sift10m", 50_000, 128, "l2", clusters=128),
    "openai5m": DatasetSpec("openai5m", 25_000, 1536, "ip", clusters=64),
    "cohere10m": DatasetSpec("cohere10m", 50_000, 768, "l2", clusters=96),
    "text2image10m": DatasetSpec("text2image10m", 50_000, 200, "l2",
                                 clusters=128, ood_queries=True),
}


def make_dataset_numpy(spec: DatasetSpec, num_queries: int = 100,
                       seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(vectors (n, dim) f32, queries (num_queries, dim) f32) as numpy."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(spec.clusters, spec.dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.randint(0, spec.clusters, spec.n)
    x = centers[assign] + spec.cluster_spread * rng.randn(
        spec.n, spec.dim).astype(np.float32) / np.sqrt(spec.dim)
    if spec.metric == "ip":
        x /= np.linalg.norm(x, axis=1, keepdims=True)

    if spec.ood_queries:
        q = rng.randn(num_queries, spec.dim).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        q *= 1.4  # planted away from the unit-norm cluster shell
    else:
        qa = rng.randint(0, spec.clusters, num_queries)
        q = centers[qa] + spec.cluster_spread * rng.randn(
            num_queries, spec.dim).astype(np.float32) / np.sqrt(spec.dim)
        if spec.metric == "ip":
            q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(x, np.float32), q.astype(np.float32)


def make_dataset(spec: DatasetSpec, num_queries: int = 100, seed: int = 0,
                 device="cuda") -> tuple[VectorStore, torch.Tensor]:
    """Returns (store, queries (num_queries, dim) float32) on `device`."""
    dev = resolve_device(device)
    x, q = make_dataset_numpy(spec, num_queries, seed)
    store = VectorStore.build(x, metric=spec.metric, device=dev)
    return store, torch.as_tensor(q, device=dev)


# ---------------------------------------------------------------------------
# Streamed generation (DESIGN.md §13): row-block generation and a two-pass
# global SQ8 shadow, for the >= 5M x 768 operating points of the sharding
# bench.  Numpy end to end, in the reference's draw order.
# ---------------------------------------------------------------------------

# Default row-block quantum.  block_rows is part of the dataset identity:
# block b draws from its own counter-based Philox stream keyed (seed, b),
# so the same (spec, seed, block_rows) regenerates the same rows block by
# block, while another block_rows is another (equally valid) dataset.
STREAM_BLOCK = 65_536


def _stream_centers(spec: DatasetSpec, seed: int) -> np.ndarray:
    # make_dataset's first draws, so the query geometry matches
    rng = np.random.RandomState(seed)
    centers = rng.randn(spec.clusters, spec.dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return centers


def _stream_block(spec: DatasetSpec, centers: np.ndarray, seed: int,
                  b: int, lo: int, hi: int,
                  cache_dir: str | None) -> np.ndarray:
    """Rows [lo, hi) of the dataset, drawn from the (seed, b) Philox key or
    reloaded from the per-block cache."""
    path = None
    if cache_dir is not None:
        path = os.path.join(
            cache_dir, f"{spec.name}-n{spec.n}-d{spec.dim}"
            f"-c{spec.clusters}-sp{spec.cluster_spread}-s{seed}-b{b}.npy")
        if os.path.exists(path):
            return np.load(path)
    rng = np.random.Generator(
        np.random.Philox(key=[np.uint64(seed), np.uint64(b)]))
    m = hi - lo
    assign = rng.integers(0, spec.clusters, m)
    x = centers[assign] + spec.cluster_spread * rng.standard_normal(
        (m, spec.dim), dtype=np.float32) / np.sqrt(spec.dim)
    if spec.metric == "ip":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    # the /sqrt(dim) promotes to f64: cast at the block boundary, so every
    # consumer sees the same float32 bits
    x = x.astype(np.float32)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(path, x)
    return x


def make_dataset_streamed(spec: DatasetSpec, num_queries: int = 100,
                          seed: int = 0, block_rows: int = STREAM_BLOCK,
                          f32: bool = True, quantize: bool = True,
                          cache_dir: str | None = None, device="cuda"
                          ) -> tuple[VectorStore, torch.Tensor]:
    """Block-streamed twin of `make_dataset` for giant n: (store, queries
    (num_queries, dim) float32) on `device`.

    Rows are drawn (and optionally cached on disk) in `block_rows` blocks.
    The SQ8 shadow is the exact two-pass global per-dimension quantizer of
    `types.sq8_quantize`: pass 1 takes each dimension's min and max over
    the blocks (they compose exactly over any blocking), pass 2 runs each
    block through the same affine clip and round, so the shadow is the
    one quantizing the whole array gives, and its norms are summed as
    `types.quantize_store` sums them (on the CPU, block by block).

    `f32=False` never builds the (n, d) float32 heap: `vectors` and
    `norms_sq` are zero-strided all-zero placeholders (shape only) and
    only the int8 shadow and its norms are real.  Such a store serves
    geometry, page layouts and SQ8-only sharded traversal
    (`ShardedGraphExecutor(..., f32=False)`, graph_quant="sq8",
    sq8_rerank=False); a full-precision path would score zeros."""
    if num_queries > spec.n:
        raise ValueError("more queries than rows")
    dev = resolve_device(device)
    centers = _stream_centers(spec, seed)
    nblocks = -(-spec.n // block_rows)
    blocks = [(b, b * block_rows, min((b + 1) * block_rows, spec.n))
              for b in range(nblocks)]

    x_full = np.empty((spec.n, spec.dim), np.float32) if f32 else None
    lo_d = np.full((spec.dim,), np.inf, np.float32)
    hi_d = np.full((spec.dim,), -np.inf, np.float32)
    for b, lo, hi in blocks:
        x = _stream_block(spec, centers, seed, b, lo, hi, cache_dir)
        if quantize:
            np.minimum(lo_d, x.min(0), out=lo_d)
            np.maximum(hi_d, x.max(0), out=hi_d)
        if f32:
            x_full[lo:hi] = x

    if f32:
        store = VectorStore.build(x_full, metric=spec.metric, device=dev)
    else:
        store = VectorStore(
            vectors=torch.zeros((1, spec.dim), device=dev).expand(
                spec.n, spec.dim),
            norms_sq=torch.zeros((1,), device=dev).expand(spec.n),
            metric=spec.metric)

    if quantize:
        scale = np.maximum((hi_d - lo_d) / 254.0, 1e-8).astype(np.float32)
        mean = ((hi_d + lo_d) / 2.0).astype(np.float32)
        scale_t, mean_t = torch.as_tensor(scale), torch.as_tensor(mean)
        q = np.empty((spec.n, spec.dim), np.int8)
        qn = np.empty((spec.n,), np.float32)
        for b, lo, hi in blocks:
            x = x_full[lo:hi] if f32 else _stream_block(
                spec, centers, seed, b, lo, hi, cache_dir)
            qb = np.clip(np.round((x - mean) / scale), -127, 127
                         ).astype(np.int8)
            q[lo:hi] = qb
            deq = dequantize(torch.as_tensor(qb), scale_t, mean_t)
            qn[lo:hi] = (deq * deq).sum(-1).numpy()
        store = dataclasses.replace(
            store, q_vectors=torch.as_tensor(q, device=dev),
            q_scale=torch.as_tensor(scale, device=dev),
            q_mean=torch.as_tensor(mean, device=dev),
            q_norms_sq=torch.as_tensor(qn, device=dev))

    # the queries ride their own stream (a block id past any data block),
    # with make_dataset's hardness recipe
    qrng = np.random.Generator(
        np.random.Philox(key=[np.uint64(seed), np.uint64(2**63)]))
    if spec.ood_queries:
        qs = qrng.standard_normal((num_queries, spec.dim),
                                  dtype=np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        qs *= 1.4
    else:
        qa = qrng.integers(0, spec.clusters, num_queries)
        qs = centers[qa] + spec.cluster_spread * qrng.standard_normal(
            (num_queries, spec.dim), dtype=np.float32) / np.sqrt(spec.dim)
        if spec.metric == "ip":
            qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return store, torch.as_tensor(qs.astype(np.float32), device=dev)
