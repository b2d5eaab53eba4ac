"""Synthetic vector datasets shaped like the paper's Table 2.

Clustered Gaussian mixtures with the paper datasets' shape parameters
(dimensionality, metric, in- or out-of-distribution queries).  The rows are
drawn with numpy from the caller's seed, in the same order as the reference
generator, so the same (spec, seed) gives byte-identical vectors and
queries on both sides; only then are they moved to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import VectorStore, resolve_device


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
