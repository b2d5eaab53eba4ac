"""Dataset and query pool of a configuration, made on the device.

The recipe is the clustered Gaussian mixture of the program's
`DatasetSpec` (`clusters` unit-norm centres, each row a centre plus
`cluster_spread * N(0, I) / sqrt(dim)`), rewritten in torch so a
million rows of 768 dims are drawn on the card in a few large calls
rather than on the host.  With `normalize`, rows and queries are scaled
to unit length (a cosine dataset searched with L2).  Queries are drawn in
distribution: a centre picked at random plus the same noise.
"""
from __future__ import annotations

import torch

# Rows drawn per call: large enough to keep the launches few, small enough
# that the noise block of a 768-dim config stays under a GiB.
ROW_BLOCK = 262_144


def make_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _mixture(centers: torch.Tensor, count: int, spread: float,
             normalize: bool, gen: torch.Generator) -> torch.Tensor:
    k, dim = centers.shape
    dev = centers.device
    out = torch.empty((count, dim), dtype=torch.float32, device=dev)
    for s in range(0, count, ROW_BLOCK):
        e = min(s + ROW_BLOCK, count)
        assign = torch.randint(0, k, (e - s,), generator=gen, device=dev)
        noise = torch.randn((e - s, dim), generator=gen, device=dev)
        x = centers[assign] + noise * (spread / dim ** 0.5)
        if normalize:
            x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        out[s:e] = x
    return out


def make_vectors(cfg: dict, pool: int, seed: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (n, dim) f32, queries (pool, dim) f32) on `device`.  The
    table is the configuration's: its centres and rows are drawn from the
    configuration's `data_seed`, so every run searches (and builds an
    index over) the same deployment.  The queries are drawn from `seed`."""
    gen = make_generator(cfg["data_seed"], device)
    centers = torch.randn((cfg["clusters"], cfg["dim"]), generator=gen,
                          device=device)
    centers = centers / torch.linalg.norm(centers, dim=1, keepdim=True)
    rows = _mixture(centers, cfg["n"], cfg["cluster_spread"],
                    cfg["normalize"], gen)
    queries = _mixture(centers, pool, cfg["cluster_spread"],
                       cfg["normalize"], make_generator(seed, device))
    return rows, queries
