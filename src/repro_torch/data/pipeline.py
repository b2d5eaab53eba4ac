"""Deterministic, stateless synthetic token pipeline.

The counterpart of the reference's `data/pipeline.py`.
`batch_for_step(cfg, step)` is a pure function of (config, step): on a
restart the loop replays exactly, with no iterator state to checkpoint.
It draws with numpy and gives the reference's batches byte for byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def make_data_config(vocab_size: int, seq_len: int, global_batch: int,
                     seed: int = 0) -> DataConfig:
    return DataConfig(vocab_size, seq_len, global_batch, seed)


def token_batch_specs(cfg: DataConfig) -> dict[str, tuple]:
    """(shape, dtype) of each batch entry."""
    shape = (cfg.global_batch, cfg.seq_len)
    return {"tokens": (shape, torch.int32), "targets": (shape, torch.int32),
            "mask": (shape, torch.float32)}


def batch_for_step(cfg: DataConfig, step: int,
                   shard: tuple[int, int] = (0, 1)) -> dict[str, np.ndarray]:
    """Pure (config, step, shard) -> batch. shard = (index, count)."""
    idx, count = shard
    if cfg.global_batch % count:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {count} shards")
    local = cfg.global_batch // count
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2 ** 31))
    toks = rng.randint(0, cfg.vocab_size,
                       (cfg.global_batch, cfg.seq_len + 1), dtype=np.int64)
    # Markov-ish structure so the loss is learnable, not pure noise
    toks[:, 1:] = (toks[:, :-1] * 31 + toks[:, 1:] % 17) % cfg.vocab_size
    sl = slice(idx * local, (idx + 1) * local)
    return {
        "tokens": toks[sl, :-1].astype(np.int32),
        "targets": toks[sl, 1:].astype(np.int32),
        "mask": np.ones((local, cfg.seq_len), np.float32),
    }
