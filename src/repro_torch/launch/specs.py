"""Input specs: the (shape, dtype) of every model input, per (arch x
shape) cell, and `make_smoke_batch`, small real batches of the same
layout.

The counterpart of the reference's `launch/specs.py`, with torch dtypes
where it has `jax.ShapeDtypeStruct`s.  `make_smoke_batch` draws with the
reference's `RandomState` calls in the reference's order, so its batches
are the reference's byte for byte.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.core.types import resolve_device


def train_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    b, t = shape.global_batch, shape.seq_len
    if cfg.family == "encoder":
        return {"frames": ((b, t, cfg.d_model), torch.float32),
                "mask_positions": ((b, t), torch.bool),
                "targets": ((b, t), torch.int32)}
    batch = {"tokens": ((b, t), torch.int32),
             "targets": ((b, t), torch.int32),
             "mask": ((b, t), torch.float32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = ((b, cfg.num_patches, cfg.d_model),
                                 torch.float32)
    return batch


def prefill_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    b, t = shape.global_batch, shape.seq_len
    if cfg.family == "encoder":
        return {"frames": ((b, t, cfg.d_model), torch.float32)}
    batch = {"tokens": ((b, t), torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = ((b, cfg.num_patches, cfg.d_model),
                                 torch.float32)
    return batch


def decode_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    return {"tokens": ((shape.global_batch, 1), torch.int32)}


def input_specs(cfg: ArchConfig, shape_name: str) -> dict[str, Any]:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)


def make_smoke_batch(cfg: ArchConfig, batch: int, seq: int,
                     kind: str = "train", seed: int = 0,
                     device="cuda") -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    out = {}
    if cfg.family == "encoder":
        out["frames"] = rng.randn(batch, seq, cfg.d_model).astype(np.float32)
        if kind == "train":
            out["mask_positions"] = rng.rand(batch, seq) < 0.3
            out["targets"] = rng.randint(0, cfg.num_classes,
                                         (batch, seq)).astype(np.int32)
    else:
        out["tokens"] = rng.randint(
            0, cfg.vocab, (batch, seq if kind != "decode" else 1)
        ).astype(np.int32)
        if kind == "train":
            out["targets"] = rng.randint(0, cfg.vocab,
                                         (batch, seq)).astype(np.int32)
            out["mask"] = np.ones((batch, seq), np.float32)
        if cfg.family == "vlm" and kind != "decode":
            out["patch_embeds"] = rng.randn(
                batch, cfg.num_patches, cfg.d_model).astype(
                    np.float32) * 0.02
    return {k: torch.as_tensor(v, device=dev) for k, v in out.items()}
