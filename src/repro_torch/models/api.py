"""Unified model API: one bundle per architecture family.

  bundle = build_model(cfg)
  params = bundle.init(seed_or_generator, device)
  logits = bundle.prefill(params, batch)              # inference prefill
  cache  = bundle.init_cache(batch, seq_len, device)  # decode state
  logits, cache = bundle.decode(params, cache, batch, pos)

The counterpart of the reference's `models/api.py` for the families the
port serves so far: "dense" and "encoder".  `loss` raises until training
is ported (ROADMAP 1.14d); the other families raise in `build_model`,
naming their ROADMAP items.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import encoder, transformer as tfm

TRAINING_ITEM = "training waits for ROADMAP 1.14d (optim, train, losses)"
FAMILY_ITEMS = {
    "moe": tfm.MOE_ITEM,
    "ssm": "the ssm family (rwkv) waits for ROADMAP 1.14c",
    "hybrid": "the hybrid family (zamba2) waits for ROADMAP 1.14c",
    "vlm": "the vlm family (llava) waits for ROADMAP 1.14c",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable[..., Any]
    loss: Callable[[Any, dict], torch.Tensor]
    prefill: Callable[[Any, dict], torch.Tensor]
    init_cache: Optional[Callable[..., Any]]
    decode: Optional[Callable[[Any, Any, dict, Any], tuple]]


def generator(key, device="cuda") -> torch.Generator:
    """A torch.Generator from a seed (on `device`) or a given generator,
    which must lie on `device`."""
    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        if key.device.type != dev.type:
            raise ValueError(f"generator on {key.device}, params asked on "
                             f"{dev}")
        return key
    return torch.Generator(device=dev).manual_seed(int(key))


def params_to(params, device):
    """A nested dict of tensors (params or a cache) copied to `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def _no_loss(params, batch):
    raise NotImplementedError(TRAINING_ITEM)


def build_model(cfg: ArchConfig) -> ModelBundle:
    fam = cfg.family
    if fam in FAMILY_ITEMS:
        raise NotImplementedError(FAMILY_ITEMS[fam])
    if fam == "dense":
        return ModelBundle(
            cfg=cfg,
            init=lambda key, device="cuda": tfm.init_lm(
                generator(key, device), cfg),
            loss=_no_loss,
            prefill=lambda p, b: tfm.prefill(p, cfg, tokens=b["tokens"]),
            init_cache=lambda bsz, s, device="cuda": tfm.init_cache(
                cfg, bsz, s, device),
            decode=lambda p, c, b, pos: tfm.decode_step(
                p, c, b["tokens"], pos, cfg),
        )
    if fam == "encoder":
        return ModelBundle(
            cfg=cfg,
            init=lambda key, device="cuda": encoder.init_encoder(
                generator(key, device), cfg),
            loss=_no_loss,
            prefill=lambda p, b: encoder.encode(p, b["frames"], cfg,
                                                allow_pallas=True),
            init_cache=None,
            decode=None,
        )
    raise ValueError(f"unknown family {fam!r}")
