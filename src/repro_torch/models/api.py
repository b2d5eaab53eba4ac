"""Unified model API: one bundle per architecture family.

  bundle = build_model(cfg)
  params = bundle.init(seed_or_generator, device)
  loss   = bundle.loss(params, batch)                 # training objective
  logits = bundle.prefill(params, batch)              # inference prefill
  cache  = bundle.init_cache(batch, seq_len, device)  # decode state
  logits, cache = bundle.decode(params, cache, batch, pos)

The counterpart of the reference's `models/api.py`, every family: dense
and MoE decoders, the VLM backbone, the encoder, RWKV (ssm) and the
Zamba2 hybrid.  `batch` layouts per family are those of
`repro_torch.launch.specs.input_specs`: "tokens" ("patch_embeds" too for
the VLM, "frames" for the encoder), and for the loss "targets" and
"mask" ("mask_positions" for the encoder).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import encoder, hybrid, rwkv, transformer as tfm, vlm

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


def _bundle(cfg: ArchConfig, init, loss, prefill, init_cache=None,
            decode=None) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init=lambda key, device="cuda": init(generator(key, device), cfg),
        loss=lambda p, b: loss(p, b, cfg), prefill=prefill,
        init_cache=None if init_cache is None else
        lambda bsz, s, device="cuda": init_cache(cfg, bsz, s, device),
        decode=None if decode is None else
        lambda p, c, b, pos: decode(p, c, b["tokens"], pos, cfg))


def build_model(cfg: ArchConfig) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe"):
        return _bundle(
            cfg, tfm.init_lm, tfm.lm_loss,
            lambda p, b: tfm.prefill(p, cfg, tokens=b["tokens"]),
            tfm.init_cache, tfm.decode_step)
    if fam == "vlm":
        return _bundle(
            cfg, vlm.init_vlm, vlm.vlm_loss,
            lambda p, b: vlm.vlm_prefill(p, cfg, b["tokens"],
                                         b["patch_embeds"]),
            tfm.init_cache, tfm.decode_step)
    if fam == "encoder":
        return _bundle(
            cfg, encoder.init_encoder, encoder.encoder_loss,
            lambda p, b: encoder.encode(p, b["frames"], cfg,
                                        allow_pallas=True))
    if fam == "ssm":
        return _bundle(
            cfg, rwkv.init_rwkv_lm, rwkv.rwkv_loss,
            lambda p, b: rwkv.rwkv_prefill(p, cfg, b["tokens"]),
            rwkv.init_rwkv_cache, rwkv.rwkv_decode_step)
    if fam == "hybrid":
        return _bundle(
            cfg, hybrid.init_hybrid, hybrid.hybrid_loss,
            lambda p, b: hybrid.hybrid_prefill(p, cfg, b["tokens"]),
            hybrid.init_hybrid_cache, hybrid.hybrid_decode_step)
    raise ValueError(f"unknown family {fam!r}")
