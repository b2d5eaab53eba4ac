"""LLaVA-NeXT-style VLM: a stub anyres patch frontend and the Mistral
decoder backbone.

The counterpart of the reference's `models/vlm.py`.  The vision tower is
a stub: the caller passes precomputed patch embeddings (B, P, d_model),
already projected, which replace the first P token positions (prefix
layout); `tokens` spans them, so T >= P.  The backbone is the dense
decoder of `models/transformer.py`; decode is its text-only
`decode_step`.  `vlm_loss` leaves the patch prefix out of the LM loss.
`mesh` reaches the backbone's blocks and the loss as in the decoder.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (data_shards, embed_tokens, lm_logits,
                                       softmax_xent, vocab_shards)


def init_vlm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return tfm.init_lm(gen, cfg)


def splice_embeds(params: dict, tokens: torch.Tensor,
                  patch_embeds: torch.Tensor, cfg: ArchConfig, mesh=None
                  ) -> torch.Tensor:
    """Prefix splice: positions [0, P) take the patch embeddings."""
    x = embed_tokens(params["embed"], tokens, cfg, mesh)
    p = patch_embeds.shape[1]
    return torch.cat([patch_embeds.to(x.dtype), x[:, p:]], dim=1)


def vlm_loss(params: dict, batch: dict, cfg: ArchConfig, mesh=None
             ) -> torch.Tensor:
    embeds = splice_embeds(params, batch["tokens"], batch["patch_embeds"],
                           cfg, mesh)
    x = tfm.forward(params, cfg, embeds=embeds, mesh=mesh)
    logits = lm_logits(params["embed"], x, cfg, mesh)
    # the image-prefix positions are masked out of the LM loss, on a copy:
    # the caller's mask stays as it is
    p = batch["patch_embeds"].shape[1]
    mask = batch["mask"].clone()
    mask[:, :p] = 0.0
    return softmax_xent(logits, batch["targets"], mask, data_shards(mesh),
                        vocab_shards(logits, cfg, mesh))


def vlm_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                patch_embeds: torch.Tensor, mesh=None) -> torch.Tensor:
    embeds = splice_embeds(params, tokens, patch_embeds, cfg, mesh)
    return tfm.prefill(params, cfg, embeds=embeds, mesh=mesh)
