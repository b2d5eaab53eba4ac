"""LLaVA-NeXT-style VLM: a stub anyres patch frontend and the Mistral
decoder backbone.

The counterpart of the reference's `models/vlm.py`.  The vision tower is
a stub: the caller passes precomputed patch embeddings (B, P, d_model),
already projected, which replace the first P token positions (prefix
layout); `tokens` spans them, so T >= P.  The backbone is the dense
decoder of `models/transformer.py`; decode is its text-only
`decode_step`.  `vlm_loss` waits for training (ROADMAP 1.14d).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_tokens


def init_vlm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return tfm.init_lm(gen, cfg)


def splice_embeds(params: dict, tokens: torch.Tensor,
                  patch_embeds: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    """Prefix splice: positions [0, P) take the patch embeddings."""
    x = embed_tokens(params["embed"], tokens, cfg)
    p = patch_embeds.shape[1]
    return torch.cat([patch_embeds.to(x.dtype), x[:, p:]], dim=1)


def vlm_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                patch_embeds: torch.Tensor) -> torch.Tensor:
    embeds = splice_embeds(params, tokens, patch_embeds, cfg)
    return tfm.prefill(params, cfg, embeds=embeds)
