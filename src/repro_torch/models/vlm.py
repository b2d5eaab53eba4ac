"""LLaVA-NeXT-style VLM: a stub anyres patch frontend and the Mistral
decoder backbone.

The counterpart of the reference's `models/vlm.py`.  The vision tower is
a stub: the caller passes precomputed patch embeddings (B, P, d_model),
already projected, which replace the first P token positions (prefix
layout); `tokens` spans them, so T >= P.  The backbone is the dense
decoder of `models/transformer.py`; decode is its text-only
`decode_step`.  `vlm_loss` leaves the patch prefix out of the LM loss.
`mesh` reaches the backbone's blocks and the loss as in the decoder;
under the `sp` scheme the prefix is placed by global position.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (data_shards, embed_tokens, lm_logits,
                                       seq_shards, softmax_xent,
                                       vocab_shards)


def init_vlm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return tfm.init_lm(gen, cfg)


def _prefix(patch_embeds: torch.Tensor, t: int, cfg: ArchConfig,
            mesh=None) -> tuple[int, int]:
    """(how many of this rank's t positions the patch prefix [0, P) takes,
    the rank's first global position).  Under the `sp` scheme a rank
    holds its positions and its block of the patch embeddings
    (`train.ranks.RankLayout.batch` splits both over `model`), so P is
    the blocks' together."""
    seq = seq_shards(cfg, mesh)
    if seq is None:
        return patch_embeds.shape[1], 0
    start = seq.rank * t
    p = patch_embeds.shape[1] * seq.num_shards
    return max(0, min(t, p - start)), start


def splice_embeds(params: dict, tokens: torch.Tensor,
                  patch_embeds: torch.Tensor, cfg: ArchConfig, mesh=None
                  ) -> torch.Tensor:
    """Prefix splice: positions [0, P) take the patch embeddings (under
    the `sp` scheme by global position, from every rank's block)."""
    x = embed_tokens(params["embed"], tokens, cfg, mesh)
    n, start = _prefix(patch_embeds, x.shape[1], cfg, mesh)
    seq = seq_shards(cfg, mesh)
    if seq is not None:
        patch_embeds = seq.gather(patch_embeds, 1)[:, start:start + n]
    return torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)


def vlm_loss(params: dict, batch: dict, cfg: ArchConfig, mesh=None
             ) -> torch.Tensor:
    embeds = splice_embeds(params, batch["tokens"], batch["patch_embeds"],
                           cfg, mesh)
    x = tfm.forward(params, cfg, embeds=embeds, mesh=mesh)
    logits = lm_logits(params["embed"], x, cfg, mesh)
    # the image-prefix positions are masked out of the LM loss, on a copy:
    # the caller's mask stays as it is
    n, _ = _prefix(batch["patch_embeds"], x.shape[1], cfg, mesh)
    mask = batch["mask"].clone()
    mask[:, :n] = 0.0
    return softmax_xent(logits, batch["targets"], mask,
                        data_shards(mesh, cfg),
                        vocab_shards(logits, cfg, mesh))


def vlm_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                patch_embeds: torch.Tensor, mesh=None) -> torch.Tensor:
    embeds = splice_embeds(params, tokens, patch_embeds, cfg, mesh)
    return tfm.prefill(params, cfg, embeds=embeds, mesh=mesh)
