"""HuBERT-style bidirectional encoder, serving half.

The counterpart of the reference's `models/encoder.py`.  The conv waveform
frontend is a stub, as there: the input is precomputed frame embeddings
(B, T, D), and a learned linear adapter stands in for the feature
projection.  `encoder_loss` (the masked-unit objective) waits for training
(ROADMAP 1.14d); the reference's `_remat` is training-only and has no
counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (attention_block, cdtype,
                                       init_attention, init_dense, init_mlp,
                                       layer_params, mlp_block, pdtype,
                                       rmsnorm)


def init_encoder(gen: torch.Generator, cfg: ArchConfig) -> dict:
    lead = (cfg.n_layers,)
    dev = gen.device
    layers = {"attn": init_attention(gen, cfg, lead),
              "ffn": init_mlp(gen, cfg, lead=lead)}
    return {
        "adapter": init_dense(gen, cfg.d_model, cfg.d_model, pdtype(cfg)),
        "mask_embed": torch.empty((cfg.d_model,), dtype=torch.float32,
                                  device=dev).normal_(0.0, 0.02,
                                                      generator=gen),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=dev),
        "head": init_dense(gen, cfg.d_model, cfg.num_classes, pdtype(cfg)),
    }


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig,
           mask_positions: torch.Tensor | None = None,
           allow_pallas: bool = False) -> torch.Tensor:
    """frames: (B, T, D) stub frontend output -> (B, T, D).  Bidirectional
    attention; with `allow_pallas` and `cfg.pallas_flash` every layer's
    attention is the flash kernel."""
    cd = cdtype(cfg)
    x = frames.to(cd) @ params["adapter"].to(cd)
    if mask_positions is not None:
        x = torch.where(mask_positions[..., None],
                        params["mask_embed"].to(x.dtype), x)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        a, _ = attention_block(lp["attn"], x, cfg, is_global=True,
                               allow_pallas=allow_pallas)
        x = x + a
        x = x + mlp_block(lp["ffn"], x, cfg)
    return rmsnorm(x, params["final_norm"])
