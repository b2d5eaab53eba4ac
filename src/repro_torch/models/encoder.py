"""HuBERT-style bidirectional encoder, serving half.

The counterpart of the reference's `models/encoder.py`.  The conv waveform
frontend is a stub, as there: the input is precomputed frame embeddings
(B, T, D), and a learned linear adapter stands in for the feature
projection.  `encoder_loss` is the masked-unit objective: cross-entropy
over `num_classes` codebook units at the masked frames.  `mesh` reaches
the blocks and the loss as in the decoder; `adapter` and `head` are
gathered over `data` where fsdp splits them (the head's classes stay
whole on every `model` rank, as the rules lay it out).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (attention_block, cdtype,
                                       data_shards, data_whole,
                                       init_attention,
                                       init_dense, init_mlp, layer_params,
                                       mlp_block, pdtype, rmsnorm,
                                       softmax_xent)
from repro_torch.models.transformer import _remat


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
           allow_pallas: bool = False, mesh=None) -> torch.Tensor:
    """frames: (B, T, D) stub frontend output -> (B, T, D).  Bidirectional
    attention; with `allow_pallas` and `cfg.pallas_flash` every layer's
    attention is the flash kernel."""
    cd = cdtype(cfg)
    d = cfg.d_model
    x = frames.to(cd) @ data_whole(params["adapter"], "['adapter']", (d, d),
                                   cfg, mesh).to(cd)
    if mask_positions is not None:
        x = torch.where(mask_positions[..., None],
                        params["mask_embed"].to(x.dtype), x)

    def layer_fn(x, lp):
        a, _ = attention_block(lp["attn"], x, cfg, is_global=True,
                               allow_pallas=allow_pallas, mesh=mesh)
        x = x + a
        return x + mlp_block(lp["ffn"], x, cfg, mesh)

    body = _remat(layer_fn, cfg)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(params["layers"], i))
    return rmsnorm(x, params["final_norm"])


def encoder_loss(params: dict, batch: dict, cfg: ArchConfig, mesh=None
                 ) -> torch.Tensor:
    """Masked-prediction cross-entropy at the masked frames (HuBERT's
    objective); the attention is the plain version (no kernel).  Over
    data ranks the count is the global one (`softmax_xent`)."""
    x = encode(params, batch["frames"], cfg,
               mask_positions=batch["mask_positions"], mesh=mesh)
    head = data_whole(params["head"], "['head']",
                      (cfg.d_model, cfg.num_classes), cfg, mesh)
    logits = x @ head.to(x.dtype)
    m = batch["mask_positions"].to(torch.float32)
    return softmax_xent(logits, batch["targets"], m, data_shards(mesh, cfg))
