"""RWKV6 ("Finch") language model: attention-free, data-dependent decay.

The counterpart of the reference's `models/rwkv.py`.  The layers are
stacked (L, ...) and run in a Python loop.  The decode cache holds one
O(1) state a layer (independent of the sequence length); a decode step
writes it in place and returns the same tensors.  `rwkv_loss` is the
training objective; on ranks its count is the global one over the data
ranks, and the blocks lay their heads and hidden columns out over
`model` (`models.ssm.rwkv_tmix`, `rwkv_cmix`).  On ranks a layer's wkv
state holds the rank's heads where they split whole over `model`
(`layers.rank_cache`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (cdtype, data_shards, embed_tokens,
                                       init_embeddings, last_position,
                                       layer_params, lm_logits, softmax_xent,
                                       vocab_shards)
from repro_torch.models.ssm import (init_rwkv_cmix, init_rwkv_tmix,
                                    rwkv_cmix, rwkv_init_state, rwkv_tmix)
from repro_torch.models.transformer import _remat


def init_rwkv_lm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    lead = (cfg.n_layers,)
    return {"embed": init_embeddings(gen, cfg),
            "layers": {"tmix": init_rwkv_tmix(gen, cfg, lead),
                       "cmix": init_rwkv_cmix(gen, cfg, lead)}}


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """Full-sequence forward.  Returns (B, T, D)."""
    x = embed_tokens(params["embed"], tokens, cfg, mesh).to(cdtype(cfg))

    def layer_fn(x, lp):
        t, _ = rwkv_tmix(lp["tmix"], x, cfg, mesh=mesh)
        x = x + t
        c, _ = rwkv_cmix(lp["cmix"], x, cfg, mesh=mesh)
        return x + c

    body = _remat(layer_fn, cfg)
    for li in range(cfg.n_layers):
        x = body(x, layer_params(params["layers"], li))
    return x


def rwkv_loss(params: dict, batch: dict, cfg: ArchConfig, mesh=None
              ) -> torch.Tensor:
    x = forward(params, cfg, batch["tokens"], mesh)
    logits = lm_logits(params["embed"], x, cfg, mesh)
    return softmax_xent(logits, batch["targets"], batch["mask"],
                        data_shards(mesh, cfg),
                        vocab_shards(logits, cfg, mesh))


def init_rwkv_cache(cfg: ArchConfig, batch: int, seq_len: int,
                    device="cuda") -> dict:
    """One zero state a layer, stacked (L, ...), whatever `seq_len`."""
    return rwkv_init_state(cfg, batch, (cfg.n_layers,), device)


def _write(cache: dict, state: dict) -> None:
    for key, value in state.items():
        if isinstance(value, dict):
            _write(cache[key], value)
        else:
            cache[key].copy_(value)


def rwkv_decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos,
                     cfg: ArchConfig, mesh=None):
    """One-token decode.  tokens: (B, 1).  Returns (logits (B, 1, V),
    cache), each layer's state written in place."""
    x = embed_tokens(params["embed"], tokens, cfg, mesh).to(cdtype(cfg))
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        st = layer_params(cache, li)
        t, ts = rwkv_tmix(lp["tmix"], x, cfg, state=st["tmix"], mesh=mesh)
        x = x + t
        c, cs = rwkv_cmix(lp["cmix"], x, cfg, state=st["cmix"], mesh=mesh)
        x = x + c
        _write(st, {"tmix": ts, "cmix": cs})
    return lm_logits(params["embed"], x, cfg, mesh, whole=True), cache


def rwkv_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    x = forward(params, cfg, tokens, mesh)
    return lm_logits(params["embed"], last_position(x, cfg, mesh), cfg,
                     mesh, whole=True)
