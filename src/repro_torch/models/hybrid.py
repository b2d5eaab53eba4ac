"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block.

The counterpart of the reference's `models/hybrid.py`.  The n_layers
Mamba2 layers run in groups of `attn_every`; after each group the shared
attention + MLP block (one parameter set, reused) runs.  Tail layers
(n_layers % attn_every) run after the groups.  Params keep the
reference's layout: `mamba_groups` (G, attn_every, ...), `mamba_tail`
(tail, ...), `shared_attn` and `shared_mlp` unstacked.  Each
shared-attention call site has its OWN KV cache (weights shared, state
not), a ring buffer of min(shared_attn_window, seq_len) slots.  A decode
step writes every state and cache slot in place.  `hybrid_loss` is the
training objective (over the data ranks with the global count); a group
(not the tail) is the unit of remat, as in the reference.  On ranks the
Mamba2 blocks (`models.ssm.mamba_block`) and the shared attention and
MLP lay themselves out over `model`; a Mamba2 layer's ssm state holds
the rank's heads where they split whole over `model`, its conv state and
the shared attention's kv rings every channel and head
(`layers.rank_cache`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models.layers import (attention_block, cdtype, data_shards,
                                       embed_tokens, init_attention,
                                       init_embeddings, init_mlp,
                                       last_position, layer_params,
                                       lm_logits, mlp_block, softmax_xent,
                                       vocab_shards)
from repro_torch.models.ssm import init_mamba, mamba_block, mamba_init_state
from repro_torch.models.transformer import _decode_attn, _remat


def _group_counts(cfg: ArchConfig) -> tuple[int, int]:
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


def init_hybrid(gen: torch.Generator, cfg: ArchConfig) -> dict:
    g, tail = _group_counts(cfg)
    p = {"embed": init_embeddings(gen, cfg),
         "mamba_groups": init_mamba(gen, cfg, (g, cfg.attn_every)),
         "shared_attn": init_attention(gen, cfg),
         "shared_mlp": init_mlp(gen, cfg)}
    if tail:
        p["mamba_tail"] = init_mamba(gen, cfg, (tail,))
    return p


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """Full-sequence forward.  Returns (B, T, D)."""
    x = embed_tokens(params["embed"], tokens, cfg, mesh).to(cdtype(cfg))
    g, tail = _group_counts(cfg)

    def group_fn(x, gp):
        for i in range(cfg.attn_every):
            m, _ = mamba_block(layer_params(gp, i), x, cfg, mesh=mesh)
            x = x + m
        a, _ = attention_block(params["shared_attn"], x, cfg,
                               is_global=True, mesh=mesh,
                               path="shared_attn")
        x = x + a
        return x + mlp_block(params["shared_mlp"], x, cfg, mesh,
                             "shared_mlp")

    body = _remat(group_fn, cfg)
    for gi in range(g):
        x = body(x, layer_params(params["mamba_groups"], gi))
    for li in range(tail):
        m, _ = mamba_block(layer_params(params["mamba_tail"], li), x, cfg,
                           mesh=mesh)
        x = x + m
    return x


def hybrid_loss(params: dict, batch: dict, cfg: ArchConfig, mesh=None
                ) -> torch.Tensor:
    x = forward(params, cfg, batch["tokens"], mesh)
    logits = lm_logits(params["embed"], x, cfg, mesh)
    return softmax_xent(logits, batch["targets"], batch["mask"],
                        data_shards(mesh, cfg),
                        vocab_shards(logits, cfg, mesh))


def init_hybrid_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      device="cuda") -> dict:
    """Zero Mamba2 states (G, attn_every, ...) and (tail, ...), and one
    (B, min(shared_attn_window, seq_len), KV, hd) ring buffer of keys and
    of values for each group's shared-attention call.  Every slot is its
    own tensor memory: the decode steps write them in place."""
    dev = resolve_device(device)
    g, tail = _group_counts(cfg)
    ring = min(cfg.shared_attn_window, seq_len)

    def kv():
        return torch.zeros((g, batch, ring, cfg.n_kv, cfg.head_dim),
                           dtype=cdtype(cfg), device=dev)

    cache = {"mamba": mamba_init_state(cfg, batch, (g, cfg.attn_every), dev),
             "attn_k": kv(), "attn_v": kv()}
    if tail:
        cache["mamba_tail"] = mamba_init_state(cfg, batch, (tail,), dev)
    return cache


def _mamba_step(p: dict, x: torch.Tensor, cfg: ArchConfig, st: dict,
                mesh=None):
    """One Mamba2 decode step whose new state is written into `st`."""
    m, ns = mamba_block(p, x, cfg, state=st, mesh=mesh)
    for key in ("conv", "ssm"):
        st[key].copy_(ns[key])
    return x + m


def hybrid_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                       pos, cfg: ArchConfig, mesh=None):
    """One-token decode.  tokens: (B, 1); pos: int.  Returns (logits (B,
    1, V), cache), the cache written in place."""
    x = embed_tokens(params["embed"], tokens, cfg, mesh).to(cdtype(cfg))
    g, tail = _group_counts(cfg)
    for gi in range(g):
        for i in range(cfg.attn_every):
            x = _mamba_step(layer_params(params["mamba_groups"], gi, i), x,
                            cfg, layer_params(cache["mamba"], gi, i), mesh)
        a, _ = _decode_attn(params["shared_attn"], x, cache["attn_k"][gi],
                            cache["attn_v"][gi], cfg, True, pos, mesh,
                            "shared_attn")
        x = x + a
        x = x + mlp_block(params["shared_mlp"], x, cfg, mesh, "shared_mlp")
    for li in range(tail):
        x = _mamba_step(layer_params(params["mamba_tail"], li), x, cfg,
                        layer_params(cache["mamba_tail"], li), mesh)
    return lm_logits(params["embed"], x, cfg, mesh, whole=True), cache


def hybrid_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    x = forward(params, cfg, tokens, mesh)
    return lm_logits(params["embed"], last_position(x, cfg, mesh), cfg,
                     mesh, whole=True)
