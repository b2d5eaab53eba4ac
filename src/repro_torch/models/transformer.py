"""Decoder-only LM, dense family: init, forward, prefill and decode.

The counterpart of the reference's `models/transformer.py` for
`family == "dense"`.  Layer stacking follows the reference:
  * homogeneous archs: params stacked (L, ...);
  * gemma3-style local:global mixes: params stacked (G, group, ...) where
    each group holds `global_every - 1` local layers and 1 global layer,
    so local layers get window-sized KV caches and global layers full ones.
A Python loop over the layers takes the place of `lax.scan`.  Decode caches
are ring buffers for windowed layers (slot = pos mod capacity); a decode
step writes its slot in place and returns the same cache tensors.

`family == "moe"` waits for ROADMAP 1.14b; `lm_loss` for training
(ROADMAP 1.14d).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models.layers import (apply_rope, attention_block, cdtype,
                                       embed_tokens, flash_attention,
                                       init_attention, init_embeddings,
                                       init_mlp, layer_params, lm_logits,
                                       mlp_block, rmsnorm)

MOE_ITEM = "the MoE family waits for ROADMAP 1.14b (init_moe, moe_block)"


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family == "moe":
        raise NotImplementedError(MOE_ITEM)
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the "
                         "dense decoder")


def _grouped(cfg: ArchConfig) -> bool:
    return cfg.global_every > 1 and cfg.window > 0


def _lead(cfg: ArchConfig) -> tuple:
    if _grouped(cfg):
        return (cfg.n_layers // cfg.global_every, cfg.global_every)
    return (cfg.n_layers,)


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    _check_family(cfg)
    embed = init_embeddings(gen, cfg)
    lead = _lead(cfg)
    layers = {"attn": init_attention(gen, cfg, lead),
              "ffn": init_mlp(gen, cfg, lead=lead)}
    return {"embed": embed, "layers": layers}


def _layer(p, x, cfg: ArchConfig, is_global: bool, cache=None, pos=None,
           use_windowed_kernel: bool = False):
    a, new_cache = attention_block(p["attn"], x, cfg, is_global=is_global,
                                   cache=cache, pos=pos,
                                   use_windowed_kernel=use_windowed_kernel)
    x = x + a
    return x + mlp_block(p["ffn"], x, cfg), new_cache


def _layers_in_order(cfg: ArchConfig):
    """(index into the stacked params, is_global) for every layer."""
    if _grouped(cfg):
        per = cfg.global_every
        for gi in range(cfg.n_layers // per):
            for i in range(per):
                yield (gi, i), i == per - 1
    else:
        window_only = cfg.window > 0 and cfg.global_every == 0
        for li in range(cfg.n_layers):
            yield (li,), not window_only


def forward(params: dict, cfg: ArchConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            use_windowed_kernel: bool = False) -> torch.Tensor:
    """Full-sequence forward (prefill hidden states).  Returns (B, T, D)."""
    _check_family(cfg)
    use_windowed_kernel = use_windowed_kernel or cfg.windowed_kernel
    x = embeds if embeds is not None else embed_tokens(params["embed"],
                                                       tokens, cfg)
    x = x.to(cdtype(cfg))
    for idx, is_global in _layers_in_order(cfg):
        x, _ = _layer(layer_params(params["layers"], *idx), x, cfg,
                      is_global, use_windowed_kernel=use_windowed_kernel)
    return x


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _cache_sizes(cfg: ArchConfig, seq_len: int) -> tuple[int, int]:
    """(local_len, global_len) KV capacities for one layer."""
    local = min(cfg.window, seq_len) if cfg.window > 0 else seq_len
    return local, seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device="cuda") -> dict:
    dev = resolve_device(device)
    hd, kv = cfg.head_dim, cfg.n_kv
    dt = cdtype(cfg)
    local_len, global_len = _cache_sizes(cfg, seq_len)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    if _grouped(cfg):
        g, per = cfg.n_layers // cfg.global_every, cfg.global_every
        return {
            "local_k": zeros(g, per - 1, batch, local_len, kv, hd),
            "local_v": zeros(g, per - 1, batch, local_len, kv, hd),
            "global_k": zeros(g, batch, global_len, kv, hd),
            "global_v": zeros(g, batch, global_len, kv, hd),
        }
    length = local_len if (cfg.window > 0 and cfg.global_every == 0) \
        else global_len
    return {"k": zeros(cfg.n_layers, batch, length, kv, hd),
            "v": zeros(cfg.n_layers, batch, length, kv, hd)}


def _layer_cache(cfg: ArchConfig, cache: dict, idx: tuple):
    """The (k, v) cache views of one layer."""
    if _grouped(cfg):
        gi, i = idx
        if i == cfg.global_every - 1:
            return cache["global_k"][gi], cache["global_v"][gi]
        return cache["local_k"][gi, i], cache["local_v"][gi, i]
    return cache["k"][idx[0]], cache["v"][idx[0]]


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos,
                cfg: ArchConfig, embeds: Optional[torch.Tensor] = None):
    """One-token decode.  tokens: (B, 1); pos: int (uniform batch).
    Returns (logits (B, 1, V), cache), the cache written in place."""
    _check_family(cfg)
    x = embeds if embeds is not None else embed_tokens(params["embed"],
                                                       tokens, cfg)
    x = x.to(cdtype(cfg))
    for idx, is_global in _layers_in_order(cfg):
        lp = layer_params(params["layers"], *idx)
        kc, vc = _layer_cache(cfg, cache, idx)
        a, _ = _decode_attn(lp["attn"], x, kc, vc, cfg, is_global, pos)
        x = x + a
        x = x + mlp_block(lp["ffn"], x, cfg)
    return lm_logits(params["embed"], x, cfg), cache


def _decode_attn(p, x, k_cache, v_cache, cfg: ArchConfig, is_global: bool,
                 pos):
    """Single-token attention against a (ring-buffered if windowed) cache:
    the new key and value go to slot pos % capacity, and the step attends
    over the min(pos + 1, capacity) slots written so far."""
    b = x.shape[0]
    hd, kv = cfg.head_dim, cfg.n_kv
    pos = int(pos)
    h = rmsnorm(x, p["norm"])
    q = (h @ p["wq"].to(h.dtype)).reshape(b, 1, cfg.n_heads, hd)
    k = (h @ p["wk"].to(h.dtype)).reshape(b, 1, kv, hd)
    v = (h @ p["wv"].to(h.dtype)).reshape(b, 1, kv, hd)
    posn = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posn, cfg.rope_theta)
    k = apply_rope(k, posn, cfg.rope_theta)
    cap = k_cache.shape[1]
    slot = pos % cap
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = flash_attention(q, k_cache, v_cache, causal=False,
                        kv_len=min(pos + 1, cap), block=2048)
    o = o.reshape(b, 1, cfg.n_heads * hd)
    return o @ p["wo"].to(o.dtype), {"k": k_cache, "v": v_cache}


def prefill(params: dict, cfg: ArchConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill forward: returns the last position's logits (B, 1, V); the
    cache is written by the decode path, as in the reference."""
    x = forward(params, cfg, tokens=tokens, embeds=embeds)
    return lm_logits(params["embed"], x[:, -1:], cfg)
