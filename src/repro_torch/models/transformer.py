"""Decoder-only LM, dense and MoE (and the VLM backbone): init, forward,
prefill and decode.

The counterpart of the reference's `models/transformer.py`.  Layer
stacking follows the reference:
  * homogeneous archs: params stacked (L, ...);
  * gemma3-style local:global mixes: params stacked (G, group, ...) where
    each group holds `global_every - 1` local layers and 1 global layer,
    so local layers get window-sized KV caches and global layers full ones.
A Python loop over the layers takes the place of `lax.scan`.  Decode caches
are ring buffers for windowed layers (slot = pos mod capacity); a decode
step writes its slot in place and returns the same cache tensors.  A MoE
layer's feed-forward is `moe_block` (family "moe"), a dense one's
`mlp_block`.

`lm_loss` is the training objective.  `_remat` wraps a layer (or group)
body as the reference's `jax.checkpoint` does, by the config's `remat`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models.layers import (apply_rope, attention_block,
                                       attention_weights, cdtype,
                                       data_shards, embed_tokens,
                                       flash_attention,
                                       init_attention, init_embeddings,
                                       init_mlp, init_moe, last_position,
                                       layer_params, lm_logits, mlp_block,
                                       moe_block, rmsnorm, softmax_xent,
                                       vocab_shards)

# the plain matmuls: what `checkpoint_dots_with_no_batch_dims` saves (a
# batched product, attention's or the experts', is recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """`fn` recomputed in the backward pass: "none" keeps every
    activation, "dots" keeps the plain matmuls' outputs, any other value
    keeps only the inputs.  Without autograd (serving) `fn` runs as it
    is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         "decoder of this module")


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
    ffn = init_moe if cfg.family == "moe" else init_mlp
    layers = {"attn": init_attention(gen, cfg, lead),
              "ffn": ffn(gen, cfg, lead=lead)}
    return {"embed": embed, "layers": layers}


def _layer(p, x, cfg: ArchConfig, is_global: bool, cache=None, pos=None,
           use_windowed_kernel: bool = False, mesh=None):
    a, new_cache = attention_block(p["attn"], x, cfg, is_global=is_global,
                                   cache=cache, pos=pos,
                                   use_windowed_kernel=use_windowed_kernel,
                                   mesh=mesh)
    x = x + a
    return x + _ffn(p["ffn"], x, cfg, mesh), new_cache


def _ffn(p, x, cfg: ArchConfig, mesh=None, whole_seq: bool = False):
    return moe_block(p, x, cfg, mesh=mesh, whole_seq=whole_seq) \
        if cfg.family == "moe" else mlp_block(p, x, cfg, mesh)


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
            use_windowed_kernel: bool = False, mesh=None) -> torch.Tensor:
    """Full-sequence forward (training, prefill hidden states).  Returns
    (B, T, D).  `mesh` goes to every block: the embedding, attention,
    MLP and MoE blocks lay themselves out on its ranks (`layers`)."""
    _check_family(cfg)
    use_windowed_kernel = use_windowed_kernel or cfg.windowed_kernel
    x = embeds if embeds is not None else embed_tokens(params["embed"],
                                                       tokens, cfg, mesh)
    x = x.to(cdtype(cfg))
    if _grouped(cfg):
        per = cfg.global_every

        def group_fn(x, gp):
            for i in range(per):
                x, _ = _layer(layer_params(gp, i), x, cfg, i == per - 1,
                              use_windowed_kernel=use_windowed_kernel,
                              mesh=mesh)
            return x

        body = _remat(group_fn, cfg)
        for gi in range(cfg.n_layers // per):
            x = body(x, layer_params(params["layers"], gi))
        return x
    window_only = cfg.window > 0 and cfg.global_every == 0

    def layer_fn(x, lp):
        return _layer(lp, x, cfg, not window_only,
                      use_windowed_kernel=use_windowed_kernel,
                      mesh=mesh)[0]

    body = _remat(layer_fn, cfg)
    for li in range(cfg.n_layers):
        x = body(x, layer_params(params["layers"], li))
    return x


def lm_loss(params: dict, batch: dict, cfg: ArchConfig,
            use_windowed_kernel: bool = False, mesh=None) -> torch.Tensor:
    x = forward(params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"),
                use_windowed_kernel=use_windowed_kernel
                or cfg.windowed_kernel, mesh=mesh)
    logits = lm_logits(params["embed"], x, cfg, mesh)
    return softmax_xent(logits, batch["targets"], batch["mask"],
                        data_shards(mesh, cfg),
                        vocab_shards(logits, cfg, mesh))


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
                cfg: ArchConfig, embeds: Optional[torch.Tensor] = None,
                mesh=None):
    """One-token decode.  tokens: (B, 1); pos: int (uniform batch).
    Returns (logits (B, 1, V), cache), the cache written in place; on
    ranks the full vocab's logits of this rank's rows."""
    _check_family(cfg)
    x = embeds if embeds is not None else embed_tokens(params["embed"],
                                                       tokens, cfg, mesh)
    x = x.to(cdtype(cfg))
    for idx, is_global in _layers_in_order(cfg):
        lp = layer_params(params["layers"], *idx)
        kc, vc = _layer_cache(cfg, cache, idx)
        a, _ = _decode_attn(lp["attn"], x, kc, vc, cfg, is_global, pos,
                            mesh)
        x = x + a
        x = x + _ffn(lp["ffn"], x, cfg, mesh, whole_seq=True)
    return lm_logits(params["embed"], x, cfg, mesh, whole=True), cache


def _decode_attn(p, x, k_cache, v_cache, cfg: ArchConfig, is_global: bool,
                 pos, mesh=None, path: str = "attn"):
    """Single-token attention against a (ring-buffered if windowed) cache:
    the new key and value go to slot pos % capacity, and the step attends
    over the min(pos + 1, capacity) slots written so far.  On ranks whose
    heads split over `model` (`layers.attention_weights`) every rank
    writes every kv head (the cache holds them whole, as `cache_specs`
    lays it out), attends with its own heads (every head, its q gathered
    over `model`, where its columns cut a head), and the output adds
    over `model`."""
    b = x.shape[0]
    hd, kv = cfg.head_dim, cfg.n_kv
    pos = int(pos)
    att = attention_weights(p, cfg, mesh, path, whole_kv=True)
    h = rmsnorm(x, p["norm"])
    q = att.q(h)
    nq = q.shape[-1] // hd
    q = q.reshape(b, 1, nq, hd)
    k = (h @ att.wk.to(h.dtype)).reshape(b, 1, kv, hd)
    v = (h @ att.wv.to(h.dtype)).reshape(b, 1, kv, hd)
    posn = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posn, cfg.rope_theta)
    k = apply_rope(k, posn, cfg.rope_theta)
    cap = k_cache.shape[1]
    slot = pos % cap
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = flash_attention(q, k_cache[:, :, att.kv], v_cache[:, :, att.kv],
                        causal=False, kv_len=min(pos + 1, cap), block=2048)
    return att.out(o.reshape(b, 1, nq * hd)), {"k": k_cache, "v": v_cache}


def prefill(params: dict, cfg: ArchConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Prefill forward: returns the last position's logits (B, 1, V); the
    cache is written by the decode path, as in the reference.  Under the
    `sp` scheme `tokens` / `embeds` are the rank's positions, and every
    rank returns the last rank's last position's logits."""
    x = forward(params, cfg, tokens=tokens, embeds=embeds, mesh=mesh)
    return lm_logits(params["embed"], last_position(x, cfg, mesh), cfg,
                     mesh, whole=True)
