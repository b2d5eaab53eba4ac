"""Transformer building blocks: plain functions on dicts of tensors.

The counterpart of the reference's `models/layers.py`, dense half.
Conventions:
  * params are nested dicts of tensors; layer-stacked params keep the
    reference's leading (L, ...) axis (or (G, group, ...)), and the models
    loop over it in Python where the reference scans.
  * activations: (B, T, D) in the config's compute dtype (bf16 by default);
    norms and softmax run in f32.  Weights are cast to the compute dtype at
    each product, as the reference does (`h @ w.astype(h.dtype)`).
  * initialisation draws from an explicit `torch.Generator`, on its device.
    It cannot give `jax.random`'s numbers: the parity tests carry the
    reference's weights across with `repro_torch.interop.lm_params`.

  * `shard(x, *axes)` is the reference's sharding constraint; the port's
    models run on one card with no mesh, where the reference's constraint
    is a no-op too, so it returns x.  `act_spec` keeps the reference's
    activation templates.

Left out: `init_moe`, `moe_block` and `_ep_local_combine` wait for the
MoE slice (ROADMAP 1.14b); `softmax_xent` waits for training (ROADMAP
1.14d).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


BATCH_AXES = ("pod", "data")


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's `with_sharding_constraint` wrapper, which no-ops
    without an active mesh: the port's models have none, so x comes back
    as it is."""
    return x


def act_spec(cfg: ArchConfig, kind: str):
    """Activation sharding templates per scheme (DESIGN.md §6), the
    reference's axis-name tuples.

    tp: Megatron-style, heads / ffn hidden / vocab over `model`.
    sp: sequence-parallel, seq over `model`, weights FSDP over `data`;
        K/V gathered for attention.
    """
    if cfg.sharding_scheme == "sp":
        return {
            "resid": (BATCH_AXES, "model", None),
            "heads": (BATCH_AXES, "model", None, None),
            "kv": (BATCH_AXES, None, None, None),
            "ffn": (BATCH_AXES, "model", None),
            "logits": (BATCH_AXES, "model", None),
        }[kind]
    return {
        "resid": (BATCH_AXES, None, None),
        "heads": (BATCH_AXES, None, "model", None),
        "kv": (BATCH_AXES, None, "model", None),
        "ffn": (BATCH_AXES, None, "model"),
        "logits": (BATCH_AXES, None, "model"),
    }[kind]


def shard_act(x: torch.Tensor, cfg: ArchConfig, kind: str) -> torch.Tensor:
    return shard(x, *act_spec(cfg, kind))


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def layer_params(tree, *index):
    """One layer's params out of a layer-stacked dict (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, *index) for k, v in tree.items()}
    return tree[index]


# ---------------------------------------------------------------------------
# Norms / embeddings / rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(ms + eps)) * w.to(torch.float32)).to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0, lead: tuple = ()) -> torch.Tensor:
    """N(0, scale^2 / d_in) weights of shape lead + (d_in, d_out)."""
    std = scale / np.sqrt(d_in)
    w = torch.empty(lead + (d_in, d_out), dtype=torch.float32,
                    device=gen.device).normal_(0.0, std, generator=gen)
    return w.to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, H, hd), positions: (..., T).  Split halves, not
    interleaved."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., T, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, full or sliding-window, flash-style blocked)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
                   ) -> dict:
    hd, dt = cfg.head_dim, pdtype(cfg)
    return {
        "wq": init_dense(gen, cfg.d_model, cfg.n_heads * hd, dt, lead=lead),
        "wk": init_dense(gen, cfg.d_model, cfg.n_kv * hd, dt, lead=lead),
        "wv": init_dense(gen, cfg.d_model, cfg.n_kv * hd, dt, lead=lead),
        "wo": init_dense(gen, cfg.n_heads * hd, cfg.d_model, dt, lead=lead),
        "norm": torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                           device=gen.device),
    }


def _pad_seq(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, T, H, hd) tensor."""
    return F.pad(x, (0, 0, 0, 0, before, after))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_offset=0,
                    kv_len=None, block: int = 512) -> torch.Tensor:
    """Blocked (flash-style) attention in plain tensor code.

    q: (B, Tq, H, hd); k, v: (B, Tk, KV, hd).  GQA via head grouping.
    window > 0 limits attention to the last `window` key positions
    (sliding-window causal).  kv_len masks a padded cache (decode).
    As the reference: q is scaled in f32, masked scores are -inf with the
    fully-masked-row guards, and p is cast to v's dtype for P.V (products
    summed in f32).  Memory: O(Tq x block)."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qh = (q.to(torch.float32) * scale).reshape(b, tq, kvh, g, hd)
    block = min(block, tk)
    nblk = -(-tk // block)
    pad = nblk * block - tk
    if pad:
        k, v = _pad_seq(k, 0, pad), _pad_seq(v, 0, pad)
    dev = q.device
    qpos = torch.arange(tq, device=dev) + q_offset              # (Tq,)
    limit = tk if kv_len is None else kv_len
    inf = float("inf")

    m = torch.full((b, kvh, g, tq), -inf, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, tq, kvh, g, hd), dtype=torch.float32, device=dev)
    for i in range(nblk):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        kpos = i * block + torch.arange(block, device=dev)[None, :]
        s = torch.einsum("btkgh,bskh->bkgts", qh, kblk.to(torch.float32))
        mask = torch.ones((tq, block), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos <= qpos[:, None])
        if window > 0:
            mask = mask & ((qpos[:, None] - kpos) < window)
        mask = mask & (kpos < limit)
        s = torch.where(mask[None, None, None], s, -inf)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
        dead = torch.isinf(m_new)
        m_safe = torch.where(dead, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(dead[..., None], 0.0, p)
        m_inf = torch.isinf(m)
        corr = torch.exp(torch.where(m_inf, 0.0, m) - m_safe)
        corr = torch.where(m_inf, 0.0, corr)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgts,bskh->btkgh",
                          p.to(vblk.dtype).to(torch.float32),
                          vblk.to(torch.float32))
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    lt = l.permute(0, 3, 1, 2)[..., None]
    out = acc / torch.clamp(lt, min=1e-20)
    return out.reshape(b, tq, h, hd).to(q.dtype)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: int, block: int = 512) -> torch.Tensor:
    """Local (sliding-window causal) attention computing only the blocks a
    query block can see: O(T x window) flops instead of O(T^2)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    block = min(block, t)
    w_blocks = -(-window // block) + 1
    nblk = -(-t // block)
    padq = nblk * block - t
    if padq:
        q, k, v = (_pad_seq(x, 0, padq) for x in (q, k, v))
    tp = nblk * block
    scale = 1.0 / np.sqrt(hd)
    qb = (q.to(torch.float32) * scale).reshape(b, nblk, block, kvh, g, hd)
    # for query block i, the key blocks [i - w_blocks + 1 .. i]
    kpad = _pad_seq(k, (w_blocks - 1) * block, 0)
    vpad = _pad_seq(v, (w_blocks - 1) * block, 0)
    dev = q.device
    inf = float("inf")
    out = torch.empty((b, tp, kvh, g, hd), dtype=torch.float32, device=dev)
    for i in range(nblk):
        ks = kpad[:, i * block:i * block + w_blocks * block]
        vs = vpad[:, i * block:i * block + w_blocks * block]
        s = torch.einsum("btkgh,bskh->bkgts", qb[:, i], ks.to(torch.float32))
        qpos = i * block + torch.arange(block, device=dev)
        kpos = (i - w_blocks + 1) * block + torch.arange(w_blocks * block,
                                                         device=dev)
        mask = (kpos[None, :] <= qpos[:, None]) \
            & (qpos[:, None] - kpos[None, :] < window) & (kpos[None, :] >= 0)
        s = torch.where(mask[None, None, None], s, -inf)
        mx = s.amax(-1, keepdim=True)
        dead = torch.isinf(mx)
        p = torch.exp(s - torch.where(dead, 0.0, mx))
        p = torch.where(dead, 0.0, p)
        o = torch.einsum("bkgts,bskh->btkgh", p.to(vs.dtype).to(torch.float32),
                         vs.to(torch.float32))
        out[:, i * block:(i + 1) * block] = o / torch.clamp(
            p.sum(-1), min=1e-20).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, tp, h, hd)[:, :t].to(q.dtype)


def attention_block(params: dict, x: torch.Tensor, cfg: ArchConfig,
                    is_global: bool = True, positions=None,
                    cache: Optional[dict] = None, pos=None,
                    use_windowed_kernel: bool = False,
                    allow_pallas: bool = False):
    """Pre-norm attention.  If `cache` is given, runs as one decode step
    (x: (B, 1, D)) writing the cache at `pos` and attending over it.
    Returns (out, cache).  The flash kernel runs when the config sets
    `pallas_flash`, the layer is global and the caller allows it (the
    encoder prefill), as in the reference.  The port writes a decode step's
    keys and values into the cache tensors in place (the reference returns
    updated copies); the returned cache holds the same tensors."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, params["norm"])
    q = (h @ params["wq"].to(h.dtype)).reshape(b, t, cfg.n_heads, hd)
    k = (h @ params["wk"].to(h.dtype)).reshape(b, t, cfg.n_kv, hd)
    v = (h @ params["wv"].to(h.dtype)).reshape(b, t, cfg.n_kv, hd)
    window = 0 if is_global else cfg.window
    if cache is None:
        if positions is None:
            positions = torch.arange(t, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if cfg.pallas_flash and window == 0 and allow_pallas:
            from repro_torch.kernels.ops import flash_attention_fused
            o = flash_attention_fused(q, k, v, causal=cfg.causal)
        elif not cfg.causal:
            o = flash_attention(q, k, v, causal=False, window=0)
        elif window and use_windowed_kernel:
            o = windowed_attention(q, k, v, window)
        else:
            o = flash_attention(q, k, v, causal=True, window=window)
        new_cache = None
    else:
        # single-token decode: write the cache, attend over it
        p = int(pos)
        posn = torch.full((1, 1), p, device=x.device)
        q = apply_rope(q, posn, cfg.rope_theta)
        k = apply_rope(k, posn, cfg.rope_theta)
        ck, cv = cache["k"], cache["v"]
        if ck.shape[1] != 0:
            at = min(p, ck.shape[1] - t)       # dynamic_update_slice clamps
            ck[:, at:at + t] = k
            cv[:, at:at + t] = v
        o = flash_attention(q, ck, cv, causal=False, kv_len=p + 1,
                            block=2048)
        new_cache = {"k": ck, "v": cv}
    o = o.reshape(b, t, cfg.n_heads * hd)
    return o @ params["wo"].to(o.dtype), new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, lead: tuple = ()) -> dict:
    dff = d_ff or cfg.d_ff
    dt = pdtype(cfg)
    return {
        "wg": init_dense(gen, cfg.d_model, dff, dt, lead=lead),
        "wu": init_dense(gen, cfg.d_model, dff, dt, lead=lead),
        "wd": init_dense(gen, dff, cfg.d_model, dt, lead=lead),
        "norm": torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                           device=gen.device),
    }


def mlp_block(params: dict, x: torch.Tensor,
              cfg: ArchConfig | None = None) -> torch.Tensor:
    h = rmsnorm(x, params["norm"])
    g = F.silu(h @ params["wg"].to(h.dtype))
    u = h @ params["wu"].to(h.dtype)
    return (g * u) @ params["wd"].to(h.dtype)


# ---------------------------------------------------------------------------
# LM head / embeddings
# ---------------------------------------------------------------------------

def init_embeddings(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = pdtype(cfg)
    tok = torch.empty((cfg.vocab, cfg.d_model), dtype=torch.float32,
                      device=gen.device).normal_(0.0, 0.02, generator=gen)
    p = {"tok": tok.to(dt),
         "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = init_dense(gen, cfg.d_model, cfg.vocab, dt, scale=0.5)
    return p


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    # the reference casts the whole table, then gathers; gathering first
    # gives the same values without a (vocab, d) copy per call
    return params["tok"][tokens].to(cdtype(cfg))


def lm_logits(params: dict, x: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    h = rmsnorm(x, params["final_norm"])
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w.to(h.dtype)

