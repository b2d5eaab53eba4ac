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
  * the MoE block routes as the reference does, tie for tie (a stable
    sort where the reference takes `lax.top_k` and `argsort`), and sums
    each token's expert outputs in the order the reference's scatter-add
    applies them, so the card and the CPU add the same terms in the same
    order.  Its EP combine (`_ep_local_combine`) runs on the shard
    collectives of `core.collectives`.  On a mesh with a process group
    attached (one rank a position), a rank routes its own rows of the
    batch in its share of the global batch's groups, and with the EP
    combine holds and computes only its `model` shard of the experts.
  * `softmax_xent` is the training objective's cross-entropy; over the
    data ranks of a group it divides by the global mask count and adds
    the ranks' terms, so every rank reads the global mean.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import (GroupShards, StackedShards,
                                          axis_group)


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
# MLP / MoE
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


def init_moe(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
             ) -> dict:
    """Router (f32) and the experts' gate, up and down weights, stacked
    (E, ...) behind `lead`.  The experts are drawn in the param dtype
    directly: a bf16 model's (E, d, f) slabs need no f32 copy."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = pdtype(cfg)

    def normal(shape, std):
        return torch.empty(lead + shape, dtype=dt, device=gen.device
                           ).normal_(0.0, std, generator=gen)

    return {
        "router": init_dense(gen, d, e, torch.float32, lead=lead),
        "wg": normal((e, d, f), 1.0 / np.sqrt(d)),
        "wu": normal((e, d, f), 1.0 / np.sqrt(d)),
        "wd": normal((e, f, d), 1.0 / np.sqrt(f)),
        "norm": torch.ones(lead + (d,), dtype=torch.float32,
                           device=gen.device),
    }


def moe_capacity(n_g: int, cfg: ArchConfig) -> int:
    """Slots an expert holds in a group of n_g tokens, in Python ints as
    the reference computes it: ceil(n_g k / e * cf) rounded up to a
    multiple of 8, at least 8."""
    cap = int(np.ceil(n_g * cfg.moe_top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_route(params: dict, x: torch.Tensor, cfg: ArchConfig,
              groups: int = 32, data: int = 1):
    """The routing half of `moe_block`.  Returns (xt (G, n_g, d) normed
    tokens, gate (G, n_g, k), route, cap); route = (sorted_e, rank, keep,
    tok, order), each (G, n_g k): the (token, choice) pairs of a group in
    the stable order of their expert, the pair's rank among its expert's,
    whether it is within capacity, its token and its flat index.

    G is the reference's gcd(global batch, groups) over the `data` ranks
    the global batch is split over (`x` is this rank's B / data rows of
    it), so a rank routes its rows in the same groups as the reference.

    Ties: the top k is a stable descending sort (`lax.top_k` gives the
    lower expert first) and the expert order a stable sort (`jnp.argsort`
    is stable), so the dropped pairs are the reference's."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    g_all = int(np.gcd(b * data, groups))
    if g_all % data:
        raise ValueError(f"{g_all} routing groups of a global batch of "
                         f"{b * data} do not split over {data} data ranks")
    g_ = g_all // data
    h = rmsnorm(x, params["norm"])
    xt = h.reshape(g_, (b // g_) * t, d)                    # (G, n_g, d)
    n_g = xt.shape[1]
    probs = torch.softmax(xt.to(torch.float32) @ params["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = top.values[..., :k], top.indices[..., :k]   # (G, n_g, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = moe_capacity(n_g, cfg)

    e_flat = sel.reshape(g_, n_g * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order)
    # each group's expert counts (the reference's bincount) by an integer
    # scatter-add: exact, and no read of the largest id back to the host
    counts = torch.zeros((g_, e), dtype=e_flat.dtype, device=x.device
                         ).scatter_add_(1, e_flat, torch.ones_like(e_flat))
    seg_start = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(n_g * k, device=x.device) \
        - torch.gather(seg_start, 1, sorted_e)
    keep = rank < cap
    tok = torch.div(order, k, rounding_mode="floor")
    return xt, gate, (sorted_e, rank, keep, tok, order), cap


def _dispatch(xt: torch.Tensor, route, e: int, cap: int, lo: int = 0,
              held: Optional[int] = None) -> torch.Tensor:
    """(G, held, cap, d) buffers of experts lo .. lo + held (all E by
    default): each kept pair's token row at its (expert, rank) slot, zeros
    elsewhere.  A kept slot is written once, so no write is summed;
    dropped pairs and other experts' go to a spare row that is cut off
    (the reference adds zeros to slot cap - 1), with no device sync."""
    sorted_e, rank, keep, tok, _ = route
    held = e if held is None else held
    g_, n_g, d = xt.shape
    gi = torch.arange(g_, device=xt.device)[:, None]
    mine = keep & (sorted_e >= lo) & (sorted_e < lo + held)
    slot = (gi * held + sorted_e - lo) * cap + torch.clamp(rank, max=cap - 1)
    slot = torch.where(mine, slot, g_ * held * cap)
    rows = xt.reshape(g_ * n_g, d)[(gi * n_g + tok).reshape(-1)]
    buf = xt.new_zeros((g_ * held * cap + 1, d))
    buf[slot.reshape(-1)] = rows
    return buf[:-1].reshape(g_, held, cap, d)


def _experts(buf: torch.Tensor, params: dict, lo: int, held: int
             ) -> torch.Tensor:
    """(G, held, C, d) outputs of experts lo .. lo + held of `params`
    (whose leading expert dim holds those experts, or all E)."""
    def w(name):
        t = params[name]
        return (t if t.shape[0] == held else t[lo:lo + held]).to(buf.dtype)

    gg = torch.einsum("gecd,edf->gecf", buf, w("wg"))
    uu = torch.einsum("gecd,edf->gecf", buf, w("wu"))
    return torch.einsum("gecf,efd->gecd", F.silu(gg) * uu, w("wd"))


def _combine(vals: torch.Tensor, w: torch.Tensor, ok: torch.Tensor,
             order: torch.Tensor, k: int) -> torch.Tensor:
    """(G, n_g, d): each token's k terms where(ok, vals * w, 0), from pairs
    in route order, summed from zero in that order, the order in which the
    reference's scatter-add applies them.  No atomics: the card and the
    CPU add the same terms in the same order."""
    g_, nk, d = vals.shape
    terms = torch.where(ok[..., None], vals * w[..., None].to(vals.dtype),
                        0)
    # the route position of each (token, choice), then a token's k
    # positions in ascending (arrival) order
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(nk, device=order.device
                                        ).expand(g_, nk))
    arrival = torch.sort(pos.reshape(g_, nk // k, k), dim=-1).values
    out = vals.new_zeros((g_, nk // k, d))
    for c in range(k):
        idx = arrival[..., c, None].expand(-1, -1, d)
        out = out + torch.gather(terms, 1, idx)
    return out


def _model_axis_size(mesh=None) -> int:
    """The size of the mesh's `model` axis; 1 without a mesh or without
    that axis (the port's models name their mesh: there is no ambient
    one)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def data_ranks(mesh=None) -> int:
    """How many ranks the global batch is split over: the product of the
    mesh's `pod` and `data` axes when a process group is attached (a
    rank holds its rows), else 1 (the whole batch is here)."""
    if mesh is None or mesh.group is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in BATCH_AXES
                        if a in mesh.axis_names]))


def data_shards(mesh=None) -> Optional[GroupShards]:
    """The collectives over this rank's data ranks (its model column's
    `pod` and `data` ranks), or None when the batch is not split."""
    if data_ranks(mesh) == 1:
        return None
    return GroupShards(axis_group(mesh, BATCH_AXES))


def moe_block(params: dict, x: torch.Tensor, cfg: ArchConfig,
              groups: int = 32, mesh=None) -> torch.Tensor:
    """Token-choice top-k routing with grouped capacity-factor dispatch.

    Tokens are split into G = gcd(B, groups) groups along the batch dim;
    routing and rank assignment are per group, capacity ceil(n_g k / E *
    cf) rounded up to 8.  Expert compute is the batched (G, E, C, d) x
    (E, d, f) products.  With `cfg.moe_local_combine` and a mesh whose
    `model` axis is larger than 1, the combine is the EP one
    (`_ep_local_combine`, a partial sum a shard of experts); else the
    plain combine, as the reference whenever its `model` axis is 1.

    A mesh with a process group attached holds one rank a position: `x`
    is this rank's rows of the global batch (B is the global one over
    `data_ranks(mesh)`), and with the EP combine the rank dispatches to
    and computes only its `model` shard of the experts (the expert leaves
    hold those E / S experts, as `launch.sharding` lays them out, or all
    E) and the partials add over its `model` ranks."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    xt, gate, route, cap = moe_route(params, x, cfg, groups,
                                     data_ranks(mesh))
    s = _model_axis_size(mesh)
    held = params["wg"].shape[0]
    if cfg.moe_local_combine and s > 1:
        if e % s:
            raise ValueError(f"{e} experts do not split over a model axis "
                             f"of {s}")
        if held not in (e, e // s):
            raise ValueError(f"expert leaves of {held} experts: neither "
                             f"all {e} nor a model shard of {e // s}")
        if mesh.group is None:
            shards = StackedShards(s)
            oo = _experts(_dispatch(xt, route, e, cap), params, 0, e)
        else:
            shards = GroupShards(axis_group(mesh, ("model",)))
            lo = shards.rank * (e // s)
            # the tokens are every model rank's: their cotangent adds the
            # ranks' partials' (GroupShards.copy)
            buf = _dispatch(shards.copy(xt), route, e, cap, lo, e // s)
            oo = _experts(buf, params, lo, e // s)
        out = _ep_local_combine(oo, gate, route, cap, shards)
    else:
        if held != e:
            raise ValueError(f"the plain combine needs all {e} experts, "
                             f"the expert leaves hold {held}")
        sorted_e, rank, keep, tok, order = route
        oo = _experts(_dispatch(xt, route, e, cap), params, 0, e)
        vals = _gather_slots(oo, sorted_e, rank, cap)
        w = torch.gather(gate.reshape(gate.shape[0], -1), 1, order)
        out = _combine(vals, w, keep, order, k)
    return out.reshape(b, t, d)


def _gather_slots(oo: torch.Tensor, e_idx: torch.Tensor, rank: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """(G, n_g k, d): oo[g, e_idx, min(rank, cap - 1)] for each pair."""
    g_, e, _, d = oo.shape
    flat = e_idx * cap + torch.clamp(rank, max=cap - 1)
    return torch.gather(oo.reshape(g_, e * cap, d), 1,
                        flat[..., None].expand(-1, -1, d))


def _ep_local_combine(oo: torch.Tensor, gate: torch.Tensor, route,
                      cap: int, shards) -> torch.Tensor:
    """EP combine with a partial sum a shard of experts.

    The expert axis is split into `shards.num_shards` equal shards; `oo`
    (G, E_held, C, d) holds the expert outputs of this process's shards
    (`shards.local`, in that order).  Each shard adds, for every token,
    the terms of its own experts (the same arrival order as the plain
    combine, the other terms zero), and `shards.sum` adds the (G, n_g, d)
    partials: on a process group that moves k times fewer bytes than
    gathering every (token, choice) output.  Stacked, every shard runs
    here and the sum is over the stack.  The gate weights pass through
    `shards.copy`: on a group their cotangent adds every rank's."""
    sorted_e, rank, keep, tok, order = route
    k = gate.shape[-1]
    w = shards.copy(torch.gather(gate.reshape(gate.shape[0], -1), 1, order))
    e_loc = oo.shape[1] // len(shards.local)
    parts = []
    for row, ax in enumerate(shards.local):
        lo = ax * e_loc
        mine = oo[:, row * e_loc:(row + 1) * e_loc]
        in_shard = (sorted_e >= lo) & (sorted_e < lo + e_loc) & keep
        vals = _gather_slots(mine, torch.clamp(sorted_e - lo, 0, e_loc - 1),
                             rank, cap)
        parts.append(_combine(vals, w, in_shard, order, k))
    return shards.sum(torch.stack(parts))


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



def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, data: Optional[GroupShards] = None
                 ) -> torch.Tensor:
    """Masked mean cross-entropy in f32, as the reference's: the row max
    held out of the gradient, the loss divided by max(mask.sum(), 1).  The
    label's log-prob is a gather where the reference takes an einsum
    against a one-hot: the same single term, exact, without a (B, T, V)
    one-hot.

    With `data` (the collectives over the data ranks that split the
    batch, `data_shards(mesh)`), the count is the global one and the
    ranks' terms are added (`GroupShards.sum`: the cotangent passes as it
    is), so the value is the global mean on every rank and a rank's
    gradient is its term's: the sum over the data ranks is the global
    mean's."""
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    ll = torch.gather(shifted, -1, targets.long()[..., None])[..., 0] \
        + m[..., 0]
    loss = (lse - ll) * mask
    count = mask.sum()
    if data is None:
        return loss.sum() / torch.clamp(count, min=1.0)
    count = data.sum(count.detach().to(torch.float32)[None])
    return data.sum((loss.sum() / torch.clamp(count, min=1.0))[None])
