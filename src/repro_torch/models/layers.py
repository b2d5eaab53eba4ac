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
    models name their mesh (there is no ambient one), so it returns x.
    `act_spec` keeps the reference's activation templates.
  * on a mesh with a process group attached (one rank a position), each
    leaf is this rank's block by `launch.sharding.rank_specs`, and the
    blocks read each leaf's fitted spec (`_Ranks.weight`, the rules on
    the global shape the config gives) to lay out their activations as
    the `tp` templates do: q and kv heads, the ffn hidden dim and the
    vocab split over `model` (`GroupShards.copy` before a split product,
    `sum` after it: Megatron's f and g), and a leaf split over `data`
    (fsdp) gathered over `data` before its use (`GroupShards.gather`,
    whose backward sums the cotangent over `data`).  The gathered weight
    is what the product saves for the backward (kept until then), or it
    is gathered again where the config's remat recomputes the layer.
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
  * under the `sp` scheme on ranks (`seq_shards`) a `model` rank holds
    its positions of the sequence, the dense weights whole over `model`:
    what crosses positions goes over `model` (attention's K / V, the MoE
    groups' tokens, `halo` for a shift or conv, `last_position` for a
    prefill), and the loss adds over `data` and `model`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import (GroupShards, StackedShards,
                                          axis_group)
from repro_torch.launch.sharding import (P, cache_specs, entry_axes,
                                         fit_spec, map_leaves, rank_heads,
                                         spec_for_path)


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


class _Ranks:
    """A block's view of the ranks of a mesh with a process group: each
    leaf's fitted spec, the FSDP gather over `data` and the Megatron pair
    over `model` (`self.model`, None on a `model` axis of 1)."""

    def __init__(self, cfg: ArchConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.sizes = mesh.shape
        self.model = GroupShards(axis_group(mesh, ("model",))) \
            if self.sizes.get("model", 1) > 1 else None
        self.r = self.model.rank if self.model is not None else 0
        self.data = GroupShards(axis_group(mesh, ("data",))) \
            if self.sizes.get("data", 1) > 1 else None
        # the `sp` scheme: a `model` rank holds positions [r T / S, (r +
        # 1) T / S) of the sequence
        self.seq = self.model if cfg.sharding_scheme == "sp" else None

    def over(self, spec, dim: int, axis: str) -> bool:
        """Whether dim `dim` of a leaf laid out by `spec` splits over
        `axis` (of more than one position)."""
        return axis in entry_axes(spec[dim]) and self.sizes[axis] > 1

    def spec(self, path: str, shape: tuple):
        """The fitted spec of the leaf at `path` (the reference's key
        path, which picks the rule) of global `shape`."""
        return fit_spec(spec_for_path(self.cfg, path, len(shape), "data",
                                      "model"), shape, self.mesh)

    def cols(self, n: int) -> tuple[int, int]:
        """This `model` rank's range of a dim of `n` split over `model`."""
        per = n // self.sizes["model"]
        return self.r * per, (self.r + 1) * per

    def weight(self, w: torch.Tensor, path: str, shape: tuple):
        """(`w` gathered over `data` where the leaf splits over it, its
        fitted spec): `w` is this rank's block of the leaf at `path` of
        global `shape`, that block gathered over `data` already
        (`train.ranks.RankLayout.without_fsdp`: a serving engine's), or
        the whole leaf, which every rank then uses whole (its spec all
        None)."""
        if tuple(w.shape) == tuple(shape):
            return w, P(*([None] * len(shape)))
        spec = self.spec(path, shape)

        def block(axes):
            return tuple(n // int(np.prod([self.sizes[a] for a in
                                           entry_axes(e) if a in axes]))
                         for n, e in zip(shape, spec))

        if tuple(w.shape) == block(set(self.sizes) - {"data"}):
            return w, spec
        want = block(set(self.sizes))
        if tuple(w.shape) != want:
            raise ValueError(f"{path}: a block of {tuple(w.shape)}, the "
                             f"layout {spec} of {shape} gives {want}")
        for dim in range(len(shape)):
            if self.over(spec, dim, "data"):
                w = self.data.gather(w, dim)
        return w, spec


def _ranks(cfg: ArchConfig, mesh) -> Optional[_Ranks]:
    """The ranks' view, or None when the mesh has no process group (no
    mesh, or its positions stacked in this process: leaves whole)."""
    if cfg is None or mesh is None or mesh.group is None:
        return None
    return _Ranks(cfg, mesh)


def seq_shards(cfg: ArchConfig, mesh=None) -> Optional[GroupShards]:
    """The `model` collectives when a rank holds its positions of the
    sequence (the `sp` scheme on ranks with a `model` axis of more than
    one: rank r the T / S positions from r T / S on), else None."""
    rk = _ranks(cfg, mesh)
    return None if rk is None else rk.seq


class _Tie(torch.autograd.Function):
    """`y` as it is; `t` joins the graph with a zero cotangent, so that a
    collective behind `t` runs its backward on this rank too (every rank
    of its group must)."""

    @staticmethod
    def forward(ctx, y, t):
        ctx.like = (t.shape, t.dtype, t.device)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, dev = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=dev)


def tie(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`y`, with `t` in its backward (`_Tie`) where either needs a
    gradient."""
    if torch.is_grad_enabled() and (y.requires_grad or t.requires_grad):
        return _Tie.apply(y, t)
    return y


def halo(x: torch.Tensor, n: int, seq: GroupShards) -> torch.Tensor:
    """The n positions before this rank's of a (B, T / S, ...) sequence
    split over `seq`'s ranks in order: the previous rank's last n, zeros
    on rank 0, as a causal shift or conv pads the sequence's start.
    Differentiable: the previous rank's positions take their cotangent
    back (`GroupShards.gather`)."""
    if x.shape[1] < n:
        raise ValueError(f"{x.shape[1]} positions a rank, a halo of {n}")
    every = seq.gather(x[:, -n:], 1)
    if seq.rank == 0:
        return tie(x.new_zeros((x.shape[0], n) + tuple(x.shape[2:])),
                   every)
    return every[:, (seq.rank - 1) * n:seq.rank * n]


def last_position(x: torch.Tensor, cfg: ArchConfig, mesh=None
                  ) -> torch.Tensor:
    """x[:, -1:] of the whole sequence on every rank: the last rank's
    under the `sp` scheme (a prefill's next-token logits), this rank's
    elsewhere."""
    seq = seq_shards(cfg, mesh)
    if seq is None:
        return x[:, -1:]
    return seq.gather(x[:, -1:], 1)[:, -1:]


def data_whole(w: torch.Tensor, path: str, shape: tuple, cfg: ArchConfig,
               mesh=None) -> torch.Tensor:
    """`w`, gathered over `data` on ranks where fsdp splits the leaf at
    `path` (of global `shape`); as it is elsewhere."""
    rk = _ranks(cfg, mesh)
    return w if rk is None else rk.weight(w, path, shape)[0]


def rank_cache(cfg: ArchConfig, cache, mesh=None):
    """A decode cache of this rank's rows laid out on its `model` rank:
    every dim that `launch.sharding.cache_specs` (fitted to the mesh)
    splits over `model` cut to this rank's block, in memory of its own
    (the RWKV6 wkv and Mamba2 ssm states' heads where they split whole
    over `model`); the rest whole (kv caches, `x_prev`, conv states, and
    the states of heads that a rank's columns cut).  As it is without
    ranks, and under the `sp` scheme: its weights give every head on
    every rank, so a decode step, which keeps the sequence whole on every
    `model` rank, scans every head (the states whole, not `cache_specs`'
    heads over `model`)."""
    rk = _ranks(cfg, mesh)
    if rk is None or rk.model is None or rk.seq is not None:
        return cache

    def one(_, leaf, spec):
        for dim, entry in enumerate(spec):
            if "model" in entry_axes(entry):
                lo, hi = rk.cols(leaf.shape[dim])
                leaf = leaf.narrow(dim, lo, hi - lo).clone()
        return leaf

    return map_leaves(one, cache, cache_specs(cfg, cache, mesh))


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


class RankAttention(NamedTuple):
    """This rank's attention (`attention_weights`): its weights, the
    index of the kv heads of k / v as `wk` / `wv` give them (of the
    cache, whose heads are the whole `wk`'s, in a decode step) that its
    q heads read in flash attention's grouping, the q columns its `wo`
    rows take when the heads are cut (its q then gathered over `model`,
    every head attended), and the `model` collectives (None: every head
    here)."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    kv: object = slice(None)
    cut: Optional[tuple[int, int]] = None
    tp: Optional[GroupShards] = None

    def q(self, h: torch.Tensor) -> torch.Tensor:
        """h @ wq, gathered over `model` where the heads are cut."""
        q = h @ self.wq.to(h.dtype)
        return q if self.cut is None else self.tp.gather(q, q.dim() - 1)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """The block's output from the heads' (B, T, nq hd): this rank's
        columns times its `wo` rows, added over `model`."""
        if self.cut is not None:
            o = o[..., self.cut[0]:self.cut[1]]
        out = o @ self.wo.to(o.dtype)
        return out if self.tp is None else self.tp.sum(out[None])


def attention_weights(params: dict, cfg: ArchConfig, mesh=None,
                      path: str = "attn", whole_kv: bool = False
                      ) -> RankAttention:
    """This rank's attention (`RankAttention`).  Without ranks, or where
    the q columns do not split over `model`, the weights whole (fsdp
    blocks gathered).  Split, rank r holds q columns [r H hd / S, (r + 1)
    H hd / S) of `wq` and those rows of `wo` (`launch.sharding.
    rank_heads`), and reads the whole `wk` / `wv` through
    `GroupShards.copy`, so their gradient adds every model rank's part:
    where the columns are whole heads, the kv heads its q heads read
    (each local q head mapped to its own kv head where the GQA groups do
    not fall whole on the rank), else every kv head, its q gathered over
    `model` and every head attended.  `whole_kv` (a decode step, which
    writes every kv head to the cache) keeps them whole."""
    rk = _ranks(cfg, mesh)
    if rk is None:
        return RankAttention(params["wq"], params["wk"], params["wv"],
                             params["wo"])
    d, hd = cfg.d_model, cfg.head_dim
    hq, hk = cfg.n_heads * hd, cfg.n_kv * hd
    wq, sq = rk.weight(params["wq"], f"['{path}']['wq']", (d, hq))
    wk, sk = rk.weight(params["wk"], f"['{path}']['wk']", (d, hk))
    wv, _ = rk.weight(params["wv"], f"['{path}']['wv']", (d, hk))
    wo, _ = rk.weight(params["wo"], f"['{path}']['wo']", (hq, d))
    if not rk.over(sq, 1, "model"):
        return RankAttention(wq, wk, wv, wo)
    if rk.over(sk, 1, "model"):
        raise ValueError(f"{path}: kv projections split over `model`")
    sp = rank_heads(cfg, rk.sizes["model"], rk.r)
    if not sp.whole:
        if not whole_kv:
            wk, wv = rk.model.copy(wk), rk.model.copy(wv)
        return RankAttention(wq, wk, wv, wo, cut=(sp.c0, sp.c1),
                             tp=rk.model)
    base = 0 if whole_kv else sp.kv0
    if not whole_kv:
        wk = rk.model.copy(wk)[:, sp.kv0 * hd:sp.kv1 * hd]
        wv = rk.model.copy(wv)[:, sp.kv0 * hd:sp.kv1 * hd]
    if sp.grouped:
        kv = slice(sp.kv0 - base, sp.kv1 - base)
    else:
        g = cfg.n_heads // cfg.n_kv
        kv = [q // g - base for q in range(sp.q0, sp.q1)]
    return RankAttention(wq, wk, wv, wo, kv, tp=rk.model)


def attention_block(params: dict, x: torch.Tensor, cfg: ArchConfig,
                    is_global: bool = True, positions=None,
                    cache: Optional[dict] = None, pos=None,
                    use_windowed_kernel: bool = False,
                    allow_pallas: bool = False, mesh=None,
                    path: str = "attn"):
    """Pre-norm attention.  If `cache` is given, runs as one decode step
    (x: (B, 1, D)) writing the cache at `pos` and attending over it.
    Returns (out, cache).  The flash kernel runs when the config sets
    `pallas_flash`, the layer is global and the caller allows it (the
    encoder prefill), as in the reference.  The port writes a decode step's
    keys and values into the cache tensors in place (the reference returns
    updated copies); the returned cache holds the same tensors.  On ranks
    (`mesh` with a process group) a rank computes its heads, or every
    head from q gathered over `model` where its columns cut a head
    (`attention_weights`; `path` names the params' key for the rules),
    and the output adds over `model`.  Under the `sp` scheme a rank's `x`
    is its positions of the sequence (`seq_shards`): rope takes their
    global positions, the keys and values are gathered over `model`
    (`GroupShards.gather`, whose backward adds every rank's queries'
    share), and the causal and window masks take the rank's query
    offset (`flash_attention(q_offset=)`; sliding-window layers there
    too, not `windowed_attention`, which has no offset); a decode step
    keeps the sequence whole."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    att = attention_weights(params, cfg, mesh, path,
                            whole_kv=cache is not None)
    h = rmsnorm(x, params["norm"])
    if att.tp is not None:
        h = att.tp.copy(h)
    q = att.q(h)
    nq, nk = q.shape[-1] // hd, att.wk.shape[-1] // hd
    q = q.reshape(b, t, nq, hd)
    k = (h @ att.wk.to(h.dtype)).reshape(b, t, nk, hd)
    v = (h @ att.wv.to(h.dtype)).reshape(b, t, nk, hd)
    window = 0 if is_global else cfg.window
    if cache is None:
        seq = seq_shards(cfg, mesh)
        start = 0 if seq is None else seq.rank * t
        if positions is None:
            positions = start + torch.arange(t, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k, v = k[:, :, att.kv], v[:, :, att.kv]
        if seq is not None:
            # every position's keys and values; a rank's queries start
            # at `start`
            k, v = seq.gather(k, 1), seq.gather(v, 1)
        if cfg.pallas_flash and window == 0 and allow_pallas:
            if seq is not None and cfg.causal:
                raise ValueError(f"{cfg.name}: the flash kernel takes no "
                                 f"query offset for causal positions")
            from repro_torch.kernels.ops import flash_attention_fused
            o = flash_attention_fused(q, k, v, causal=cfg.causal)
        elif not cfg.causal:
            o = flash_attention(q, k, v, causal=False, window=0)
        elif window and use_windowed_kernel and seq is None:
            o = windowed_attention(q, k, v, window)
        else:
            o = flash_attention(q, k, v, causal=True, window=window,
                                q_offset=start)
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
        o = flash_attention(q, ck[:, :, att.kv], cv[:, :, att.kv],
                            causal=False, kv_len=p + 1, block=2048)
        new_cache = {"k": ck, "v": cv}
    return att.out(o.reshape(b, t, nq * hd)), new_cache


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
              cfg: ArchConfig | None = None, mesh=None,
              path: str = "ffn") -> torch.Tensor:
    """SwiGLU MLP.  On ranks the fsdp blocks are gathered, and where the
    hidden dim splits over `model` a rank computes its columns of `wg` /
    `wu` and rows of `wd`, and the output adds over `model`."""
    wg, wu, wd, tp = params["wg"], params["wu"], params["wd"], None
    rk = _ranks(cfg, mesh)
    if rk is not None:
        d, f = cfg.d_model, cfg.d_ff
        wg, spec = rk.weight(wg, f"['{path}']['wg']", (d, f))
        wu, _ = rk.weight(wu, f"['{path}']['wu']", (d, f))
        wd, _ = rk.weight(wd, f"['{path}']['wd']", (f, d))
        tp = rk.model if rk.over(spec, 1, "model") else None
    h = rmsnorm(x, params["norm"])
    if tp is not None:
        h = tp.copy(h)
    g = F.silu(h @ wg.to(h.dtype))
    u = h @ wu.to(h.dtype)
    out = (g * u) @ wd.to(h.dtype)
    return out if tp is None else tp.sum(out[None])


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
              groups: int = 32, data: int = 1,
              seq: Optional[GroupShards] = None):
    """The routing half of `moe_block`.  Returns (xt (G, n_g, d) normed
    tokens, gate (G, n_g, k), route, cap); route = (sorted_e, rank, keep,
    tok, order), each (G, n_g k): the (token, choice) pairs of a group in
    the stable order of their expert, the pair's rank among its expert's,
    whether it is within capacity, its token and its flat index.

    G is the reference's gcd(global batch, groups) over the `data` ranks
    the global batch is split over (`x` is this rank's B / data rows of
    it), so a rank routes its rows in the same groups as the reference.
    With `seq` (the `sp` scheme: `x` is this rank's positions of its
    rows) the normed tokens and their router probabilities, computed on
    the rank's positions, are gathered over `model` (`GroupShards.gather`
    without the sum: what they feed runs alike on every `model` rank, so
    their cotangent is the whole one on each), and the rank routes whole
    rows, whose capacity and slot ranks run over a row's positions in
    order.

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
    if seq is None:
        xt = h.reshape(g_, (b // g_) * t, d)                # (G, n_g, d)
        probs = torch.softmax(xt.to(torch.float32) @ params["router"],
                              dim=-1)
    else:
        probs = torch.softmax(h.to(torch.float32) @ params["router"],
                              dim=-1)
        h, probs = seq.gather(h, 1, False), seq.gather(probs, 1, False)
        t = h.shape[1]
        xt = h.reshape(g_, (b // g_) * t, d)
        probs = probs.reshape(g_, (b // g_) * t, e)
    n_g = xt.shape[1]
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


def data_shards(mesh=None, cfg: Optional[ArchConfig] = None
                ) -> Optional[GroupShards]:
    """The collectives over the ranks that hold other terms of the loss:
    this rank's data ranks (its model column's `pod` and `data` ranks),
    and under `cfg`'s `sp` scheme its `model` ranks too (they hold other
    positions); None when neither splits the batch."""
    if mesh is None or mesh.group is None:
        return None
    axes = BATCH_AXES + (("model",) if seq_shards(cfg, mesh) is not None
                         else ())
    group = axis_group(mesh, axes)
    return None if group is None else GroupShards(group)


def moe_block(params: dict, x: torch.Tensor, cfg: ArchConfig,
              groups: int = 32, mesh=None, whole_seq: bool = False
              ) -> torch.Tensor:
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
    E) and the partials add over its `model` ranks.

    Under the `sp` scheme (`seq_shards`) `x` is the rank's positions of
    its rows, and `whole_seq` (a decode step) says it holds them all:
    the routing groups are whole rows (`moe_route(seq=)` gathers the
    tokens over `model`), every `model` rank dispatches the whole
    group's tokens to the experts it holds (the EP path) or to every
    expert, and the combined output, whose cotangent adds every rank's
    positions' (`GroupShards.copy`), is cut back to the rank's
    positions."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    s = _model_axis_size(mesh)
    rk = _ranks(cfg, mesh)
    seq = None if rk is None or whole_seq else rk.seq
    if rk is not None:
        params = dict(params)
        f = cfg.d_ff
        for name, shape in (("wg", (e, d, f)), ("wu", (e, d, f)),
                            ("wd", (e, f, d))):
            w, spec = rk.weight(params[name], f"['ffn']['{name}']", shape)
            if rk.over(spec, 0, "model") and not cfg.moe_local_combine:
                # the plain combine takes every expert; each model rank
                # computes the same outputs, so a block's cotangent is
                # its slice (nothing to add)
                w = rk.model.gather(w, 0, summed=False)
            elif seq is not None and not cfg.moe_local_combine \
                    and seq.rank:
                # a whole leaf that every model rank uses alike on the
                # same tokens: its gradient is rank 0's, which
                # `RankLayout.reduce` adds over `model` to nothing else
                w = w.detach()
            params[name] = w
    xt, gate, route, cap = moe_route(params, x, cfg, groups,
                                     data_ranks(mesh), seq)
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
    if seq is None:
        return out.reshape(b, t, d)
    out = seq.copy(out.reshape(b, t * seq.num_shards, d))
    return out[:, seq.rank * t:(seq.rank + 1) * t]


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


def _vocab_weight(params: dict, cfg: ArchConfig, rk: _Ranks,
                  table: bool):
    """(the embedding table (V, d) when `table`, else the LM head's (d,
    V): the table itself when tied; fsdp blocks gathered; whether its
    vocab splits over `model`)."""
    v, d = cfg.vocab, cfg.d_model
    if table or cfg.tie_embeddings:
        w, spec = rk.weight(params["tok"], "['embed']['tok']", (v, d))
        return (w if table else w.T), rk.over(spec, 0, "model")
    w, spec = rk.weight(params["unembed"], "['embed']['unembed']", (d, v))
    return w, rk.over(spec, 1, "model")


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                 mesh=None) -> torch.Tensor:
    """The token rows of the embedding table.  On ranks whose table splits
    its vocab over `model`, a rank reads the ids of its vocab range, the
    others' rows are 0, and the ranks add."""
    rk = _ranks(cfg, mesh)
    if rk is None:
        # the reference casts the whole table, then gathers; gathering
        # first gives the same values without a (vocab, d) copy per call
        return params["tok"][tokens].to(cdtype(cfg))
    tok, split = _vocab_weight(params, cfg, rk, table=True)
    if not split:
        return tok[tokens].to(cdtype(cfg))
    rows = tok.shape[0]
    local = tokens.long() - rk.r * rows
    own = (local >= 0) & (local < rows)
    x = tok[local.clamp(0, rows - 1)].to(cdtype(cfg))
    return rk.model.sum(torch.where(own[..., None], x, 0)[None])


def lm_logits(params: dict, x: torch.Tensor, cfg: ArchConfig, mesh=None,
              whole: bool = False) -> torch.Tensor:
    """The LM head.  On ranks whose vocab splits over `model` the logits
    are this rank's vocab columns (the loss takes them so), or with
    `whole` (serving) every rank's put together."""
    h = rmsnorm(x, params["final_norm"])
    rk = _ranks(cfg, mesh)
    if rk is None:
        w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
        return h @ w.to(h.dtype)
    w, split = _vocab_weight(params, cfg, rk, table=False)
    if not split:
        return h @ w.to(h.dtype)
    logits = rk.model.copy(h) @ w.to(h.dtype)
    return rk.model.gather(logits, logits.dim() - 1, summed=False) \
        if whole else logits


def vocab_shards(logits: torch.Tensor, cfg: ArchConfig, mesh=None
                 ) -> Optional[GroupShards]:
    """The `model` collectives when `logits` are this rank's vocab columns
    (`lm_logits` on ranks whose vocab splits over `model`), else None."""
    rk = _ranks(cfg, mesh)
    if rk is None or logits.shape[-1] == cfg.vocab:
        return None
    return rk.model


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, data: Optional[GroupShards] = None,
                 vocab: Optional[GroupShards] = None) -> torch.Tensor:
    """Masked mean cross-entropy in f32, as the reference's: the row max
    held out of the gradient, the loss divided by max(mask.sum(), 1).  The
    label's log-prob is a gather where the reference takes an einsum
    against a one-hot: the same single term, exact, without a (B, T, V)
    one-hot.

    With `data` (the collectives over the ranks that split the batch,
    `data_shards(mesh, cfg)`: the data ranks, and under the `sp` scheme
    the `model` ranks, which split its positions), the count is the
    global one and the
    ranks' terms are added (`GroupShards.sum`: the cotangent passes as it
    is), so the value is the global mean on every rank and a rank's
    gradient is its term's: the sum over the data ranks is the global
    mean's.

    With `vocab` (the `model` collectives, `vocab_shards(logits, cfg, mesh)`)
    `logits` are this rank's vocab columns, rank r's the r-th slice: the
    row max is the all-reduce MAX of the ranks' (held out of the
    gradient), the sum of exp adds the ranks' (`GroupShards.sum`), and
    the label's logit comes from the rank that holds it, added over
    `model`."""
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    if vocab is not None:
        m = vocab.max(m[None])
    shifted = logits - m
    total = torch.sum(torch.exp(shifted), dim=-1)
    if vocab is None:
        label = torch.gather(shifted, -1, targets.long()[..., None])[..., 0]
    else:
        total = vocab.sum(total[None])
        cols = logits.shape[-1]
        local = targets.long() - vocab.rank * cols
        own = (local >= 0) & (local < cols)
        label = torch.gather(shifted, -1,
                             local.clamp(0, cols - 1)[..., None])[..., 0]
        label = vocab.sum(torch.where(own, label, 0.0)[None])
    lse = torch.log(total) + m[..., 0]
    ll = label + m[..., 0]
    loss = (lse - ll) * mask
    count = mask.sum()
    if data is None:
        return loss.sum() / torch.clamp(count, min=1.0)
    count = data.sum(count.detach().to(torch.float32)[None])
    return data.sum((loss.sum() / torch.clamp(count, min=1.0))[None])
