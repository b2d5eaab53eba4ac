"""State-space / linear-recurrence layers: Mamba2 (SSD) and RWKV6.

The counterpart of the reference's `models/ssm.py`.  Mamba2 runs the
chunked SSD formulation over a sequence (intra-chunk masked products plus
a carried inter-chunk state) and the one-token recurrence on a decode
state.  RWKV6 ("Finch": data-dependent per-channel decay) has the
reference's two sequence paths, chosen by `cfg.rwkv_mode`:

  * `scan`    the token-by-token recurrence;
  * `chunked` the GLA-style chunked form (per-chunk cumulative log-decay
              clipped to [-60, 0]).

A decode step runs the recurrence on the carried state in either mode.
Python loops take the place of `lax.scan` (over chunks in the chunked
forms, over tokens in the RWKV scan).  The dtypes are the reference's:
the SSM and WKV states, r/k/v/w and the recurrences in f32, the conv state
and the block outputs in the compute dtype.

Three-operand contractions are written as a product and one matmul-shaped
contraction, in the order each comment gives, so no (b, nc, Q, Q, h, p)
intermediate is built; products of f32 and compute-dtype operands run in
f32, as the reference's `preferred_element_type=f32` einsums do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models.layers import (_ranks, cdtype, halo, init_dense,
                                       pdtype, rmsnorm, seq_shards, tie)

MAMBA_HEAD_DIM = 64
RWKV_HEAD_DIM = 64
LORA_RANK = 32

f32 = torch.float32


def _normal(gen: torch.Generator, shape: tuple, std: float, dtype
            ) -> torch.Tensor:
    return torch.empty(shape, dtype=f32, device=gen.device).normal_(
        0.0, std, generator=gen).to(dtype)


def _full(lead: tuple, shape: tuple, value: float, device) -> torch.Tensor:
    return torch.full(lead + shape, value, dtype=f32, device=device)


def _shift(h: torch.Tensor, seq=None) -> torch.Tensor:
    """h shifted one token later along axis 1, zeros first; with `seq`
    (the `sp` scheme: h is this rank's positions) the previous rank's
    last position first (`layers.halo`)."""
    if seq is None:
        return F.pad(h, (0, 0, 1, 0))[:, :h.shape[1]]
    return torch.cat([halo(h, 1, seq), h[:, :-1]], dim=1)


def carry_in(log_decay: torch.Tensor, finals: torch.Tensor, r: int
             ) -> torch.Tensor:
    """The state entering segment `r` of a sequence cut into segments in
    order, of a recurrence affine in its state (s' = exp(log decay) s +
    input): `log_decay` (S, ...) each segment's summed log-decay
    (broadcast against the state), `finals` (S, ...) each segment's final
    state from a zero state.  s_0 = 0, s_{j+1} = exp(log_decay_j) s_j +
    finals_j: for two segments segment 1 starts from segment 0's final
    state exactly, as the one-process recurrence hands it on."""
    state = torch.zeros_like(finals[0])
    for j in range(r):
        state = torch.exp(log_decay[j]) * state + finals[j]
    return state


def split_scan(run, log_decay: torch.Tensor, state_shape: tuple, seq):
    """The output of a recurrence over this rank's segment of a sequence
    split in order over `seq`'s ranks (the `sp` scheme), as the
    one-process recurrence gives those positions: `run(init_state)` ->
    (y, final state) runs the segment (None: the zero state),
    `log_decay` is its summed log-decay (broadcast against the state of
    `state_shape`).  Every rank but the last runs its segment from zero
    for its final state; one all-gather (`GroupShards.gather`) brings
    every segment's (log-decay, final state) to every rank; `carry_in`
    gives the state entering this rank's segment, which runs again from
    it (rank 0 keeps its first run).  The gather's backward takes each
    segment's final state's cotangent back from the ranks after it."""
    s, r = seq.num_shards, seq.rank
    y = final = None
    if r < s - 1:
        y, final = run(None)
    else:
        final = log_decay.new_zeros(state_shape)
    ld = log_decay.expand(state_shape[:log_decay.dim()]).to(f32)
    n = ld.numel()
    every = seq.gather(torch.cat([ld.reshape(-1), final.to(f32).reshape(
        -1)])[None], 0)
    init = carry_in(every[:, :n].reshape((s,) + ld.shape)[
        (...,) + (None,) * (len(state_shape) - ld.dim())],
        every[:, n:].reshape((s,) + tuple(state_shape)), r)
    if r == 0:
        return tie(y, every)
    return run(init)[0]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // MAMBA_HEAD_DIM
    return d_inner, n_heads, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
               ) -> dict:
    d_inner, n_heads, n_state = mamba_dims(cfg)
    dt, dev = pdtype(cfg), gen.device
    return {
        "norm": _full(lead, (cfg.d_model,), 1.0, dev),
        "in_proj": init_dense(gen, cfg.d_model,
                              2 * d_inner + 2 * n_state + n_heads, dt,
                              lead=lead),
        "conv": _normal(gen, lead + (4, d_inner), 0.2, dt),
        "a_log": _full(lead, (n_heads,), 0.0, dev),      # A = -exp(a_log)
        "d_skip": _full(lead, (n_heads,), 1.0, dev),
        "dt_bias": _full(lead, (n_heads,), 0.0, dev),
        "out_proj": init_dense(gen, d_inner, cfg.d_model, dt, lead=lead),
    }


def _ssd_chunked(x, a_log, bm, cm, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  x: (B, T, H, P); a_log: (B, T, H) (<= 0); bm, cm:
    (B, T, N).  Returns (y (B, T, H, P) in x's dtype, final_state (B, H,
    P, N) f32)."""
    b, t, h, p = x.shape
    n = bm.shape[-1]
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log, bm, cm = (F.pad(a, (0, 0, 0, pad)) for a in (a_log, bm, cm))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    ac = a_log.reshape(b, nc, chunk, h)
    bc = bm.reshape(b, nc, chunk, n)
    cc = cm.reshape(b, nc, chunk, n)

    ca = torch.cumsum(ac, dim=2)                     # (b,nc,Q,h) inclusive
    # intra-chunk: L[t, i] = exp(ca_t - ca_i) for i <= t (per head)
    diff = ca[:, :, :, None, :] - ca[:, :, None, :, :]     # (b,nc,Q,Q,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    # bcqk,bcqkh,bckhp->bcqhp as (cb * L), then a product over k per
    # (b, c, h)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * L, xc)

    # chunk summaries: S_c = sum_i exp(ca_Q - ca_i) x_i (x) B_i
    decay_out = torch.exp(ca[:, :, -1:, :] - ca)           # (b,nc,Q,h)
    # bcqh,bcqhp,bcqn->bchpn as (decay_out * x), then a product over q
    s_c = torch.einsum("bcqhp,bcqn->bchpn", decay_out[..., None] * xc, bc)
    a_tot = torch.exp(ca[:, :, -1, :])                      # (b,nc,h)

    s = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * a_tot[:, c, :, None, None] + s_c[:, c]
    s_prev = torch.stack(s_prevs, dim=1)                    # (b,nc,h,p,n)
    decay_in = torch.exp(ca)                                # (b,nc,Q,h)
    # bcqn,bchpn,bcqh->bcqhp as a product over n, then times decay_in
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, s_prev) \
        * decay_in[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :t]
    return y.to(x.dtype), s


def _mamba_rank(params: dict, cfg: ArchConfig, mesh):
    """(params with fsdp blocks gathered, the `model` collectives, this
    rank's out_proj rows [c0, c1), the heads [h0, h1) it runs) on ranks;
    (params, None, (0, d_inner), (0, H)) elsewhere and where out_proj's
    rows do not split over `model` (every rank then runs the whole
    block)."""
    d_inner, n_heads, n_state = mamba_dims(cfg)
    rk = _ranks(cfg, mesh)
    if rk is None:
        return params, None, (0, d_inner), (0, n_heads)
    d, n_in = cfg.d_model, 2 * d_inner + 2 * n_state + n_heads
    p = dict(params)
    p["in_proj"], _ = rk.weight(params["in_proj"], "['mamba']['in_proj']",
                                (d, n_in))
    p["out_proj"], spec = rk.weight(params["out_proj"],
                                    "['mamba']['out_proj']", (d_inner, d))
    if not rk.over(spec, 0, "model"):
        return p, None, (0, d_inner), (0, n_heads)
    c0, c1 = rk.cols(d_inner)
    heads = (c0 // MAMBA_HEAD_DIM, c1 // MAMBA_HEAD_DIM) \
        if n_heads % rk.sizes["model"] == 0 else (0, n_heads)
    return p, rk.model, (c0, c1), heads


def mamba_block(params: dict, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[dict] = None, mesh=None):
    """Mamba2 block.  Over a sequence: chunked SSD over T.  Decode: state
    holds {"conv": (B, 3, d_inner), "ssm": (B, H, P, N)} and x is (B, 1,
    D).  Returns (out, new_state); new_state is None over a sequence.

    On ranks (`mesh` with a process group) whose out_proj rows split over
    `model`: in_proj's columns concatenate z, x, B, C and dt, so a
    rank's block of them cuts across those; it computes copy(h) @ its
    block and gathers the product over `model`.  It runs its heads (the
    rows of its out_proj block; every head where those rows cut one,
    sliced to its rows after the scan) with its z, x and dt columns, B
    and C whole, its channels of `conv` and heads of `a_log`, `d_skip`
    and `dt_bias` through `GroupShards.copy`; its out_proj rows give a
    partial that adds over `model`.  The decode state's ssm holds the
    heads it runs, its conv state every channel.

    Under the `sp` scheme (`layers.seq_shards`; the weights whole on
    every `model` rank) `x` is the rank's positions: the conv reads the
    previous rank's last 3 positions of its input (`layers.halo`; zeros
    on rank 0) and the SSD starts from the state the previous ranks hand
    on (`split_scan`).  A decode step keeps the sequence whole."""
    b, t, _ = x.shape
    d_inner, n_heads, n_state = mamba_dims(cfg)
    n_in = 2 * d_inner + 2 * n_state + n_heads
    params, tp, (c0, c1), (h0, h1) = _mamba_rank(params, cfg, mesh)
    ch0, ch1, nh = h0 * MAMBA_HEAD_DIM, h1 * MAMBA_HEAD_DIM, h1 - h0
    h = rmsnorm(x, params["norm"])
    if tp is None:
        zxbcdt = h @ params["in_proj"].to(h.dtype)
        pick = params
    else:
        h = tp.copy(h)
        w = params["in_proj"]
        if w.shape[-1] == n_in:
            zxbcdt = h @ tp.copy(w).to(h.dtype)
        else:
            zxbcdt = tp.gather(h @ w.to(h.dtype), h.dim() - 1)
        pick = {"conv": tp.copy(params["conv"])[:, ch0:ch1]}
        for name in ("a_log", "d_skip", "dt_bias"):
            pick[name] = tp.copy(params[name])[h0:h1]
    z, xin, bm, cm, dt = torch.split(
        zxbcdt, [d_inner, d_inner, n_state, n_state, n_heads], dim=-1)
    z, dt = z[..., c0:c1], dt[..., h0:h1]
    dt = F.softplus(dt.to(f32) + pick["dt_bias"])          # (b,t,H)
    a = -torch.exp(pick["a_log"])                          # (H,)
    d_skip = pick["d_skip"][None, None, :, None]
    w = pick["conv"].to(xin.dtype)

    if state is None:
        # causal depthwise conv (kernel 4): each product and each partial
        # sum in the compute dtype, in tap order, as the reference's
        seq = seq_shards(cfg, mesh)
        xc = xin[..., ch0:ch1]
        xp = F.pad(xc, (0, 0, 3, 0)) if seq is None \
            else torch.cat([halo(xc, 3, seq), xc], dim=1)
        conv = sum(xp[:, i:i + t] * w[i] for i in range(4))
        xs = F.silu(conv)
        xh = xs.reshape(b, t, nh, MAMBA_HEAD_DIM)
        xdt = xh * dt[..., None].to(xh.dtype)
        a_log, bm, cm = dt * a, bm.to(f32), cm.to(f32)

        def run(init):
            return _ssd_chunked(xdt, a_log, bm, cm, cfg.ssm_chunk, init)

        y = run(None)[0] if seq is None else split_scan(
            run, a_log.sum(1), (b, nh, MAMBA_HEAD_DIM, n_state), seq)
        y = y + xh * d_skip.to(xh.dtype)
        new_state = None
    else:
        conv_buf = torch.cat([state["conv"], xin], dim=1)  # (b,4,di)
        # the reference's dot over the 4 taps: products summed in f32 in
        # tap order and rounded once
        conv = sum(conv_buf[:, i:i + 1, ch0:ch1].to(f32) * w[i].to(f32)
                   for i in range(4))
        xs = F.silu(conv.to(xin.dtype))
        xh = xs.reshape(b, 1, nh, MAMBA_HEAD_DIM)
        xdt = (xh * dt[..., None].to(xh.dtype))[:, 0]       # (b,H,P)
        decay = torch.exp(dt[:, 0] * a)                     # (b,H)
        s = state["ssm"] * decay[:, :, None, None] \
            + xdt.to(f32)[..., None] * bm[:, 0].to(f32)[:, None, None, :]
        y = torch.einsum("bhpn,bn->bhp", s, cm[:, 0].to(f32))
        y = y.reshape(b, 1, nh, MAMBA_HEAD_DIM).to(xh.dtype)
        y = y + xh * d_skip.to(xh.dtype)
        new_state = {"conv": conv_buf[:, 1:], "ssm": s}

    y = y.reshape(b, t, ch1 - ch0)[..., c0 - ch0:c1 - ch0] * F.silu(z)
    out = y @ params["out_proj"].to(y.dtype)
    return (out if tp is None else tp.sum(out[None])), new_state


def mamba_init_state(cfg: ArchConfig, batch: int, lead: tuple = (),
                     device="cuda") -> dict:
    """Zero decode state, one per `lead` position (real tensors, written
    in place by the decode steps)."""
    dev = resolve_device(device)
    d_inner, n_heads, n_state = mamba_dims(cfg)
    return {"conv": torch.zeros(lead + (batch, 3, d_inner),
                                dtype=cdtype(cfg), device=dev),
            "ssm": torch.zeros(lead + (batch, n_heads, MAMBA_HEAD_DIM,
                                       n_state), dtype=f32, device=dev)}


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def rwkv_dims(cfg: ArchConfig) -> tuple[int, int]:
    return cfg.d_model // RWKV_HEAD_DIM, RWKV_HEAD_DIM


def init_rwkv_tmix(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
                   ) -> dict:
    d = cfg.d_model
    dt, dev = pdtype(cfg), gen.device
    return {
        "norm": _full(lead, (d,), 1.0, dev),
        "mu": torch.rand(lead + (5, d), dtype=f32, device=dev,
                         generator=gen),          # r, k, v, g, w lerp base
        "lora_a": init_dense(gen, d, LORA_RANK * 5, dt, 0.1, lead=lead),
        "lora_b": _normal(gen, lead + (5, LORA_RANK, d), 0.01, dt),
        "wr": init_dense(gen, d, d, dt, lead=lead),
        "wk": init_dense(gen, d, d, dt, lead=lead),
        "wv": init_dense(gen, d, d, dt, lead=lead),
        "wg": init_dense(gen, d, d, dt, lead=lead),
        "wo": init_dense(gen, d, d, dt, lead=lead),
        "w0": _full(lead, (d,), -0.6, dev),              # decay bias
        "wlora_a": init_dense(gen, d, LORA_RANK, dt, 0.1, lead=lead),
        "wlora_b": _normal(gen, lead + (LORA_RANK, d), 0.01, dt),
        "u": _full(lead, (d,), 0.0, dev),                # current-token bonus
        "ln_w": _full(lead, (d,), 1.0, dev),             # per-head groupnorm
    }


def _rwkv_mix(params, x, x_prev, tp=None):
    """RWKV6 ddlerp: 5 data-dependent token-shift mixes -> the r, k, v, g,
    w inputs.  x: (B, T, D); x_prev: (B, T, D) (token-shifted x).  With
    `tp` (the `model` collectives of ranks) the r, k, v and g inputs
    pass through `GroupShards.copy`: they feed products split over
    `model`."""
    delta = x_prev - x
    lora = torch.tanh(x @ params["lora_a"].to(x.dtype))       # (B,T,5R)
    b_, t_, _ = lora.shape
    lora = lora.reshape(b_, t_, 5, LORA_RANK)
    dyn = torch.einsum("btfr,frd->btfd", lora,
                       params["lora_b"].to(x.dtype))          # (B,T,5,D)
    mixed = x[:, :, None] + delta[:, :, None] * (
        params["mu"][None, None].to(x.dtype) + dyn)
    split = mixed[:, :, :4] if tp is None else tp.copy(mixed[:, :, :4])
    return [split[:, :, i] for i in range(4)] + [mixed[:, :, 4]]


def _rwkv_scan(r, k, v, w_log, u, init_state=None):
    """Token-recurrent WKV.  r, k, v: (B, T, H, C); w_log: (B, T, H, C)
    (<= 0); u: (H, C).  Returns (out (B, T, H, C), final_state (B, H, C,
    C)), f32."""
    b, t, h, c = r.shape
    r, k, v, w = (a.to(f32) for a in (r, k, v, w_log))
    s = torch.zeros((b, h, c, c), dtype=f32, device=r.device) \
        if init_state is None else init_state
    bonus = u[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]      # (b,h,c,c)
        outs.append(torch.einsum("bhc,bhcd->bhd", r[:, i], s + bonus * kv))
        s = torch.exp(w[:, i])[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def _rwkv_chunked(r, k, v, w_log, u, chunk: int, init_state=None):
    """GLA-style chunked WKV with per-channel decay.

    Numerics: the per-chunk cumulative log-decay is clipped to >= -60
    before exponentiation (contributions below e^-60 are zero in f32
    anyway), and pairs at or after the query are masked with -inf."""
    b, t, h, c = r.shape
    pad = (-t) % chunk
    if pad:
        r, k, v, w_log = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, w_log))
    nc = r.shape[1] // chunk
    rc, kc, vc, wc = (a.reshape(b, nc, chunk, h, c).to(f32)
                      for a in (r, k, v, w_log))
    cw = torch.cumsum(wc, dim=2)                    # (b,nc,Q,h,c) inclusive
    cw_ex = cw - wc                                 # exclusive (up to q-1)
    # scan semantics: out_q reads S_{q-1}, so kv_i decays by
    # prod_{j=i+1..q-1} w_j = exp(cw_{q-1} - cw_i) = exp(cw_ex_q - cw_i)
    diff = cw_ex[:, :, :, None] - cw[:, :, None, :, :]      # (b,nc,Q,Q,h,c)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    ldec = torch.where(tri[None, None, :, :, None, None],
                       torch.clamp(diff, -60.0, 0.0), float("-inf"))
    # bcqhd,bcqkhd,bckhd->bcqkh: the decay term exp(ldec) couples q, k
    # and d, so it is the product of all three, summed over d
    scores = (rc[:, :, :, None] * torch.exp(ldec) * kc[:, :, None]).sum(-1)
    y_intra = torch.einsum("bcqkh,bckhd->bcqhd", scores, vc)
    # current-token bonus (i == q uses u instead of the state)
    y_bonus = (rc * (u[None, None, None] * kc)).sum(-1)[..., None] * vc
    # inter-chunk: y_q += r_q * exp(cw_{q-1}) . S_prev (same exclusive rule)
    dec_in = torch.exp(torch.clamp(cw_ex, -60.0, 0.0))
    # chunk summary: S_c = sum_i exp(cw_Q - cw_i) k_i (x) v_i
    dec_out = torch.exp(torch.clamp(cw[:, :, -1:] - cw, -60.0, 0.0))
    s_c = torch.einsum("bcqhd,bcqhe->bchde", kc * dec_out, vc)
    a_tot = torch.exp(torch.clamp(cw[:, :, -1], -60.0, 0.0))  # (b,nc,h,c)

    s = torch.zeros((b, h, c, c), dtype=f32, device=r.device) \
        if init_state is None else init_state
    s_prevs = []
    for i in range(nc):
        s_prevs.append(s)
        s = a_tot[:, i, ..., None] * s + s_c[:, i]
    s_prev = torch.stack(s_prevs, dim=1)                    # (b,nc,h,c,c)
    y_inter = torch.einsum("bcqhd,bchde->bcqhe", rc * dec_in, s_prev)
    y = (y_intra + y_bonus + y_inter).reshape(b, nc * chunk, h, c)[:, :t]
    return y, s


_TMIX = {"lora_a": ("d", 5 * LORA_RANK), "wlora_a": ("d", LORA_RANK),
         "wr": ("d", "d"), "wk": ("d", "d"), "wv": ("d", "d"),
         "wg": ("d", "d"), "wo": ("d", "d")}


def _tmix_rank(params: dict, cfg: ArchConfig, mesh):
    """(params with fsdp blocks gathered, the `model` collectives, this
    rank's columns [c0, c1) of r / k / v / g and rows of wo) on ranks
    whose wr columns split over `model`; (params, None, (0, D))
    elsewhere (every model rank then computes the whole block)."""
    d = cfg.d_model
    rk = _ranks(cfg, mesh)
    if rk is None:
        return params, None, (0, d)
    p, specs = dict(params), {}
    for name, dims in _TMIX.items():
        shape = tuple(d if n == "d" else n for n in dims)
        p[name], specs[name] = rk.weight(params[name], f"['layers']['tmix']"
                                         f"['{name}']", shape)
    if not rk.over(specs["wr"], 1, "model"):
        return p, None, (0, d)
    return p, rk.model, rk.cols(d)


def rwkv_tmix(params: dict, x: torch.Tensor, cfg: ArchConfig,
              state: Optional[dict] = None, mesh=None):
    """RWKV6 time-mix.  state (decode): {"x_prev": (B, 1, D), "wkv": (B,
    H, C, C)}.  Returns (out, new_state).

    On ranks (`mesh` with a process group) whose r / k / v / g columns
    split over `model`, the mix runs whole on every rank and its r, k, v
    and g inputs pass through `GroupShards.copy`; a rank's columns give
    its r, k, v and g, and the decay of those columns comes from
    copy(tanh(xw @ wlora_a)) and its columns of `wlora_b` and `w0`
    (through `copy`).  Where the columns are whole heads the scan (and
    the decode state) runs on its heads with its heads of `u` and
    `ln_w`; where they cut a head r, k, v and the decay are gathered
    over `model` and every head runs (the state holds every head), `u`
    and `ln_w` whole through `copy`, and the normed output is sliced to
    its columns.  Its wo rows give a partial that adds over `model`.

    Under the `sp` scheme (`layers.seq_shards`) `x` is the rank's
    positions: the token shift reads the previous rank's last normed
    position (zeros on rank 0) and the wkv scan starts from the state the
    previous ranks hand on (`split_scan`)."""
    b, t, d = x.shape
    n_heads, hd = rwkv_dims(cfg)
    params, tp, (c0, c1) = _tmix_rank(params, cfg, mesh)
    seq = seq_shards(cfg, mesh) if state is None else None
    h = rmsnorm(x, params["norm"])
    h_prev = _shift(h, seq) if state is None else state["x_prev"]
    xr, xk, xv, xg, xw = _rwkv_mix(params, h, h_prev, tp)
    r = xr @ params["wr"].to(h.dtype)
    k = xk @ params["wk"].to(h.dtype)
    v = xv @ params["wv"].to(h.dtype)
    g = F.silu(xg @ params["wg"].to(h.dtype))
    lw = torch.tanh(xw @ params["wlora_a"].to(h.dtype))
    w0, wlora_b, u, ln_w = (params[n] for n in ("w0", "wlora_b", "u",
                                                "ln_w"))
    cut = False
    if tp is not None:
        lw = tp.copy(lw)
        w0, wlora_b = tp.copy(w0)[c0:c1], tp.copy(wlora_b)[:, c0:c1]
        u, ln_w = tp.copy(u), tp.copy(ln_w)
        cut = (c1 - c0) % hd != 0
        if not cut:
            u, ln_w = u[c0:c1], ln_w[c0:c1]
    wl = w0 + lw.to(f32) @ wlora_b.to(f32)
    w_log = -torch.exp(wl.to(f32))                               # <= 0
    if cut:
        r, k, v, w_log = (tp.gather(a, a.dim() - 1)
                          for a in (r, k, v, w_log))
    nh = r.shape[-1] // hd
    r, k, v, w_log = (a.reshape(b, t, nh, hd) for a in (r, k, v, w_log))
    u = u.reshape(nh, hd)

    if state is None:
        def run(init):
            if cfg.rwkv_mode == "chunked":
                return _rwkv_chunked(r, k, v, w_log, u, cfg.ssm_chunk,
                                     init)
            return _rwkv_scan(r, k, v, w_log, u, init)

        y = run(None)[0] if seq is None else split_scan(
            run, w_log.sum(1), (b, nh, hd, hd), seq)
        new_state = None
    else:
        y, s = _rwkv_scan(r, k, v, w_log, u, init_state=state["wkv"])
        new_state = {"x_prev": h, "wkv": s}

    y = rmsnorm(y.to(x.dtype), ln_w.reshape(nh, hd)).reshape(b, t, nh * hd)
    if cut:
        y = y[..., c0:c1]
    out = (y * g) @ params["wo"].to(x.dtype)
    return (out if tp is None else tp.sum(out[None])), new_state


def init_rwkv_cmix(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
                   ) -> dict:
    d = cfg.d_model
    dt = pdtype(cfg)
    return {
        "norm": _full(lead, (d,), 1.0, gen.device),
        "mu": torch.rand(lead + (2, d), dtype=f32, device=gen.device,
                         generator=gen),
        "wk": init_dense(gen, d, cfg.d_ff, dt, lead=lead),
        "wv": init_dense(gen, cfg.d_ff, d, dt, lead=lead),
        "wr": init_dense(gen, d, d, dt, lead=lead),
    }


def rwkv_cmix(params: dict, x: torch.Tensor, cfg: ArchConfig,
              state: Optional[dict] = None, mesh=None):
    """RWKV6 channel-mix.  state (decode): {"x_prev": (B, 1, D)}.  On
    ranks it is Megatron's MLP where the hidden dim splits over `model`:
    copy(xk) times a rank's `wk` columns, its `wv` rows, the partials
    added over `model` before the product with sigmoid(xr @ wr) (`wr`
    whole).  Under the `sp` scheme its token shift reads the previous
    rank's last normed position, as the time-mix's does."""
    wk, wv, wr, tp = params["wk"], params["wv"], params["wr"], None
    rk = _ranks(cfg, mesh)
    if rk is not None:
        d, f = cfg.d_model, cfg.d_ff
        wk, spec = rk.weight(wk, "['layers']['cmix']['wk']", (d, f))
        wv, _ = rk.weight(wv, "['layers']['cmix']['wv']", (f, d))
        wr, _ = rk.weight(wr, "['layers']['cmix']['wr']", (d, d))
        tp = rk.model if rk.over(spec, 1, "model") else None
    h = rmsnorm(x, params["norm"])
    if state is None:
        h_prev, new_state = _shift(h, seq_shards(cfg, mesh)), None
    else:
        h_prev, new_state = state["x_prev"], {"x_prev": h}
    delta = h_prev - h
    mu = params["mu"].to(h.dtype)
    xk = h + delta * mu[0]
    xr = h + delta * mu[1]
    if tp is not None:
        xk = tp.copy(xk)
    kk = torch.square(F.relu(xk @ wk.to(h.dtype)))
    vv = kk @ wv.to(h.dtype)
    if tp is not None:
        vv = tp.sum(vv[None])
    return torch.sigmoid(xr @ wr.to(h.dtype)) * vv, new_state


def rwkv_init_state(cfg: ArchConfig, batch: int, lead: tuple = (),
                    device="cuda") -> dict:
    """Zero decode state, one per `lead` position (real tensors)."""
    dev = resolve_device(device)
    n_heads, hd = rwkv_dims(cfg)

    def prev():
        return torch.zeros(lead + (batch, 1, cfg.d_model), dtype=cdtype(cfg),
                           device=dev)

    return {"tmix": {"x_prev": prev(),
                     "wkv": torch.zeros(lead + (batch, n_heads, hd, hd),
                                        dtype=f32, device=dev)},
            "cmix": {"x_prev": prev()}}
