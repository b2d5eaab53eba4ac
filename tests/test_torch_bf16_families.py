"""The port's Mamba2 and RWKV6 paths at bfloat16 compute (the precision
rwkv6-3b and zamba2-1.2b are served at) against the reference's, at smoke
size on the CPU, on the reference's weights carried across.

Limits.  Two kinds, both recorded with a planted fault's readings in
PERF.md (section 6, the LM families):

* The recurrences (`_rwkv_scan`, `_rwkv_chunked`, `_ssd_chunked`) take
  bf16 inputs and run in f32 on both sides: allclose(rtol=1e-4,
  atol=1e-4) on f32 outputs and carried states, and one bf16 ulp (rtol
  2**-7) on `_ssd_chunked`'s output, which both sides round to bf16.  A
  state or a product rounded to bf16 inside a recurrence misses by ~1e-3.
* Blocks and models compute in bf16 on both sides, each by its own
  library's kernels (torch runs a bf16 elementwise op in f32 and rounds
  once; XLA rounds some intermediates), so they cannot agree to f32
  tolerances.  Each output and cache leaf is held by its relative L2
  distance from the reference at bf16, against the reference's own bf16
  rounding error on the same weights and inputs (its distance from the
  reference at f32):
      rel(port_bf16, ref_bf16) <= ratio * rel(ref_bf16, ref_f32).
  Blocks, on long-memory weights (`LONG_DECAY`): ratio BLOCK_RATIO = 1;
  sound readings reach 0.66 over three seeds, a Mamba2 state rounded to
  bf16 each decode step reads 1.28, a WKV state so rounded 1.17, norms
  computed in bf16 1.56.  Models (the rwkv6 and zamba2 smoke configs on
  the reference's weights, prefill, 12 decode steps, every cache leaf):
  ratio MODEL_RATIO = 2; sound readings reach 1.20 over three seeds, and
  the planted faults above read at most 1.56 there, so this level holds
  only faults larger than the rounding itself: the two levels above
  separate the finer ones.  `tests/torch_bf16_study.py` prints these
  readings.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import api as japi
from repro.models import hybrid as jhy
from repro.models import rwkv as jrw
from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.models import hybrid as thy
from repro_torch.models import layers as tl
from repro_torch.models import rwkv as trw
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
BF16_ULP = 2.0 ** -7
BLOCK_RATIO = 1.0
MODEL_RATIO = 2.0
# a_log (Mamba2) and w0 (RWKV6) that make every step's decay ~1, so a
# state carries its rounding over the whole sequence
LONG_DECAY = -8.0


def smoke(arch: str, **over):
    """The reference's smoke config; zamba2-1.2b with 5 layers, so its
    2-layer groups leave a tail layer."""
    cfg = RC.smoke_config(arch)
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, n_layers=5)
    return dataclasses.replace(cfg, **over)


def bf16(cfg):
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def weights(cfg):
    """(reference params, the port's copy) for one smoke config (f32
    params; the compute dtype does not enter the params)."""
    jp = jax.jit(japi.build_model(cfg).init)(jax.random.PRNGKey(0))
    return jp, interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return np.asarray(np.asarray(a, np.float32), np.float64)


def rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def reading(port, ref_bf16, ref_f32) -> tuple[float, float]:
    """(rel(port, ref_bf16), rel(ref_bf16, ref_f32))."""
    return rel(port, ref_bf16), rel(ref_bf16, ref_f32)


def assert_within_rounding(readings: dict, ratio: float) -> None:
    bad = {k: v for k, v in readings.items() if v[0] > ratio * v[1]}
    assert not bad, f"port vs reference at bf16 past {ratio} x the " \
        f"reference's own bf16 error (port-ref, ref bf16-f32): {bad}"


def _x(d, b, t, seed):
    return np.random.RandomState(seed).randn(b, t, d).astype(np.float32)


def _tokens(cfg, b, t, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, t)
                                               ).astype(np.int32)


def _stack(outs):
    return np.stack([_np(o) for o in outs])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# the recurrences on bf16 inputs
# ---------------------------------------------------------------------------

def _recurrence_inputs(kind: str, seed: int = 0):
    """bf16 inputs with long-memory decays, and an f32 carried state."""
    rng = np.random.RandomState(seed)
    b, t, h = 2, 150, 2

    def bf(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32).astype(
            jnp.bfloat16)

    if kind == "ssd_chunked":
        p, n = 16, 8
        x = bf(b, t, h, p)
        a_log = (-np.exp(LONG_DECAY) * rng.rand(b, t, h)).astype(np.float32)
        bm, cm = (rng.randn(b, t, n).astype(np.float32) for _ in range(2))
        s0 = rng.randn(b, h, p, n).astype(np.float32)
        return (x, a_log, bm, cm), s0
    c = 16
    r, k, v = (bf(b, t, h, c) for _ in range(3))
    w_log = (-np.exp(LONG_DECAY) * rng.rand(b, t, h, c)).astype(np.float32)
    u = rng.randn(h, c).astype(np.float32) * 0.5
    s0 = rng.randn(b, h, c, c).astype(np.float32)
    return (r, k, v, w_log, u), s0


def _run_recurrence(kind: str, args, s0):
    """(reference (y, state), port (y, state)) on the same inputs."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        for a in args]
    if kind == "ssd_chunked":
        want = jssm._ssd_chunked(*jargs, 64, init_state=jnp.asarray(s0))
        got = tssm._ssd_chunked(*targs, 64, init_state=torch.as_tensor(s0))
    elif kind == "rwkv_chunked":
        want = jssm._rwkv_chunked(*jargs, 64, init_state=jnp.asarray(s0))
        got = tssm._rwkv_chunked(*targs, 64, init_state=torch.as_tensor(s0))
    else:
        want = jax.jit(jssm._rwkv_scan)(*jargs, init_state=jnp.asarray(s0))
        got = tssm._rwkv_scan(*targs, init_state=torch.as_tensor(s0))
    return want, got


@pytest.mark.parametrize("kind", ["rwkv_scan", "rwkv_chunked",
                                  "ssd_chunked"])
def test_recurrences_on_bf16_inputs_match_reference(kind):
    # 150 tokens (3 chunks of 64, the last padded), decays ~1: a state
    # rounded to bf16 anywhere in the recurrence carries its error to the
    # end
    args, s0 = _recurrence_inputs(kind)
    (wy, ws), (gy, gs) = _run_recurrence(kind, args, s0)
    assert gs.dtype == torch.float32 and gs.shape == tuple(ws.shape)
    np.testing.assert_allclose(_np(gs), _np(ws), rtol=RTOL, atol=ATOL)
    if kind == "ssd_chunked":
        assert gy.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(gy), _np(wy), rtol=BF16_ULP,
                                   atol=ATOL)
    else:
        assert gy.dtype == torch.float32
        np.testing.assert_allclose(_np(gy), _np(wy), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# blocks, long-memory weights
# ---------------------------------------------------------------------------

def mamba_readings(seed: int = 1, steps: int = 48) -> dict:
    """mamba_block at bf16: a 200-token prefill (4 chunks, padded) and
    `steps` steps of the state branch, outputs and states."""
    cfg = smoke("zamba2-1.2b")
    cb, tcb = bf16(cfg), interop.arch_config(bf16(cfg))
    jp, tp = weights(cfg)
    jm = dict(jax.tree.map(lambda a: a[0, 0], jp["mamba_groups"]))
    tm = dict(tl.layer_params(tp["mamba_groups"], 0, 0))
    jm["a_log"] = jnp.full_like(jm["a_log"], LONG_DECAY)
    tm["a_log"] = torch.full_like(tm["a_log"], LONG_DECAY)
    x = _x(cfg.d_model, 2, 200, seed)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    step = jax.jit(jssm.mamba_block, static_argnames=("cfg",))
    out = {"prefill": reading(
        tssm.mamba_block(tm, torch.as_tensor(x).bfloat16(), tcb)[0],
        step(jm, xb, cfg=cb)[0], step(jm, jnp.asarray(x), cfg=cfg)[0])}
    sf, sb = jssm.mamba_init_state(cfg, 2), jssm.mamba_init_state(cb, 2)
    ts = tssm.mamba_init_state(tcb, 2, device="cpu")
    of, ob, ot = [], [], []
    for i in range(steps):
        o, sf = step(jm, jnp.asarray(x[:, i:i + 1]), cfg=cfg, state=sf)
        of.append(o)
        o, sb = step(jm, xb[:, i:i + 1], cfg=cb, state=sb)
        ob.append(o)
        o, ts = tssm.mamba_block(tm, torch.as_tensor(x[:, i:i + 1])
                                 .bfloat16(), tcb, state=ts)
        ot.append(o)
    out["steps"] = reading(_stack(ot), _stack(ob), _stack(of))
    for key in ("ssm", "conv"):
        assert ts[key].dtype == getattr(torch, str(sb[key].dtype))
        out[f"state/{key}"] = reading(ts[key], sb[key], sf[key])
    return out


def rwkv_mix_readings(mode: str, seed: int = 4) -> dict:
    """rwkv_tmix and rwkv_cmix at bf16 over 200 tokens."""
    cfg = smoke("rwkv6-3b", rwkv_mode=mode)
    cb, tcb = bf16(cfg), interop.arch_config(bf16(cfg))
    jp, tp = weights(smoke("rwkv6-3b"))
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = tl.layer_params(tp["layers"], 0)
    jt, tt = dict(jl["tmix"]), dict(tlp["tmix"])
    jt["w0"] = jnp.full_like(jt["w0"], LONG_DECAY)
    tt["w0"] = torch.full_like(tt["w0"], LONG_DECAY)
    x = _x(cfg.d_model, 2, 200, seed)
    xb, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(
        x).bfloat16()
    tmix = jax.jit(jssm.rwkv_tmix, static_argnames=("cfg",))
    return {
        "tmix": reading(tssm.rwkv_tmix(tt, xt, tcb)[0],
                        tmix(jt, xb, cfg=cb)[0],
                        tmix(jt, jnp.asarray(x), cfg=cfg)[0]),
        "cmix": reading(tssm.rwkv_cmix(tlp["cmix"], xt, tcb)[0],
                        jssm.rwkv_cmix(jl["cmix"], xb, cb)[0],
                        jssm.rwkv_cmix(jl["cmix"], jnp.asarray(x), cfg)[0])}


def test_mamba_block_at_bf16_matches_reference():
    assert_within_rounding(mamba_readings(), BLOCK_RATIO)


@pytest.mark.parametrize("mode", ["scan", "chunked"])
def test_rwkv_mixes_at_bf16_match_reference(mode):
    assert_within_rounding(rwkv_mix_readings(mode), BLOCK_RATIO)


# ---------------------------------------------------------------------------
# the served models, the reference's weights
# ---------------------------------------------------------------------------

def _decode(jstep, jp, jcache, tstep, tp, tcache, toks, cfgs):
    """Reference decode at (f32, bf16) and the port's at bf16, token by
    token; returns the stacked logits and the final caches."""
    (cf, cb), tcb = cfgs, interop.arch_config(cfgs[1])
    jf, jb = jcache
    lf, lb, lt = [], [], []
    for pos in range(toks.shape[1]):
        tok = jnp.asarray(toks[:, pos:pos + 1])
        o, jf = jstep(jp, jf, tok, jnp.int32(pos), cfg=cf)
        lf.append(o)
        o, jb = jstep(jp, jb, tok, jnp.int32(pos), cfg=cb)
        lb.append(o)
        o, tcache = tstep(tp, tcache, torch.as_tensor(toks[:, pos:pos + 1])
                          .long(), pos, tcb)
        lt.append(o)
    return (_stack(lt), _stack(lb), _stack(lf)), (tcache, jb, jf)


def _cache_readings(tc, jb, jf) -> dict:
    got, want_b, want_f = _leaves(tc), _leaves(jb), _leaves(jf)
    assert set(got) == set(want_b)
    out = {}
    for key, g in got.items():
        assert g.dtype == getattr(torch, str(want_b[key].dtype)), key
        out["cache" + key] = reading(g, want_b[key], want_f[key])
    return out


def rwkv6_readings(seed: int = 5) -> dict:
    cfg = smoke("rwkv6-3b")
    jp, tp = weights(cfg)
    toks = _tokens(cfg, 2, 37, seed)
    pre = jax.jit(jrw.rwkv_prefill, static_argnums=1)
    out = {}
    for mode in ("scan", "chunked"):
        cf = dataclasses.replace(cfg, rwkv_mode=mode)
        out[f"prefill/{mode}"] = reading(
            trw.rwkv_prefill(tp, interop.arch_config(bf16(cf)),
                             torch.as_tensor(toks).long()),
            pre(jp, bf16(cf), jnp.asarray(toks)),
            pre(jp, cf, jnp.asarray(toks)))
    step = jax.jit(jrw.rwkv_decode_step, static_argnames=("cfg",))
    logits, caches = _decode(
        step, jp, (jrw.init_rwkv_cache(cfg, 2, 12),
                   jrw.init_rwkv_cache(bf16(cfg), 2, 12)),
        trw.rwkv_decode_step, tp,
        trw.init_rwkv_cache(interop.arch_config(bf16(cfg)), 2, 12, "cpu"),
        toks[:, :12], (cfg, bf16(cfg)))
    out["decode"] = reading(*logits)
    out.update(_cache_readings(*caches))
    return out


def zamba2_readings(seed: int = 8) -> dict:
    # shared_attn_window 8 under 12 decode steps: the ring buffers wrap
    cfg = smoke("zamba2-1.2b")
    jp, tp = weights(cfg)
    toks = _tokens(cfg, 2, 30, seed)
    pre = jax.jit(jhy.hybrid_prefill, static_argnums=1)
    out = {"prefill": reading(
        thy.hybrid_prefill(tp, interop.arch_config(bf16(cfg)),
                           torch.as_tensor(toks).long()),
        pre(jp, bf16(cfg), jnp.asarray(toks)),
        pre(jp, cfg, jnp.asarray(toks)))}
    cw = dataclasses.replace(cfg, shared_attn_window=8)
    step = jax.jit(jhy.hybrid_decode_step, static_argnames=("cfg",))
    logits, caches = _decode(
        step, jp, (jhy.init_hybrid_cache(cw, 2, 16),
                   jhy.init_hybrid_cache(bf16(cw), 2, 16)),
        thy.hybrid_decode_step, tp,
        thy.init_hybrid_cache(interop.arch_config(bf16(cw)), 2, 16, "cpu"),
        toks[:, :12], (cw, bf16(cw)))
    out["decode"] = reading(*logits)
    out.update(_cache_readings(*caches))
    return out


def test_rwkv6_at_bf16_matches_reference():
    # prefill in both modes, 12 decode steps, every cache leaf
    assert_within_rounding(rwkv6_readings(), MODEL_RATIO)


def test_zamba2_at_bf16_matches_reference():
    # prefill, 12 decode steps over a wrapping ring buffer, every cache
    # leaf (the groups' and the tail's Mamba2 states, the shared
    # attention's keys and values)
    assert_within_rounding(zamba2_readings(), MODEL_RATIO)


def all_readings(seed_offset: int = 0) -> dict:
    """Every block and model reading of this file (for the study script
    and PERF.md): {check: {leaf: (port vs ref bf16, ref bf16 vs f32)}}."""
    s = seed_offset
    return {"mamba_block": mamba_readings(1 + s),
            "rwkv_mix/scan": rwkv_mix_readings("scan", 4 + s),
            "rwkv_mix/chunked": rwkv_mix_readings("chunked", 4 + s),
            "rwkv6": rwkv6_readings(5 + s),
            "zamba2": zamba2_readings(8 + s)}
