"""The port's attention-free and hybrid families and the VLM backbone
(`models.ssm`, `models.rwkv`, `models.hybrid`, `models.vlm`, their
bundles and the serve launcher) against the reference's, at smoke size on
the CPU.  The reference initialises the weights (jax.random);
`interop.lm_params` carries them across, so both sides run the same
weights on the same numpy inputs; decode caches are compared leaf by
leaf.

Tolerance: allclose(rtol=1e-4, atol=1e-4) on block outputs, states,
hidden states and logits (the smoke configs compute in float32; the two
sides sum each product in another order, and the chunked forms sum over
chunks in another order than the token recurrences they stand for).
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
from repro.models import vlm as jvlm
from repro.serving import ServeEngine as JEngine
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import hybrid as thy
from repro_torch.models import layers as tl
from repro_torch.models import rwkv as trw
from repro_torch.models import ssm as tssm
from repro_torch.models import vlm as tvlm
from repro_torch.serving import ServeEngine

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def _close_tree(got, want):
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    got = {jax.tree_util.keystr(k): v
           for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert set(got) == {jax.tree_util.keystr(k) for k in want}
    for path, w in want.items():
        g = got[jax.tree_util.keystr(path)]
        assert tuple(g.shape) == tuple(w.shape), path
        _close(g, w)


def smoke(arch: str, **over):
    """The reference's smoke config; zamba2-1.2b with 5 layers, so its
    2-layer groups leave a tail layer (`smoke_config` gives 4, no tail)."""
    cfg = RC.smoke_config(arch)
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, n_layers=5)
    return dataclasses.replace(cfg, **over)


@functools.lru_cache(maxsize=None)
def weights(cfg):
    """(reference params, the port's copy) for one smoke config."""
    jp = jax.jit(japi.build_model(cfg).init)(jax.random.PRNGKey(0))
    return jp, interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, b, t, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(b, t, cfg.d_model)
            * scale).astype(np.float32)


def _tokens(cfg, b, t, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, t)
                                               ).astype(np.int32)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def test_mamba_block_prefill_matches_reference():
    # T = 70 against ssm_chunk 64: the padded second chunk runs
    cfg = smoke("zamba2-1.2b")
    jp, tp = weights(cfg)
    jm = _layer0(_layer0(jp["mamba_groups"]))
    tm = tl.layer_params(tp["mamba_groups"], 0, 0)
    x = _x(cfg, 2, 70, seed=1)
    assert 70 % cfg.ssm_chunk
    want, _ = jssm.mamba_block(jm, jnp.asarray(x), cfg)
    got, state = tssm.mamba_block(tm, torch.as_tensor(x),
                                  interop.arch_config(cfg))
    assert state is None and got.shape == (2, 70, cfg.d_model)
    _close(got, want)


def test_ssd_chunked_with_a_carried_state_matches_reference():
    rng = np.random.RandomState(2)
    b, t, h, p, n = 2, 37, 3, 8, 5
    x = rng.randn(b, t, h, p).astype(np.float32)
    a_log = -rng.rand(b, t, h).astype(np.float32)
    bm, cm = (rng.randn(b, t, n).astype(np.float32) for _ in range(2))
    s0 = rng.randn(b, h, p, n).astype(np.float32)
    want_y, want_s = jssm._ssd_chunked(*map(jnp.asarray, (x, a_log, bm, cm)),
                                       8, init_state=jnp.asarray(s0))
    got_y, got_s = tssm._ssd_chunked(*map(torch.as_tensor,
                                          (x, a_log, bm, cm)), 8,
                                     init_state=torch.as_tensor(s0))
    _close(got_y, want_y)
    _close(got_s, want_s)


def test_mamba_block_state_steps_match_reference():
    # the state branch step by step, states included; its outputs are the
    # prefill's at every position
    cfg = smoke("zamba2-1.2b")
    tcfg = interop.arch_config(cfg)
    jp, tp = weights(cfg)
    jm = _layer0(_layer0(jp["mamba_groups"]))
    tm = tl.layer_params(tp["mamba_groups"], 0, 0)
    x = _x(cfg, 2, 10, seed=3)
    jst = jssm.mamba_init_state(cfg, 2)
    tst = tssm.mamba_init_state(tcfg, 2, device="cpu")
    step = jax.jit(jssm.mamba_block, static_argnames=("cfg",))
    full, _ = tssm.mamba_block(tm, torch.as_tensor(x), tcfg)
    for i in range(10):
        jo, jst = step(jm, jnp.asarray(x[:, i:i + 1]), cfg=cfg, state=jst)
        to, tst = tssm.mamba_block(tm, torch.as_tensor(x[:, i:i + 1]), tcfg,
                                   state=tst)
        _close(to, jo)
        _close_tree(tst, jst)
        _close(to[:, 0], full[:, i])


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["scan", "chunked"])
def test_rwkv_tmix_and_cmix_match_reference(mode):
    cfg = smoke("rwkv6-3b", rwkv_mode=mode)
    tcfg = interop.arch_config(cfg)
    jp, tp = weights(smoke("rwkv6-3b"))
    jlp, tlp = _layer0(jp["layers"]), tl.layer_params(tp["layers"], 0)
    x = _x(cfg, 2, 40, seed=4)            # ssm_chunk 16: 3 chunks, padded
    want, _ = jssm.rwkv_tmix(jlp["tmix"], jnp.asarray(x), cfg)
    got, _ = tssm.rwkv_tmix(tlp["tmix"], torch.as_tensor(x), tcfg)
    _close(got, want)
    want, _ = jssm.rwkv_cmix(jlp["cmix"], jnp.asarray(x), cfg)
    got, _ = tssm.rwkv_cmix(tlp["cmix"], torch.as_tensor(x), tcfg)
    _close(got, want)


@pytest.mark.parametrize("mode", ["scan", "chunked"])
def test_rwkv_smoke_prefill_matches_reference(mode):
    cfg = smoke("rwkv6-3b", rwkv_mode=mode)
    jp, tp = weights(smoke("rwkv6-3b"))
    toks = _tokens(cfg, 2, 37, seed=5)
    tcfg = interop.arch_config(cfg)
    got = trw.rwkv_prefill(tp, tcfg, torch.as_tensor(toks).long())
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, jrw.rwkv_prefill(jp, cfg, jnp.asarray(toks)))
    _close(trw.forward(tp, tcfg, torch.as_tensor(toks).long()),
           jrw.forward(jp, cfg, jnp.asarray(toks)))


def test_rwkv_decode_steps_match_reference():
    # every cache leaf (wkv and x_prev of both mixes) after every step
    cfg = smoke("rwkv6-3b")
    jp, tp = weights(cfg)
    tcfg = interop.arch_config(cfg)
    toks = _tokens(cfg, 2, 12, seed=6)
    jcache = jrw.init_rwkv_cache(cfg, 2, 12)
    tcache = trw.init_rwkv_cache(tcfg, 2, 12, "cpu")
    dec = jax.jit(jrw.rwkv_decode_step, static_argnames=("cfg",))
    for pos in range(12):
        jlg, jcache = dec(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          pos, cfg=cfg)
        tlg, tcache = trw.rwkv_decode_step(
            tp, tcache, torch.as_tensor(toks[:, pos:pos + 1]).long(), pos,
            tcfg)
        _close(tlg, jlg)
        _close_tree(tcache, jcache)


def test_rwkv_chunked_equals_scan_end_to_end():
    # the port's own chunked form against its scan, on prefill logits and
    # hidden states (the reference's test of the same name compares
    # losses)
    cfg = interop.arch_config(smoke("rwkv6-3b"))
    _, tp = weights(smoke("rwkv6-3b"))
    toks = torch.as_tensor(_tokens(cfg, 2, 40, seed=7)).long()
    chunked = dataclasses.replace(cfg, rwkv_mode="chunked", ssm_chunk=16)
    _close(trw.forward(tp, chunked, toks), trw.forward(tp, cfg, toks))
    _close(trw.rwkv_prefill(tp, chunked, toks),
           trw.rwkv_prefill(tp, cfg, toks))


# ---------------------------------------------------------------------------
# the Zamba2 hybrid
# ---------------------------------------------------------------------------

def test_hybrid_smoke_prefill_matches_reference():
    cfg = smoke("zamba2-1.2b")
    jp, tp = weights(cfg)
    toks = _tokens(cfg, 2, 30, seed=8)
    tcfg = interop.arch_config(cfg)
    got = thy.hybrid_prefill(tp, tcfg, torch.as_tensor(toks).long())
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, jhy.hybrid_prefill(jp, cfg, jnp.asarray(toks)))
    _close(thy.forward(tp, tcfg, torch.as_tensor(toks).long()),
           jhy.forward(jp, cfg, jnp.asarray(toks)))


def test_hybrid_decode_steps_match_reference():
    # shared_attn_window 8 under 12 steps: the ring buffers wrap; every
    # cache leaf (Mamba2 states of the groups and the tail, the shared
    # attention's keys and values) after every step
    cfg = smoke("zamba2-1.2b", shared_attn_window=8)
    jp, tp = weights(smoke("zamba2-1.2b"))
    tcfg = interop.arch_config(cfg)
    toks = _tokens(cfg, 2, 12, seed=9)
    jcache = jhy.init_hybrid_cache(cfg, 2, 16)
    tcache = thy.init_hybrid_cache(tcfg, 2, 16, "cpu")
    assert tcache["attn_k"].shape[2] == 8 and "mamba_tail" in tcache
    dec = jax.jit(jhy.hybrid_decode_step, static_argnames=("cfg",))
    for pos in range(12):
        jlg, jcache = dec(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos), cfg=cfg)
        tlg, tcache = thy.hybrid_decode_step(
            tp, tcache, torch.as_tensor(toks[:, pos:pos + 1]).long(), pos,
            tcfg)
        _close(tlg, jlg)
    _close_tree(tcache, jcache)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_port_decode_matches_forward(arch):
    # token-by-token decode reproduces the forward's logits at every
    # position (states, conv buffers, the unwrapped ring buffer)
    rcfg = smoke(arch)
    _, tp = weights(rcfg)
    cfg = interop.arch_config(rcfg)
    bundle = tapi.build_model(cfg)
    mod = trw if arch == "rwkv6-3b" else thy
    toks = torch.as_tensor(_tokens(cfg, 2, 14, seed=10)).long()
    full = tl.lm_logits(tp["embed"], mod.forward(tp, cfg, toks), cfg)
    cache = bundle.init_cache(2, 14, "cpu")
    for pos in range(14):
        lg, cache = bundle.decode(tp, cache, {"tokens": toks[:, pos:pos + 1]},
                                  pos)
        _close(lg[:, 0], full[:, pos])


def test_state_caches_hold_their_own_memory():
    # a decode step writes each layer's state in place: no two layers may
    # share storage (the reference broadcasts one zero state)
    for arch, key in (("rwkv6-3b", ("tmix", "wkv")),
                      ("zamba2-1.2b", ("mamba", "ssm"))):
        cfg = interop.arch_config(smoke(arch))
        cache = tapi.build_model(cfg).init_cache(2, 8, "cpu")
        t = cache[key[0]][key[1]]
        assert t.is_contiguous() and 0 not in t.stride()
        t.view(-1)[0] = 1.0
        assert float(t.sum()) == 1.0


# ---------------------------------------------------------------------------
# the VLM backbone
# ---------------------------------------------------------------------------

def test_vlm_smoke_prefill_and_decode_match_reference():
    cfg = smoke("llava-next-mistral-7b")
    assert cfg.num_patches == 16
    jp, tp = weights(cfg)
    tcfg = interop.arch_config(cfg)
    toks = _tokens(cfg, 2, 24, seed=11)
    patches = _x(cfg, 2, 16, seed=12, scale=0.02)
    want = jvlm.vlm_prefill(jp, cfg, jnp.asarray(toks), jnp.asarray(patches))
    got = tvlm.vlm_prefill(tp, tcfg, torch.as_tensor(toks).long(),
                           torch.as_tensor(patches))
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, want)
    _close(tvlm.splice_embeds(tp, torch.as_tensor(toks).long(),
                              torch.as_tensor(patches), tcfg),
           jvlm.splice_embeds(jp, jnp.asarray(toks), jnp.asarray(patches),
                              cfg))
    # decode: the text-only dense step, through both bundles
    jb, tb = japi.build_model(cfg), tapi.build_model(tcfg)
    jcache, tcache = jb.init_cache(2, 8), tb.init_cache(2, 8, "cpu")
    dec = jax.jit(jb.decode)
    for pos in range(6):
        jlg, jcache = dec(jp, jcache,
                          {"tokens": jnp.asarray(toks[:, pos:pos + 1])},
                          jnp.int32(pos))
        tlg, tcache = tb.decode(
            tp, tcache, {"tokens": torch.as_tensor(toks[:, pos:pos + 1])
                         .long()}, pos)
        _close(tlg, jlg)
    _close_tree(tcache, jcache)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b",
                                  "zamba2-1.2b"])
def test_launcher_serves_the_family(arch, capsys):
    out = tserve.main(["--arch", arch, "--device", "cpu", "--prompt-len",
                       "6", "--max-new", "4", "--batch", "2"])
    vocab = RC.smoke_config(arch).vocab
    assert out.shape == (2, 4) and out.min() >= 0 and out.max() < vocab
    assert "generated (2, 4) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_greedy_tokens_equal_reference(arch):
    cfg = smoke(arch)
    jp, tp = weights(cfg)
    prompts = _tokens(cfg, 2, 7, seed=13)
    want = JEngine(japi.build_model(cfg), jp, max_seq=13,
                   batch_size=2).generate(prompts, 6)
    got = ServeEngine(tapi.build_model(interop.arch_config(cfg)), tp,
                      max_seq=13, batch_size=2, device="cpu"
                      ).generate(prompts, 6)
    np.testing.assert_array_equal(got, want)


def test_llava_fails_in_serve_engine_as_the_reference_does():
    # both engines pass only "tokens": the VLM prefill's patch embeddings
    # are missing on either side
    cfg = smoke("llava-next-mistral-7b")
    jp, tp = weights(cfg)
    prompts = _tokens(cfg, 1, 20, seed=14)
    with pytest.raises(KeyError, match="patch_embeds"):
        JEngine(japi.build_model(cfg), jp, max_seq=24,
                batch_size=1).generate(prompts, 4)
    with pytest.raises(KeyError, match="patch_embeds"):
        ServeEngine(tapi.build_model(interop.arch_config(cfg)), tp,
                    max_seq=24, batch_size=1, device="cpu"
                    ).generate(prompts, 4)
    with pytest.raises(KeyError, match="patch_embeds"):
        tserve.main(["--arch", "llava-next-mistral-7b", "--device", "cpu",
                     "--prompt-len", "20", "--max-new", "4", "--batch",
                     "1"])


def test_family_modules_are_covered_and_default_to_the_card():
    # the import blocker of test_torch_isolation.py walks these modules;
    # their entry points run on the card unless asked for the CPU
    import pkgutil

    import repro_torch
    from repro_torch.configs import smoke_config
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.models.ssm", "repro_torch.models.rwkv",
            "repro_torch.models.hybrid", "repro_torch.models.vlm"} <= names
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for arch in ("granite-moe-1b-a400m", "rwkv6-3b", "zamba2-1.2b",
                 "llava-next-mistral-7b"):
        bundle = tapi.build_model(smoke_config(arch))
        for call in (lambda: bundle.init(0),
                     lambda: bundle.init_cache(1, 4)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
