"""The port's model stack (`repro_torch.configs`, `models.layers`,
`models.encoder`, `models.transformer`, `models.api`) against the
reference's, at smoke size on the CPU.  The reference initialises the
weights (jax.random); `interop.lm_params` carries them across, so both
sides run the same weights on the same numpy inputs.

Tolerance: allclose(rtol=1e-4, atol=1e-4) on hidden states and logits of
magnitude ~1: the smoke configs compute in float32, and the two sides sum
each product in another order, through up to 12 layers.
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
from repro.models import encoder as jenc
from repro.models import transformer as jtfm
import repro_torch.configs as TC
from repro_torch import interop
from repro_torch.models import api as tapi
from repro_torch.models import encoder as tenc
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
DENSE = ("granite-8b", "llama3.2-3b", "gemma3-12b")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def smoke(arch: str, **over):
    """The reference's smoke config; gemma3-12b with 12 layers, so its
    grouped 5:1 layout holds two groups (`smoke_config` gives it 2 layers,
    0 groups)."""
    cfg = RC.smoke_config(arch)
    if arch == "gemma3-12b":
        cfg = dataclasses.replace(cfg, n_layers=12)
    return dataclasses.replace(cfg, **over)


@functools.lru_cache(maxsize=None)
def weights(cfg):
    """(reference params, the port's copy) for one smoke config."""
    jp = japi.build_model(cfg).init(jax.random.PRNGKey(0))
    return jp, interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, b, t, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, t)
                                               ).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_registry_matches_reference():
    assert TC.ARCH_IDS == RC.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_every_config_field_matches_reference(arch):
    for get in ("get_config", "smoke_config"):
        want = getattr(RC, get)(arch)
        got = getattr(TC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get
        assert got.head_dim == want.head_dim
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert TC.applicable_shapes(got) == RC.applicable_shapes(want)
        assert interop.arch_config(want) == got


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pallas", [True, False])
def test_hubert_smoke_prefill_matches_reference(pallas):
    cfg = dataclasses.replace(RC.smoke_config("hubert-xlarge"),
                              pallas_flash=pallas)
    jp, tp = weights(cfg)
    frames = np.random.RandomState(3).randn(2, 40, cfg.d_model).astype(
        np.float32)
    # the reference's prefill: the Pallas kernel (interpret mode) when
    # pallas_flash, the blocked jnp attention otherwise
    want = japi.build_model(cfg).prefill(jp, {"frames": jnp.asarray(frames)})
    with torch.inference_mode():
        got = tapi.build_model(interop.arch_config(cfg)).prefill(
            tp, {"frames": torch.as_tensor(frames)})
    assert got.shape == (2, 40, cfg.d_model)
    _close(got, want)


def test_hubert_encode_with_mask_positions_matches_reference():
    cfg = RC.smoke_config("hubert-xlarge")
    jp, tp = weights(cfg)
    rng = np.random.RandomState(4)
    frames = rng.randn(1, 24, cfg.d_model).astype(np.float32)
    mask = rng.rand(1, 24) < 0.3
    want = jenc.encode(jp, jnp.asarray(frames), cfg,
                       mask_positions=jnp.asarray(mask))
    got = tenc.encode(tp, torch.as_tensor(frames), interop.arch_config(cfg),
                      mask_positions=torch.as_tensor(mask))
    _close(got, want)


# ---------------------------------------------------------------------------
# dense decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_prefill_matches_reference(arch):
    cfg = smoke(arch)
    jp, tp = weights(cfg)
    toks = _tokens(cfg, 2, 21)
    want = jtfm.prefill(jp, cfg, tokens=jnp.asarray(toks))
    tcfg = interop.arch_config(cfg)
    got = ttfm.prefill(tp, tcfg, tokens=torch.as_tensor(toks).long())
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, want)
    _close(ttfm.forward(tp, tcfg, tokens=torch.as_tensor(toks).long()),
           jtfm.forward(jp, cfg, tokens=jnp.asarray(toks)))


# window=8 makes gemma3's local ring buffers wrap within the 12 steps
@pytest.mark.parametrize("arch,over", [(a, {}) for a in DENSE]
                         + [("gemma3-12b", {"window": 8})])
def test_dense_smoke_decode_steps_match_reference(arch, over):
    cfg = smoke(arch, **over)
    jp, tp = weights(cfg)
    tcfg = interop.arch_config(cfg)
    b, steps, seq = 2, 12, 16
    toks = _tokens(cfg, b, steps, seed=1)
    jcache = jtfm.init_cache(cfg, b, seq)
    tcache = ttfm.init_cache(tcfg, b, seq, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    dec = jax.jit(jtfm.decode_step, static_argnames=("cfg",))
    for pos in range(steps):
        jl, jcache = dec(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                         jnp.int32(pos), cfg=cfg)
        tl, tcache = ttfm.decode_step(
            tp, tcache, torch.as_tensor(toks[:, pos:pos + 1]).long(), pos,
            tcfg)
        _close(tl, jl)
    for key in jcache:
        _close(tcache[key], jcache[key])


@pytest.mark.parametrize("arch,over", [(a, {}) for a in DENSE]
                         + [("gemma3-12b", {"window": 8})])
def test_port_decode_matches_forward(arch, over):
    # decoding position by position gives the forward pass's logits at
    # every position, ring buffers included
    cfg = interop.arch_config(smoke(arch, **over))
    _, tp = weights(smoke(arch, **over))
    toks = torch.as_tensor(_tokens(cfg, 2, 14, seed=2)).long()
    full = ttfm.lm_logits(tp["embed"], ttfm.forward(tp, cfg, tokens=toks),
                          cfg)
    cache = ttfm.init_cache(cfg, 2, 14, "cpu")
    for pos in range(14):
        lg, cache = ttfm.decode_step(tp, cache, toks[:, pos:pos + 1], pos,
                                     cfg)
        _close(lg[:, 0], full[:, pos])


def test_attention_block_decode_step_matches_reference():
    # attention_block's own cache path: write the step's key and value at
    # pos, attend over the first pos + 1 slots
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    cfg = smoke("granite-8b")
    jp, tp = weights(cfg)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    kc = rng.randn(2, 8, cfg.n_kv, cfg.head_dim).astype(np.float32)
    vc = rng.randn(2, 8, cfg.n_kv, cfg.head_dim).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want, wcache = jl.attention_block(
        jattn, jnp.asarray(x), cfg,
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, pos=jnp.int32(3))
    got, gcache = tl.attention_block(
        tl.layer_params(tp["layers"]["attn"], 0), torch.as_tensor(x),
        interop.arch_config(cfg),
        cache={"k": torch.as_tensor(kc), "v": torch.as_tensor(vc)}, pos=3)
    _close(got, want)
    for key in ("k", "v"):
        _close(gcache[key], wcache[key])


def test_init_shapes_match_reference():
    for arch in DENSE + ("hubert-xlarge",):
        cfg = smoke(arch)
        jp = japi.build_model(cfg).init(jax.random.PRNGKey(1))
        tp = tapi.build_model(interop.arch_config(cfg)).init(1, "cpu")
        want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(jp)}
        got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                         str(v.dtype).split(".")[-1])
               for k, v in jax.tree_util.tree_leaves_with_path(tp)}
        assert got == want, arch


def test_init_is_seeded():
    cfg = interop.arch_config(smoke("granite-8b"))
    bundle = tapi.build_model(cfg)
    a, b = bundle.init(7, "cpu"), bundle.init(7, "cpu")
    c = bundle.init(torch.Generator().manual_seed(8), "cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"],
                           c["layers"]["attn"]["wq"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "rwkv6-3b", "zamba2-1.2b",
                                  "llava-next-mistral-7b"])
def test_other_families_raise_naming_their_roadmap_item(arch):
    cfg = TC.smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP 1.14"):
        tapi.build_model(cfg)


def test_moe_in_the_transformer_and_loss_raise():
    moe = TC.smoke_config("granite-moe-1b-a400m")
    with pytest.raises(NotImplementedError, match="ROADMAP 1.14b"):
        ttfm.init_lm(torch.Generator(), moe)
    bundle = tapi.build_model(TC.smoke_config("granite-8b"))
    with pytest.raises(NotImplementedError, match="ROADMAP 1.14d"):
        bundle.loss({}, {})
