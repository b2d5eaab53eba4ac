"""The port's MoE family (`models.layers.init_moe` / `moe_route` /
`moe_block` / `_ep_local_combine`, the "moe" branches of
`models.transformer`) against the reference's, at smoke size on the CPU.
The reference initialises the weights (jax.random); `interop.lm_params`
carries them across, bfloat16 leaves included, so both sides run the same
weights on the same numpy inputs.

Tolerance: allclose(rtol=1e-4, atol=1e-4) on block outputs, hidden states
and logits of magnitude ~1 (the smoke configs compute in float32; the two
sides sum each product in another order).  Routing is compared exactly:
the same (token, choice) pairs kept and dropped, in the same order.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.core.collectives import StackedShards
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
MOE = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def smoke(arch: str, **over):
    return dataclasses.replace(RC.smoke_config(arch), **over)


@functools.lru_cache(maxsize=None)
def weights(cfg):
    """(reference params, the port's copy) for one smoke config."""
    jp = jax.jit(japi.build_model(cfg).init)(jax.random.PRNGKey(0))
    return jp, interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _ffn(cfg):
    """Layer 0's MoE params on both sides."""
    jp, tp = weights(cfg)
    return (jax.tree.map(lambda a: a[0], jp["layers"]["ffn"]),
            tl.layer_params(tp["layers"]["ffn"], 0))


def _x(cfg, b, t, seed=0):
    return np.random.RandomState(seed).randn(b, t, cfg.d_model).astype(
        np.float32)


def _tokens(cfg, b, t, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, t)
                                               ).astype(np.int32)


def _reference_route(monkeypatch, jffn, x, cfg):
    """The route tuple the reference's `moe_block` computes: its EP
    combine is reached (a model axis of 2 is reported) and records the
    (sorted_e, rank, keep, tok, order) it is handed."""
    seen = {}

    def record(oo, xt, gate, route, cap, n_g, d):
        seen["route"], seen["cap"] = route, cap
        return jnp.zeros((xt.shape[0], n_g, d), xt.dtype)

    monkeypatch.setattr(jl, "_model_axis_size", lambda: 2)
    monkeypatch.setattr(jl, "_ep_local_combine", record)
    jl.moe_block(jffn, jnp.asarray(x),
                 dataclasses.replace(cfg, moe_local_combine=True))
    return [np.asarray(a) for a in seen["route"]], seen["cap"]


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch, cf):
    # the published capacity factor (1.25), and 0.5 where pairs drop
    cfg = smoke(arch)
    jffn, tffn = _ffn(cfg)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x = _x(cfg, 2, 96, seed=1)
    want = jl.moe_block(jffn, jnp.asarray(x), cfg)
    got = tl.moe_block(tffn, torch.as_tensor(x), interop.arch_config(cfg))
    assert got.shape == (2, 96, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("tie", [False, True])
def test_moe_routing_drops_the_reference_pairs(monkeypatch, tie):
    # capacity 16 a group of 96 tokens x 2 choices over 8 experts (24 a
    # expert on average): drops are certain.  With `tie`, experts 0 and 1
    # share a router column, so every token's probabilities tie exactly
    # and the lower expert must come first, as lax.top_k gives it
    cfg = smoke("granite-moe-1b-a400m", capacity_factor=0.5)
    jffn, tffn = _ffn(smoke("granite-moe-1b-a400m"))
    if tie:
        router = np.asarray(jffn["router"]).copy()
        router[:, 1] = router[:, 0]
        jffn = dict(jffn, router=jnp.asarray(router))
        tffn = dict(tffn, router=torch.as_tensor(router))
    x = _x(cfg, 2, 96, seed=2)
    want, want_cap = _reference_route(monkeypatch, jffn, x, cfg)
    xt, gate, route, cap = tl.moe_route(tffn, torch.as_tensor(x),
                                        interop.arch_config(cfg))
    assert cap == want_cap == 16
    for name, g, w in zip(("sorted_e", "rank", "keep", "tok", "order"),
                          route, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    keep = route[2].numpy()
    assert 0 < (~keep).sum() < keep.size
    # the dropped (token, choice) set
    order = route[4].numpy()
    assert {(int(o) // 2, int(o) % 2) for o in order[~keep]} == \
        {(int(o) // 2, int(o) % 2) for o in want[4][~want[2]]}
    if tie:
        sel = torch.sort(gate, dim=-1, descending=True).values
        assert bool((sel[..., 0] == sel[..., 1]).any())
    # the block's output follows the same route
    _close(tl.moe_block(tffn, torch.as_tensor(x), interop.arch_config(cfg)),
           jl.moe_block(jffn, jnp.asarray(x), cfg))


@pytest.mark.parametrize("shards", [2, 4])
def test_ep_local_combine_equals_plain_combine(shards):
    # the expert axis split into S stacked shards, a partial combine a
    # shard summed by StackedShards.sum, against the plain combine (the
    # reference's whenever its model axis is 1); the block reaches it
    # through a mesh with a `model` axis of S
    cfg = interop.arch_config(smoke("granite-moe-1b-a400m",
                                    capacity_factor=0.5))
    _, tffn = _ffn(smoke("granite-moe-1b-a400m"))
    x = torch.as_tensor(_x(cfg, 4, 48, seed=3))
    plain = tl.moe_block(tffn, x, cfg)
    ep_cfg = dataclasses.replace(cfg, moe_local_combine=True)
    mesh = make_mesh((1, shards), ("data", "model"))
    assert tl._model_axis_size(mesh) == shards
    _close(tl.moe_block(tffn, x, ep_cfg, mesh=mesh), plain)
    # directly, on the block's own expert outputs
    xt, gate, route, cap = tl.moe_route(tffn, x, cfg)
    buf = tl._dispatch(xt, route, cfg.n_experts, cap)
    gg = torch.einsum("gecd,edf->gecf", buf, tffn["wg"])
    uu = torch.einsum("gecd,edf->gecf", buf, tffn["wu"])
    oo = torch.einsum("gecf,efd->gecd", torch.nn.functional.silu(gg) * uu,
                      tffn["wd"])
    ep = tl._ep_local_combine(oo, gate, route, cap, StackedShards(shards))
    _close(ep.reshape(x.shape), plain)
    # no mesh, or a model axis of 1: the plain combine
    assert tl._model_axis_size(None) == 1
    assert torch.equal(tl.moe_block(tffn, x, ep_cfg,
                                    mesh=make_mesh((4,), ("data",))), plain)


_EP_RANKS = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, world, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world)
        try:
            from repro_torch.configs import smoke_config
            from repro_torch.launch.mesh import make_mesh
            from repro_torch.models import api, layers as tl
            cfg = dataclasses.replace(smoke_config("granite-moe-1b-a400m"),
                                      capacity_factor=0.5)
            ffn = tl.layer_params(api.build_model(cfg).init(0, "cpu")
                                  ["layers"]["ffn"], 0)
            x = torch.randn((4, 48, cfg.d_model),
                            generator=torch.Generator().manual_seed(3))
            plain = tl.moe_block(ffn, x, cfg)
            ep_cfg = dataclasses.replace(cfg, moe_local_combine=True)
            mesh = make_mesh((1, world), ("data", "model"))
            stacked = type(mesh)(mesh.devices, mesh.axis_names, None)
            ep = tl.moe_block(ffn, x, ep_cfg, mesh=mesh)
            out = {"group_attached": mesh.group is not None,
                   "err_plain": float((ep - plain).abs().max()),
                   "err_stacked": float((ep - tl.moe_block(
                       ffn, x, ep_cfg, mesh=stacked)).abs().max())}
            if world == 4:
                # a (2, 2) group: each data row's 2 model ranks add their
                # partials; both rows were given the same 4 rows
                out["err_2x2"] = float((tl.moe_block(
                    ffn, x, ep_cfg, mesh=make_mesh((2, 2), ("data", "model")))
                    - plain).abs().max())
            with open(f"{tmp}/rank{rank}.json", "w") as f:
                json.dump(out, f)
            # every rank done with the group before any tears it down
            dist.barrier()
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        world = int(sys.argv[2])
        mp.spawn(rank_main, args=(world, sys.argv[1]), nprocs=world,
                 join=True)
""")


@pytest.mark.parametrize("world", [2, 4])
def test_ep_combine_on_gloo_ranks_equals_plain_combine(tmp_path, world):
    # one rank a model-axis shard of experts: each adds its partial
    # combine and GroupShards.sum all-reduces them over its model ranks,
    # against the plain combine and the stacked emulation in the same
    # process; on a (2, 2) group the sum runs over each data row's model
    # subgroup
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    script = tmp_path / "ranks.py"
    script.write_text(_EP_RANKS)
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp_path),
                          str(world)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in range(world):
        rec = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert rec["group_attached"], rec
        assert rec["err_plain"] <= ATOL and rec["err_stacked"] <= ATOL, rec
        if world == 4:
            assert rec["err_2x2"] <= ATOL, rec


# ---------------------------------------------------------------------------
# the MoE decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_prefill_matches_reference(arch):
    cfg = smoke(arch)
    jp, tp = weights(cfg)
    toks = _tokens(cfg, 2, 21)
    tcfg = interop.arch_config(cfg)
    got = ttfm.prefill(tp, tcfg, tokens=torch.as_tensor(toks).long())
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, jtfm.prefill(jp, cfg, tokens=jnp.asarray(toks)))
    _close(ttfm.forward(tp, tcfg, tokens=torch.as_tensor(toks).long()),
           jtfm.forward(jp, cfg, tokens=jnp.asarray(toks)))


@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_decode_steps_match_reference(arch):
    cfg = smoke(arch)
    jp, tp = weights(cfg)
    tcfg = interop.arch_config(cfg)
    b, steps, seq = 2, 12, 16
    toks = _tokens(cfg, b, steps, seed=1)
    jcache = jtfm.init_cache(cfg, b, seq)
    tcache = ttfm.init_cache(tcfg, b, seq, "cpu")
    dec = jax.jit(jtfm.decode_step, static_argnames=("cfg",))
    for pos in range(steps):
        jlg, jcache = dec(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos), cfg=cfg)
        tlg, tcache = ttfm.decode_step(
            tp, tcache, torch.as_tensor(toks[:, pos:pos + 1]).long(), pos,
            tcfg)
        _close(tlg, jlg)
    assert set(tcache) == set(jcache)
    for key in jcache:
        _close(tcache[key], jcache[key])


@pytest.mark.parametrize("arch", MOE)
def test_port_moe_decode_matches_forward(arch):
    # a one-token decode never drops (cap >= 8) where a prefill may: held
    # against each other at capacity_factor = n_experts, as the
    # reference's own test does
    rcfg = smoke(arch)
    _, tp = weights(rcfg)
    cfg = interop.arch_config(dataclasses.replace(
        rcfg, capacity_factor=float(rcfg.n_experts)))
    toks = torch.as_tensor(_tokens(cfg, 2, 14, seed=2)).long()
    full = ttfm.lm_logits(tp["embed"], ttfm.forward(tp, cfg, tokens=toks),
                          cfg)
    cache = ttfm.init_cache(cfg, 2, 14, "cpu")
    for pos in range(14):
        lg, cache = ttfm.decode_step(tp, cache, toks[:, pos:pos + 1], pos,
                                     cfg)
        _close(lg[:, 0], full[:, pos])


# ---------------------------------------------------------------------------
# bfloat16 weights across
# ---------------------------------------------------------------------------

def test_bf16_params_carry_across_bit_for_bit():
    # kimi-k2 is published with bfloat16 params: every leaf keeps its
    # dtype and its bits
    cfg = smoke("kimi-k2-1t-a32b", param_dtype="bfloat16")
    jp = jax.jit(japi.build_model(cfg).init)(jax.random.PRNGKey(4))
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    want = dict(jax.tree_util.tree_leaves_with_path(jp))
    got = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert set(map(jax.tree_util.keystr, got)) == \
        set(map(jax.tree_util.keystr, want))
    got = {jax.tree_util.keystr(k): v for k, v in got.items()}
    n_bf16 = 0
    for path, w in want.items():
        g = got[jax.tree_util.keystr(path)]
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        if w.dtype.name == "bfloat16":
            n_bf16 += 1
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    assert n_bf16 >= 8
    # the bf16 weights run: the smoke config computes in f32, where each
    # weight widens exactly, so the two prefills agree as in f32
    toks = _tokens(cfg, 1, 9, seed=5)
    got = ttfm.prefill(tp, interop.arch_config(cfg),
                       tokens=torch.as_tensor(toks).long())
    _close(got, jtfm.prefill(jp, cfg, tokens=jnp.asarray(toks)))
