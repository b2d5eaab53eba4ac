"""The port's training stack (`repro_torch.train`, `data.pipeline`,
`launch.specs`, `launch.train`, the checkpoints of `Trainer`) against the
reference's on the CPU, at llama3.2-3b's smoke size (the reference's own
training tests' setup).

Tolerance of a step against the reference's (relative L2 a leaf):
  * the metrics (loss, grad norm, lr) within 1e-5 at every step;
  * params and moments within 1e-5 after one step (read: 1.6e-6); after
    three within 1e-4 (read: 1.5e-5, the embedding table).  AdamW divides
    each element by its own root second moment, so an element whose
    gradient sums cancelling terms (an embedding row) carries a relative
    error far above its leaf's, and it compounds over steps;
  * with int8 compression a code whose input sits on a rounding boundary
    moves by one quantum (max|g| / 127) on a 1e-7 difference of the
    gradient, between the sent gradient and the error buffer: params
    within 1e-5 after one step (read: 7.4e-9) and 5e-4 after three
    (5.5e-5), moments within 1e-2 (7.6e-4), error buffers within 0.2
    (0.066; a buffer left out or of the wrong sign reads 1 or 2).
Batches are byte-identical.  The reference's five Trainer behaviours
hold as the reference's test holds them (allclose, atol 1e-6), on its
fixtures; on the CPU the crash-restart replay is bit-equal.
"""
import dataclasses
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import pipeline as RP
from repro.launch import specs as RS
from repro.models import api as japi
from repro.optim import AdamWConfig as RAdamW
from repro.train import loop as RL
from repro_torch import interop
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import pipeline as TP
from repro_torch.launch import specs as TS
from repro_torch.models import api as tapi, params_to
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import loop as TL
from torch_lm import rel, weights

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_REL = 1e-5
# (after one step, after three): params, moments, error buffers
STEP_TOL = {False: {"params": (1e-5, 1e-4), "moments": (1e-5, 1e-4)},
            True: {"params": (1e-5, 5e-4), "moments": (1e-2, 1e-2),
                   "ef_error": (0.2, 0.2)}}
ARCH = "llama3.2-3b"
REF_OPT = RAdamW(lr=1e-3, warmup_steps=2, total_steps=100)
OPT = AdamWConfig(**dataclasses.asdict(REF_OPT))


def cfgs():
    cfg = RC.smoke_config(ARCH)
    return cfg, interop.arch_config(cfg)


def port_batch(step: int, batch: int = 2):
    return TS.make_smoke_batch(cfgs()[1], batch, 32, "train", seed=step,
                               device="cpu")


def ref_batch(step: int, batch: int = 2):
    return RS.make_smoke_batch(cfgs()[0], batch, 32, "train", seed=step)


def split(batch: dict, n: int) -> dict:
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def assert_trees_close(got, want, tol=STEP_REL):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for path, g, w in zip(jax.tree_util.tree_leaves_with_path(want), gl,
                          wl):
        assert tuple(g.shape) == tuple(np.shape(w)), path[0]
        assert rel(g, w) <= tol or float(np.abs(np.asarray(w)).max()) == \
            float(g.abs().max()) == 0, (jax.tree_util.keystr(path[0]),
                                        rel(g, w))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ---------------------------------------------------------------------------
# the step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro,compress", [(1, False), (2, False),
                                            (1, True), (2, True)])
def test_train_step_matches_reference(micro, compress):
    cfg, tcfg = cfgs()
    jp, tp = weights(cfg)
    jtc = RL.TrainConfig(microbatches=micro, grad_compression=compress)
    ttc = TL.TrainConfig(microbatches=micro, grad_compression=compress)
    jbundle = japi.build_model(cfg)
    jstep = RL.make_train_step(jbundle, REF_OPT, jtc, donate=False)
    tstep = TL.make_train_step(tapi.build_model(tcfg), OPT, ttc,
                               donate=False)
    jstate = RL.init_opt_state(jbundle, jp, REF_OPT, jtc)
    # the reference's (params, opt_state) cross to the port with their
    # int32 step counter and error buffers
    tstate = interop.lm_params(jax.tree.map(np.asarray, jstate), "cpu")
    own = TL.init_opt_state(None, tp, OPT, ttc)
    assert [(t.shape, t.dtype) for t in tree_leaves(own)] == \
        [(t.shape, t.dtype) for t in tree_leaves(tstate)]
    assert tstate["adamw"]["step"].dtype == torch.int32
    assert ("ef_error" in tstate) == compress
    p0 = {k: v for k, v in tp.items()}
    for step in range(3):
        jb, tb = ref_batch(step, 4), port_batch(step, 4)
        if micro > 1:
            jb, tb = split(jb, micro), split(tb, micro)
        jp, jstate, jm = jstep(jp, jstate, jb)
        tp, tstate, tm = tstep(tp, tstate, tb)
        for key in ("loss", "grad_norm", "lr"):
            assert rel(tm[key], jm[key]) <= STEP_REL, key
        if step in (0, 2):
            tol = {k: v[step // 2] for k, v in STEP_TOL[compress].items()}
            assert_trees_close(tp, jp, tol["params"])
            for key in ("m", "v"):
                assert_trees_close(tstate["adamw"][key],
                                   jstate["adamw"][key], tol["moments"])
            assert int(tstate["adamw"]["step"]) == step + 1
            if compress:
                assert_trees_close(tstate["ef_error"], jstate["ef_error"],
                                   tol["ef_error"])
    # without donate the first params are untouched, and nothing the step
    # returns carries autograd history
    assert _equal(p0, weights(cfg)[1])
    assert not any(t.requires_grad or t.grad_fn is not None
                   for t in tree_leaves(tp) + tree_leaves(tstate)
                   + [tm["loss"]])


def test_donated_step_writes_in_place_and_equals_the_copy():
    cfg, tcfg = cfgs()
    _, tp = weights(cfg)
    bundle = tapi.build_model(tcfg)
    tc = TL.TrainConfig()
    fresh = TL.make_train_step(bundle, OPT, tc, donate=False)
    inplace = TL.make_train_step(bundle, OPT, tc)
    mine = params_to(tp, "cpu")
    mine = tree_map(torch.clone, mine)
    state = TL.init_opt_state(bundle, mine, OPT, tc)
    want, wstate, _ = fresh(tp, TL.init_opt_state(bundle, tp, OPT, tc),
                            port_batch(0))
    got, gstate, _ = inplace(mine, state, port_batch(0))
    assert got["embed"]["tok"] is mine["embed"]["tok"]
    assert gstate["adamw"]["m"]["embed"]["tok"] is \
        state["adamw"]["m"]["embed"]["tok"]
    assert _equal(got, want) and _equal(gstate, wstate)


# ---------------------------------------------------------------------------
# the reference's five Trainer behaviours, in the port
# ---------------------------------------------------------------------------

def _trainer(tc, batch_fn=port_batch, **kw):
    return TL.Trainer(tapi.build_model(cfgs()[1]), OPT, tc, batch_fn, **kw)


def test_crash_restart_replays_exactly(tmp_path):
    tc = TL.TrainConfig(steps=10, checkpoint_every=3,
                        checkpoint_dir=str(tmp_path / "a"), log_every=100)
    tr = _trainer(tc)
    p0, o0, _ = tr.init_or_restore(1, "cpu")
    p_straight, _ = tr.run(p0, o0, 0)

    tc2 = dataclasses.replace(tc, checkpoint_dir=str(tmp_path / "b"))
    tr2 = _trainer(tc2)
    p0, o0, _ = tr2.init_or_restore(1, "cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        tr2.run(p0, o0, 0, fail_at=7)
    tr2.ckpt.wait()
    tr3 = _trainer(tc2)
    p1, o1, start = tr3.init_or_restore(1, "cpu")
    assert start == 6
    p_resumed, _ = tr3.run(p1, o1, start)
    assert all(np.allclose(a.numpy(), b.numpy(), atol=1e-6) for a, b in
               zip(tree_leaves(p_straight), tree_leaves(p_resumed)))
    assert _equal(p_straight, p_resumed)       # on the CPU, bit for bit


def test_straggler_deadline_hook():
    times = iter([0.0, 10.0, 10.0, 10.1, 10.1, 10.2]
                 + [10.2 + i * 0.01 for i in range(50)])
    tr = _trainer(TL.TrainConfig(steps=3, step_deadline_s=1.0,
                                 log_every=100), clock=lambda: next(times))
    p0, o0, _ = tr.init_or_restore(0, "cpu")
    tr.run(p0, o0, 0)
    assert tr.stragglers == [0]


def test_grad_compression_converges():
    tr = _trainer(TL.TrainConfig(steps=6, grad_compression=True,
                                 log_every=1), lambda s: port_batch(0))
    p0, o0, _ = tr.init_or_restore(0, "cpu")
    tr.run(p0, o0, 0)
    losses = [h["loss"] for h in tr.history]
    assert len(losses) == 6 and losses[-1] < losses[0]


def test_microbatch_accumulation_matches_big_batch():
    # the reference test's weights (PRNGKey(2)), carried across.  With the
    # port's own seed-2 weights one element of `wo` reads 5.8e-6 apart:
    # AdamW's first step is ~g / (|g| + eps), and that element's gradient
    # is -2.2e-9, below eps (1e-8)
    cfg, tcfg = cfgs()
    bundle = tapi.build_model(tcfg)
    params = interop.lm_params(jax.tree.map(
        np.asarray, japi.build_model(cfg).init(jax.random.PRNGKey(2))),
        "cpu")
    out = {}
    for micro in (1, 2):
        tc = TL.TrainConfig(microbatches=micro)
        step = TL.make_train_step(bundle, OPT, tc, donate=False)
        batch = port_batch(0, 4) if micro == 1 else split(port_batch(0, 4),
                                                          2)
        out[micro] = step(params, TL.init_opt_state(bundle, params, OPT, tc),
                          batch)
    (p1, _, m1), (p2, _, m2) = out[1], out[2]
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    assert all(np.allclose(a.numpy(), b.numpy(), atol=1e-6)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


def test_restore_onto_another_device(tmp_path):
    params = tapi.build_model(cfgs()[1]).init(0, "cpu")
    save_checkpoint(str(tmp_path), 1, {"params": params})
    # the like tree lies on another device ("meta", no storage): the
    # restore puts every leaf where it is asked to
    like = {"params": params_to(params, "meta")}
    got, _ = restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
    assert _equal(got["params"], params)


# ---------------------------------------------------------------------------
# a reference training checkpoint continues in the port
# ---------------------------------------------------------------------------

def test_reference_checkpoint_continues_in_the_port(tmp_path):
    cfg, tcfg = cfgs()
    ref_dir = tmp_path / "ref"
    ref = lambda steps: RL.Trainer(  # noqa: E731
        japi.build_model(cfg), REF_OPT,
        RL.TrainConfig(steps=steps, checkpoint_every=4, log_every=1,
                       checkpoint_dir=str(ref_dir)), ref_batch)
    tr = ref(4)
    tr.run(*tr.init_or_restore(jax.random.PRNGKey(3)))
    port_dir = tmp_path / "port"
    shutil.copytree(ref_dir, port_dir)
    # the reference continues from its step-4 checkpoint to step 7 ...
    tr = ref(7)
    p, o, start = tr.init_or_restore(jax.random.PRNGKey(3))
    assert start == 4
    tr.run(p, o, start)
    want = [h["loss"] for h in tr.history]
    # ... and so does the port from the same files
    ttr = TL.Trainer(tapi.build_model(tcfg), OPT, TL.TrainConfig(
        steps=7, checkpoint_every=4, log_every=1,
        checkpoint_dir=str(port_dir)), port_batch)
    p, o, start = ttr.init_or_restore(0, "cpu")
    assert start == 4 and int(o["adamw"]["step"]) == 4
    ttr.run(p, o, start)
    got = [h["loss"] for h in ttr.history]
    assert [h["step"] for h in ttr.history] == [5, 6, 7]
    np.testing.assert_allclose(got, want, rtol=STEP_REL)


# ---------------------------------------------------------------------------
# batches and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard", [(0, (0, 1)), (5, (0, 1)),
                                        (7, (1, 2)), (123, (3, 4))])
def test_batch_for_step_is_the_reference_byte_for_byte(step, shard):
    want = RP.batch_for_step(RP.DataConfig(4099, 33, 8, seed=2), step, shard)
    got = TP.batch_for_step(TP.DataConfig(4099, 33, 8, seed=2), step, shard)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    specs = TP.token_batch_specs(TP.DataConfig(4099, 33, 8))
    ref_specs = RP.token_batch_specs(RP.DataConfig(4099, 33, 8))
    assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in specs.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in ref_specs.items()}
    assert TP.make_data_config(5, 4, 2, 1) == TP.DataConfig(5, 4, 2, 1)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b",
                                  "rwkv6-3b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_batches_and_specs_equal_reference(arch, kind):
    cfg = RC.smoke_config(arch)
    tcfg = interop.arch_config(cfg)
    want = RS.make_smoke_batch(cfg, 3, 20, kind, seed=4)
    got = TS.make_smoke_batch(tcfg, 3, 20, kind, seed=4, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    for shape in RC.SHAPES:
        ref_specs = RS.input_specs(cfg, shape)
        specs = TS.input_specs(tcfg, shape)
        assert {k: (tuple(s), str(d).split(".")[-1])
                for k, (s, d) in specs.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in ref_specs.items()}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT), env=env)


def test_launcher_prints_the_reference_lines():
    out = _launch("--arch", ARCH, "--steps", "3", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jax.eval_shape(
        japi.build_model(RC.smoke_config(ARCH)).init,
        jax.random.PRNGKey(0))))
    assert lines[0] == f"arch={ARCH} params={n:,}"
    assert re.fullmatch(r"step     3 loss \d+\.\d{4} gnorm \d+\.\d{3} "
                        r"\d+ms", lines[1]), lines[1]
    assert re.fullmatch(r"done: 3 steps, \d+ tok/s, stragglers=0",
                        lines[2]), lines[2]
    assert len(lines) == 3


def test_launcher_trains_on_the_production_mesh():
    # --mesh: the mesh's shape on a line of its own, then the reference's
    # lines, the losses those of the run without a mesh
    args = ("--arch", ARCH, "--steps", "1", "--device", "cpu")
    out = _launch(*args, "--mesh", "single")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "mesh data=16 model=16 (256 positions stacked on cpu)"
    assert lines[1].startswith(f"arch={ARCH} params=")
    assert re.fullmatch(r"done: 1 steps, \d+ tok/s, stragglers=0",
                        lines[3]), lines[3]
    plain = _launch(*args).stdout.strip().splitlines()
    assert lines[1] == plain[0]
    assert lines[2].split()[:6] == plain[1].split()[:6]    # step, loss, gnorm
