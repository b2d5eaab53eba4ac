"""Training on a mesh (`build_model(cfg, mesh)`, `launch.train --mesh`)
against the one-device step, on the CPU.

The mesh reaches the arithmetic only in the MoE block's EP combine
(`cfg.moe_local_combine` with a `model` axis larger than 1), as the
reference's ambient mesh does.  With the shipped configs (the combine
off) a mesh step is the one-device step bit for bit; with the combine on
a (1, 4) stacked mesh the partial sums change the order of the additions
only, so loss, grads and the forward paths agree within 1e-6 (f32 smoke
weights).  The launcher's crash at step 4 under `--mesh single` resumes
under `--mesh multi` onto the uninterrupted run's losses.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import make_smoke_batch
from repro_torch.models import api
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loop as TL

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
TOL = 1e-6


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.fixture(scope="module")
def smoke():
    cfg = smoke_config(ARCH)
    params = api.build_model(cfg).init(0, "cpu")
    batch = make_smoke_batch(cfg, 4, 32, "train", seed=1, device="cpu")
    return cfg, params, batch


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (1, 8)])
def test_ep_combine_step_equals_the_plain_step(smoke, mesh_shape):
    # 8 experts over a model axis of 2, 4 or 8, stacked: loss and every
    # gradient within TOL of the no-mesh step
    cfg, params, batch = smoke
    ep = dataclasses.replace(cfg, moe_local_combine=True)
    mesh = make_mesh(mesh_shape, ("data", "model"))
    assert mesh.group is None
    lp, gp = TL.value_and_grad(api.build_model(cfg).loss, params, batch)
    le, ge = TL.value_and_grad(api.build_model(ep, mesh).loss, params,
                               batch)
    assert abs(float(le) / float(lp) - 1) <= TOL
    worst = max(_rel(a, b) for a, b in zip(tree_leaves(ge),
                                           tree_leaves(gp)))
    assert worst <= TOL, worst
    # the stacked partials are really there: a model axis of 1 is plain
    one = api.build_model(ep, make_mesh((4, 1), ("data", "model")))
    assert torch.equal(one.loss(params, batch), lp)


def test_ep_combine_reaches_prefill_and_decode(smoke):
    cfg, params, _ = smoke
    ep = dataclasses.replace(cfg, moe_local_combine=True)
    mesh = make_mesh((1, 4), ("data", "model"))
    plain, meshed = api.build_model(cfg), api.build_model(ep, mesh)
    toks = {"tokens": make_smoke_batch(cfg, 2, 12, "prefill", seed=2,
                                       device="cpu")["tokens"]}
    assert _rel(meshed.prefill(params, toks), plain.prefill(params, toks)) \
        <= TOL
    caches = [b.init_cache(2, 12, "cpu") for b in (plain, meshed)]
    for pos in range(3):
        step = {"tokens": toks["tokens"][:, pos:pos + 1]}
        (a, caches[0]), (b, caches[1]) = (
            plain.decode(params, caches[0], step, pos),
            meshed.decode(params, caches[1], step, pos))
        assert _rel(b, a) <= TOL


def test_shipped_config_mesh_step_is_the_one_device_step(smoke):
    # moe_local_combine off (every shipped config): bit for bit
    cfg, params, batch = smoke
    assert not cfg.moe_local_combine
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    runs = []
    for mesh in (None, make_production_mesh()):
        step = TL.make_train_step(api.build_model(cfg, mesh), opt,
                                  TL.TrainConfig(), donate=False)
        p, s = params, TL.init_opt_state(None, params, opt, TL.TrainConfig())
        losses = []
        for _ in range(2):
            p, s, m = step(p, s, batch)
            losses.append(float(m["loss"]))
        runs.append((losses, p))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][1]),
                                                 tree_leaves(runs[1][1])))


def _losses(capsys, *args):
    hist = launch_train.main(["--arch", ARCH, "--steps", "6", "--batch",
                              "2", "--seq", "16", "--device", "cpu",
                              "--log-every", "1", *args])
    return [(h["step"], h["loss"]) for h in hist], \
        capsys.readouterr().out.splitlines()


def test_launcher_crash_under_one_mesh_resumes_under_another(capsys,
                                                             tmp_path):
    straight, _ = _losses(capsys)
    meshed, lines = _losses(capsys, "--mesh", "single")
    assert meshed == straight
    assert lines[0].startswith("mesh data=16 model=16 (256 positions")
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        _losses(capsys, "--mesh", "single", "--checkpoint-dir", ck,
                "--checkpoint-every", "3", "--fail-at", "4")
    assert capsys.readouterr().out.startswith("mesh data=16 model=16")
    resumed, lines = _losses(capsys, "--mesh", "multi", "--checkpoint-dir",
                             ck, "--checkpoint-every", "3")
    assert lines[0].startswith("mesh pod=2 data=16 model=16 (512 positions")
    assert [s for s, _ in resumed] == [4, 5, 6]
    assert all(abs(a - b) <= TOL for (_, a), (_, b) in
               zip(resumed, straight[3:]))
