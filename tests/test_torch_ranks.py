"""Training and serving on the ranks of a gloo process group (the port's
`train.ranks`, `GroupShards.sum` / `copy`, held experts) against the
reference on a 4-host-device (data 2, model 2) mesh, on the CPU.

The reference runs once a module in a subprocess
(`XLA_FLAGS=--xla_force_host_platform_device_count=4`): smoke granite-moe
with `moe_local_combine`, PRNGKey(0) weights saved as a step-0 checkpoint,
3 steps of its jitted `make_train_step` under `compat.set_mesh` of the
(2, 2) mesh (global batch 4 x 32, a mask with zeros, the clip on), the
step-3 checkpoint; and, with capacity factor 0.5 and no mesh, layer 0's
route of a (64, 16, d) input (a model axis of 2 reported to its
`moe_block`, the route tuple recorded where it reaches
`_ep_local_combine`) and the loss of a 64 x 16 batch.  The ranks run
`tests/torch_ranks.py` (one spawned script a world size, every job of
that size in it, `PYTHONPATH=src` only: no JAX in the ranks), restoring
the reference's checkpoint onto each rank's blocks.

Limits: loss 1e-5 and grad norm 1e-4 relative, the gathered params 1e-4
(the ranks add partials, data terms and blocks' squared norms in another
order than XLA's partitioned program); the stacked (2, 2) run in one
process 1e-6 for loss and grad norm, and for the params after 3 steps
1e-6 or the stacked run's own distance from a one-ulp move of the
params, whichever is larger (AdamW lifts rounding in a near-zero
gradient); routes exactly; the crash resumed exactly.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4                      # tests/test_torch_moe.py's

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import numpy as np
    sys.path.insert(0, "src")
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.checkpoint import save_checkpoint
    from repro.configs import smoke_config
    from repro.models import build_model
    from repro.models import layers as jl
    from repro.optim import AdamWConfig
    from repro.train.loop import TrainConfig, init_opt_state, make_train_step

    d = sys.argv[1]
    raw = np.load(os.path.join(d, "batches.npz"))
    cfg = dataclasses.replace(smoke_config("granite-moe-1b-a400m"),
                              moe_local_combine=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    out = {"losses": [], "grad_norms": []}
    with compat.set_mesh(compat.make_mesh((2, 2), ("data", "model"))):
        bundle = build_model(cfg)
        params = jax.jit(bundle.init)(jax.random.PRNGKey(0))
        state = init_opt_state(bundle, params, opt, TrainConfig())
        save_checkpoint(os.path.join(d, "init"), 0,
                        {"params": params, "opt": state})
        step = make_train_step(bundle, opt, TrainConfig(), donate=False)
        for s in range(3):
            b = {k: jnp.asarray(raw[k + str(s)])
                 for k in ("tokens", "targets", "mask")}
            params, state, m = step(params, state, b)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
        save_checkpoint(os.path.join(d, "final"), 3, {"params": params})

    # a global batch of 64, no mesh: the route of layer 0 and the loss
    r = np.load(os.path.join(d, "route.npz"))
    cf = dataclasses.replace(cfg, moe_local_combine=False,
                             capacity_factor=0.5)
    seen = {}

    def record(oo, xt, gate, route, cap, n_g, d_):
        seen["route"], seen["cap"] = route, cap
        return jnp.zeros((xt.shape[0], n_g, d_), xt.dtype)

    init = jax.jit(bundle.init)(jax.random.PRNGKey(0))
    jl._model_axis_size = lambda: 2
    jl._ep_local_combine = record
    jl.moe_block(jax.tree.map(lambda a: a[0], init["layers"]["ffn"]),
                 jnp.asarray(r["x"]),
                 dataclasses.replace(cf, moe_local_combine=True))
    np.savez(os.path.join(d, "route.ref.npz"), **{
        n: np.asarray(a) for n, a in zip(
            ("sorted_e", "rank", "keep", "tok", "order"), seen["route"])})
    out["route_cap"] = seen["cap"]
    out["route_loss"] = float(jax.jit(build_model(cf).loss)(
        init, {k: jnp.asarray(r[k]) for k in ("tokens", "targets",
                                              "mask")}))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's records, and the directory its checkpoints and the
    shared inputs live in."""
    d = tmp_path_factory.mktemp("ranks")
    rng = np.random.RandomState(11)
    batches = {}
    for s in range(4):
        batches[f"tokens{s}"] = rng.randint(0, 512, (4, 32)).astype(np.int32)
        batches[f"targets{s}"] = rng.randint(0, 512, (4, 32)
                                             ).astype(np.int32)
        batches[f"mask{s}"] = (rng.rand(4, 32) < 0.85).astype(np.float32)
    np.savez(d / "batches.npz", **batches)
    np.savez(d / "route.npz",
             x=rng.randn(64, 16, 128).astype(np.float32),
             tokens=rng.randint(0, 512, (64, 16)).astype(np.int32),
             targets=rng.randint(0, 512, (64, 16)).astype(np.int32),
             mask=(rng.rand(64, 16) < 0.85).astype(np.float32))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(d)],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), d


def _ranks(world: int, jobs, d) -> dict:
    """One spawn of `tests/torch_ranks.py` on `world` ranks running `jobs`
    in `d`: every rank's record of each, by job."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "torch_ranks.py"), str(world),
                          *(f"{job}={d}" for job in jobs)],
                         capture_output=True, text=True, timeout=900,
                         env=env, cwd=str(d))
    assert out.returncode == 0, out.stderr[-3000:]
    return {job: [json.loads((d / f"{job}.{r}.json").read_text())
                  for r in range(world)] for job in jobs}


@pytest.fixture(scope="module")
def recs(ref):
    """Every job's records: one spawn of 4 ranks (training, serving, the
    crash) and one of 2 (the routes)."""
    _, d = ref
    shutil.copytree(d / "init", d / "ck")
    return {**_ranks(4, ("train", "serve", "crash"), d),
            **_ranks(2, ("route",), d)}


def _rel(a, b) -> float:
    return abs(a / b - 1)


def _npy(d, step: int) -> dict:
    path = d / f"step_{step:08d}"
    return {p.name: p.read_bytes() for p in sorted(path.glob("*.npy"))}


def test_training_on_gloo_ranks_matches_the_reference(ref, recs):
    want, d = ref
    recs = recs["train"]
    for rec in recs:
        assert rec["start"] == 0
        assert rec["losses"] == recs[0]["losses"]
        assert rec["grad_norms"] == recs[0]["grad_norms"]
        # E / 2 of the 8 experts a rank, in the params and both moments
        assert all(s[1] == 4 for s in rec["held"].values()), rec["held"]
    got = recs[0]
    assert max(map(_rel, got["losses"], want["losses"])) <= 1e-5
    assert max(map(_rel, got["grad_norms"], want["grad_norms"])) <= 1e-4
    stacked = got["stacked"]
    assert max(map(_rel, got["losses"], stacked["losses"])) <= 1e-6
    assert max(map(_rel, got["grad_norms"], stacked["grad_norms"])) <= 1e-6
    # the ranks split heads, ffn columns and the vocab too: their partial
    # sums round otherwise, which AdamW lifts in a near-zero gradient, as
    # it lifts a one-ulp move of the params in the stacked run
    assert stacked["params_rel"] <= max(1e-6, stacked["control_rel"])
    # the step-3 checkpoint rank 0 wrote from the gathered blocks against
    # the reference's params after step 3
    mine, theirs = d / "ck" / "step_00000003", d / "final" / "step_00000003"
    names = sorted(p.name for p in theirs.glob("*.npy"))
    assert names and all((mine / n).exists() for n in names)
    for n in names:
        a, b = np.load(mine / n), np.load(theirs / n)
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=n)


def test_routing_groups_follow_the_global_batch(ref, recs):
    # 64 rows on 2 data ranks: the reference routes gcd(64, 32) = 32
    # groups of 2 rows; gcd of a rank's 32 rows would give each rank 32
    # groups of 1 row (other capacities, other drops)
    want, d = ref
    recs = recs["route"]
    theirs = np.load(d / "route.ref.npz")
    mine = [np.load(d / f"route.{r}.npz") for r in range(2)]
    assert all(r["cap"] == want["route_cap"] for r in recs)
    for name in ("sorted_e", "rank", "keep", "tok", "order"):
        got = np.concatenate([m[name] for m in mine])
        np.testing.assert_array_equal(got, theirs[name], err_msg=name)
    assert not theirs["keep"].all()
    for r in recs:
        assert _rel(r["loss"], want["route_loss"]) <= 1e-5


def test_ep_serving_on_a_group_equals_the_plain_block(recs):
    recs = recs["serve"]
    for rec in recs:
        assert rec["expert_rows"] == 4
        assert rec["prefill_err"] <= ATOL, rec["prefill_err"]
        assert rec["tokens"]["ep"] == rec["tokens"]["plain"]
        assert np.asarray(rec["tokens"]["ep"]).shape == (4, 10)


def test_trainer_crash_on_ranks_resumes_onto_the_straight_run(ref, recs):
    _, d = ref
    recs = recs["crash"]
    for rec in recs:
        assert rec["failed"] == "injected failure at step 2"
        assert rec["start"] == 2
        assert rec["resumed"] == [[3, rec["straight"][2]],
                                  [4, rec["straight"][3]]]
    # rank 0's Trainer checkpoint, the resumed run's, and a one-call save
    # of the gathered tree: the same files, byte for byte
    straight = _npy(d / "straight", 4)
    assert straight and straight == _npy(d / "one_call", 4)
    assert straight == _npy(d / "crashed", 4)
    manifest = json.loads((d / "straight" / "step_00000004" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["params_layers_ffn_wg"]["shape"][1] == 8
