"""Shared pieces of the tests of the TP / FSDP / SP layouts on ranks
(`tests/test_torch_tp_*.py`): the reference's side, run once a module in
a subprocess on a 4-host-device mesh, and the ranks' side, one spawn of
`tests/torch_ranks.py` a module and world size, which runs every job of
the module on that many ranks (`spawns`).

A job is a directory holding `job.json` ({"arch", "over", "mesh"}: a
smoke config with overrides on a (data, model) mesh) and `batches.npz`
(4 global batches of 4 x 32, `<key>_<step>`).  The reference, under
`compat.set_mesh` of the job's mesh, draws PRNGKey(0) params and saves
them with a zero AdamW state as the step-0 checkpoint (`init/`),
restores them laid out by its `param_specs` / `opt_specs`
(`restore_checkpoint(..., shardings=to_named(...))`), takes 3 steps
(`ref.json`: the losses and grad norms; AdamW with lr 1e-3, one warm-up
step and eps `EPS`) as its `make_train_step` takes them, by
`jax.value_and_grad(bundle.loss)` and `adamw_update`, each jitted on
its own so that the step-0 global gradient (`grad0/`) is the first
step's, and saves the params after them (`final/`).  With
"serve" in `job.json` it writes instead the greedy tokens of its
`ServeEngine` (no mesh) for a (4, 12) prompt, 10 new tokens
(`serve.json`), after the step-0 checkpoint; with "train" too (a job
made with `serve=True, train=True`) it does both.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ, STEPS = 4, 32, 3
# AdamW's eps on both sides: at the default 1e-8 a gradient that cancels
# to the level of rounding (1e-11 and less) is lifted to a step of +-lr
# with a sign that the order of additions picks (smoke granite-moe, one
# element of `tok` in 65,536 1.1e-3 apart after 3 steps); at 1e-6 such a
# gradient moves its weight by less than 1e-5 lr on either side
EPS = 1e-6
PROMPTS, NEW_TOKENS = (4, 12), 10

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import numpy as np
    sys.path.insert(0, "src")
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.checkpoint import restore_checkpoint, save_checkpoint
    from repro.configs import smoke_config
    from repro.launch.sharding import opt_specs, param_specs, to_named
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.optim.adamw import adamw_update
    from repro.serving import ServeEngine
    from repro.train.loop import TrainConfig, init_opt_state

    inits = {}              # PRNGKey(0) params by config: the layout's
                            # fields aside, the same draws whatever the mesh
    LAYOUT = ("fsdp", "sharding_scheme", "moe_local_combine")

    def init_of(bundle, job):
        key = json.dumps([job["arch"], {k: v for k, v in job["over"].items()
                                        if k not in LAYOUT}], sort_keys=True)
        if key not in inits:
            inits[key] = jax.jit(bundle.init)(jax.random.PRNGKey(0))
        return inits[key]

    for d in sys.argv[1:]:
        job = json.load(open(os.path.join(d, "job.json")))
        opt = AdamWConfig(lr=job["lr"], warmup_steps=1, eps=%(eps)g)
        cfg = dataclasses.replace(smoke_config(job["arch"]), **job["over"])
        raw = np.load(os.path.join(d, "batches.npz"))
        keys = sorted({k.rsplit("_", 1)[0] for k in raw.files} - {"prompts"})
        batch = lambda s: {k: jnp.asarray(raw[f"{k}_{s}"]) for k in keys}
        mesh = compat.make_mesh(tuple(job["mesh"]), ("data", "model"))
        out = {"losses": [], "grad_norms": []}
        with compat.set_mesh(mesh):
            bundle = build_model(cfg)
            params = init_of(bundle, job)
            state = init_opt_state(bundle, params, opt, TrainConfig())
            like = {"params": params, "opt": state}
            save_checkpoint(os.path.join(d, "init"), 0, like)
            pspec = param_specs(cfg, params, mesh)
            shd = {"params": to_named(pspec, mesh),
                   "opt": to_named(opt_specs(cfg, state, pspec, mesh), mesh)}
            tree, _ = restore_checkpoint(os.path.join(d, "init"), 0, like,
                                         shardings=shd)
            params, state = tree["params"], tree["opt"]
            if job["train"]:
                # `make_train_step`'s two calls (no compression, one
                # microbatch), compiled apart: the step-0 gradient is the
                # first step's
                grad = jax.jit(jax.value_and_grad(bundle.loss))
                update = jax.jit(lambda p, g, s: adamw_update(p, g, s, opt))
                for s in range(%(steps)d):
                    loss, grads = grad(params, batch(s))
                    if s == 0:
                        save_checkpoint(os.path.join(d, "grad0"), 0,
                                        {"params": grads})
                    params, adam, m = update(params, grads, state["adamw"])
                    state = {"adamw": adam}
                    out["losses"].append(float(loss))
                    out["grad_norms"].append(float(m["grad_norm"]))
                save_checkpoint(os.path.join(d, "final"), %(steps)d,
                                {"params": params})
        json.dump(out, open(os.path.join(d, "ref.json"), "w"))
        if job["serve"]:
            init = init_of(bundle, job)
            prompts = np.asarray(raw["prompts_0"])
            eng = ServeEngine(bundle, init, max_seq=32,
                              batch_size=prompts.shape[0])
            toks = eng.generate(prompts, %(new)d)
            json.dump(np.asarray(toks).tolist(),
                      open(os.path.join(d, "serve.json"), "w"))
""") % {"steps": STEPS, "new": NEW_TOKENS, "eps": EPS}


def make_job(d: pathlib.Path, arch: str, mesh, family: str, seed: int,
             serve: bool = False, lr: float = 1e-3, train: bool = None,
             **over) -> pathlib.Path:
    """Write `d`'s job.json and batches.npz (numpy draws from `seed`; a
    mask with zeros; the VLM's patch embeddings, the encoder's frames and
    masked positions) and return `d`.  A job trains unless it serves;
    `train=True` with `serve=True` does both."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "job.json").write_text(json.dumps(
        {"arch": arch, "over": over, "mesh": list(mesh), "serve": serve,
         "train": not serve if train is None else train, "lr": lr}))
    rng = np.random.RandomState(seed)
    arrays = {}
    for s in range(STEPS + 1):
        targets = rng.randint(0, 32 if family == "encoder" else 512,
                              (BATCH, SEQ)).astype(np.int32)
        arrays[f"targets_{s}"] = targets
        if family == "encoder":
            arrays[f"frames_{s}"] = rng.randn(BATCH, SEQ, 128
                                              ).astype(np.float32)
            arrays[f"mask_positions_{s}"] = rng.rand(BATCH, SEQ) < 0.5
            continue
        arrays[f"tokens_{s}"] = rng.randint(0, 512, (BATCH, SEQ)
                                            ).astype(np.int32)
        arrays[f"mask_{s}"] = (rng.rand(BATCH, SEQ) < 0.85
                               ).astype(np.float32)
        if family == "vlm":
            arrays[f"patch_embeds_{s}"] = (0.02 * rng.randn(
                BATCH, 16, 128)).astype(np.float32)
    if serve:
        arrays["prompts_0"] = rng.randint(0, 512, PROMPTS).astype(np.int32)
    np.savez(d / "batches.npz", **arrays)
    return d


def run_reference(*jobs: pathlib.Path) -> None:
    """The reference's side of every job, in one subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          *map(str, jobs)], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]


def ranks(world: int, jobs) -> dict:
    """`tests/torch_ranks.py WORLD JOB=DIR ...` (gloo ranks, the port
    only), one spawn for every (job, directory) of `jobs`: each one's
    records, every rank's, by (job, directory)."""
    jobs = [(job, pathlib.Path(d)) for job, d in jobs]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "torch_ranks.py"), str(world),
                          *(f"{job}={d}" for job, d in jobs)],
                         capture_output=True, text=True, timeout=900,
                         env=env, cwd=str(jobs[0][1]))
    assert out.returncode == 0, out.stderr[-3000:]
    return {(job, d): [json.loads((d / f"{job}.{r}.json").read_text())
                       for r in range(world)] for job, d in jobs}


def spawns(jobs) -> dict:
    """`ranks` once a world size for (job, directory, world) triples:
    every job's records, by (job, directory)."""
    out = {}
    for world in sorted({w for _, _, w in jobs}):
        out.update(ranks(world, [(job, d) for job, d, w in jobs
                                 if w == world]))
    return out


def rel(a: float, b: float) -> float:
    return abs(a / b - 1)


def files(d: pathlib.Path) -> dict:
    """A checkpoint step directory's leaf files, by name: their bytes."""
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.npy"))}


def final_params_close(d: pathlib.Path) -> None:
    """The params after the 3 steps that rank 0 wrote (`ck/`) within 1e-4
    of the reference's (`final/`), leaf by leaf."""
    mine, theirs = (d / "ck" / f"step_{STEPS:08d}",
                    d / "final" / f"step_{STEPS:08d}")
    names = sorted(p.name for p in theirs.glob("*.npy"))
    assert names and all((mine / n).exists() for n in names)
    for n in names:
        a, b = np.load(mine / n), np.load(theirs / n)
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=n)
