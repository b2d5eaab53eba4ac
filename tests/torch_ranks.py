"""The rank side of `tests/test_torch_ranks.py` and
`tests/test_torch_tp_*.py`: the port on gloo ranks.

    PYTHONPATH=src python tests/torch_ranks.py WORLD JOB=DIR [JOB=DIR ...]

spawns WORLD ranks (`torch.multiprocessing`, gloo, `file://` init in the
first DIR) once; each rank runs the jobs in order and writes
DIR/JOB.<rank>.json (and .npz) for each, the ranks meeting at a barrier
after every job.  Inputs come from DIR: `batches.npz` and the
reference's checkpoints (`init/`, step 0), which the test writes first;
the `tp*` jobs read DIR/job.json (`tests/torch_tp.py`: the config,
overrides and mesh) and the reference's step-0 gradient (`grad0/`).
Imports the port only: no JAX, no reference package.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.optim.adamw import tree_leaves

ARCH = "granite-moe-1b-a400m"
MESH = {"train": (2, 2), "route": (2, 1), "serve": (2, 2), "crash": (2, 2)}


def _cfg(**over):
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(ARCH), **over)


def _mesh(job, stacked=False):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH[job], ("data", "model"))
    return dataclasses.replace(mesh, group=None) if stacked else mesh


def _batches(d):
    raw = np.load(os.path.join(d, "batches.npz"))
    return lambda step: {k: raw[f"{k}{step}"] for k in
                         ("tokens", "targets", "mask")}


def _restored(d, cfg, opt, shardings=None):
    """The reference's step-0 checkpoint (params and AdamW state)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import build_model
    from repro_torch.train.loop import TrainConfig, init_opt_state
    params = build_model(cfg).init(0, "cpu")
    like = {"params": params,
            "opt": init_opt_state(None, params, opt, TrainConfig())}
    tree, _ = restore_checkpoint(os.path.join(d, "init"), 0, like,
                                 shardings=shardings)
    return tree


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))


def _opt(eps: float = 1e-8, lr: float = 1e-3):
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=lr, warmup_steps=1, eps=eps)


TP_EPS = 1e-6                    # tests/torch_tp.py's EPS


def job_train(rank, d):
    """3 AdamW steps through `Trainer` on the ranks of a (2, 2) mesh from
    the reference's step-0 checkpoint (restored onto each rank's blocks);
    the step-3 checkpoint rank 0 writes from the gathered tree; the same
    3 steps with the mesh stacked in one process, and as a control from
    the params moved by one ulp (AdamW lifts a near-zero gradient's
    rounding: the ranks' partial sums of split heads, ffn columns and
    vocab round otherwise than one product)."""
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.ranks import RankLayout
    cfg = _cfg(moe_local_combine=True)
    mesh = _mesh("train")
    batch = _batches(d)
    tr = Trainer(build_model(cfg, mesh), _opt(), TrainConfig(
        steps=3, checkpoint_every=3, checkpoint_dir=os.path.join(d, "ck"),
        log_every=1), batch)
    params, state, start = tr.init_or_restore(0, "cpu")
    adam = state["adamw"]
    held = {f"{tree}/{k}": list(t["layers"]["ffn"][k].shape)
            for tree, t in (("params", params), ("m", adam["m"]),
                            ("v", adam["v"])) for k in ("wg", "wu", "wd")}
    params, state = tr.run(params, state, start)
    gathered = RankLayout(cfg, mesh).gather(params)
    out = {"start": start, "held": held,
           "losses": [h["loss"] for h in tr.history],
           "grad_norms": [h["grad_norm"] for h in tr.history]}
    if rank == 0:
        tree = _restored(d, cfg, _opt())
        step = make_train_step(build_model(cfg, _mesh("train", True)),
                               _opt(), TrainConfig(), donate=False)
        p, s = tree["params"], tree["opt"]
        stacked = {"losses": [], "grad_norms": []}
        for i in range(3):
            p, s, m = step(p, s, batch(i))
            stacked["losses"].append(float(m["loss"]))
            stacked["grad_norms"].append(float(m["grad_norm"]))
        stacked["params_rel"] = max(_rel(a, b) for a, b in zip(
            tree_leaves(gathered), tree_leaves(p)))
        gen = torch.Generator().manual_seed(5)
        q, s = tree_map(lambda t: t * (1 + torch.finfo(t.dtype).eps
                                       * torch.randn(t.shape, generator=gen)),
                        tree["params"]), tree["opt"]
        for i in range(3):
            q, s, _ = step(q, s, batch(i))
        stacked["control_rel"] = max(_rel(a, b) for a, b in zip(
            tree_leaves(q), tree_leaves(p)))
        out["stacked"] = stacked
    return out


def job_route(rank, d):
    """A global batch of 64 on 2 data ranks: layer 0's route of this
    rank's rows of x, and the loss of the whole model (capacity factor
    0.5, so pairs drop)."""
    from repro_torch.models import build_model, layers as tl
    from repro_torch.train.ranks import RankLayout
    cfg = _cfg(capacity_factor=0.5)
    mesh = _mesh("route")
    ranks = RankLayout(cfg, mesh)
    params = ranks.place(_restored(d, cfg, _opt())["params"])
    raw = np.load(os.path.join(d, "route.npz"))
    rows = ranks.batch({"x": raw["x"]})["x"]
    _, _, route, cap = tl.moe_route(
        tl.layer_params(params["layers"]["ffn"], 0), rows, cfg,
        data=tl.data_ranks(mesh))
    np.savez(os.path.join(d, f"route.{rank}.npz"),
             **{n: a.numpy() for n, a in zip(
                 ("sorted_e", "rank", "keep", "tok", "order"), route)})
    batch = ranks.batch({k: raw[k] for k in ("tokens", "targets", "mask")})
    with torch.no_grad():
        loss = build_model(cfg, mesh).loss(params, batch)
    return {"cap": cap, "loss": float(loss)}


def job_serve(rank, d):
    """Prefill and greedy decode with held experts on a (2, 2) group
    against the plain block (no mesh, all experts) on the same weights."""
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.train.ranks import RankLayout
    cfg = _cfg()
    ep = dataclasses.replace(cfg, moe_local_combine=True)
    mesh = _mesh("serve")
    ranks = RankLayout(ep, mesh)
    params = build_model(cfg).init(0, "cpu")
    held = ranks.place(params)
    prompts = np.random.RandomState(4).randint(0, cfg.vocab, (4, 12))
    plain, meshed = build_model(cfg), build_model(ep, mesh)
    mine = ranks.batch({"tokens": prompts})["tokens"]
    with torch.inference_mode():
        want = plain.prefill(params, {"tokens": mine})
        got = meshed.prefill(held, {"tokens": mine})
    tokens = {}
    for name, bundle, p in (("plain", plain, params), ("ep", meshed, held)):
        eng = ServeEngine(bundle, p, max_seq=32, batch_size=4, device="cpu")
        tokens[name] = eng.generate(prompts, 10).tolist()
    return {"prefill_err": float((got - want).abs().max()),
            "expert_rows": int(held["layers"]["ffn"]["wg"].shape[1]),
            "tokens": tokens}


def job_crash(rank, d):
    """4 steps straight, and a crash at step 2 resumed from the step-2
    checkpoint; the straight run's gathered tree also saved in one call
    (rank 0's `save_checkpoint`)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.ranks import RankLayout
    cfg = _cfg(moe_local_combine=True)
    mesh = _mesh("crash")
    batch = _batches(d)

    def trainer(ck, every=2):
        return Trainer(build_model(cfg, mesh), _opt(), TrainConfig(
            steps=4, checkpoint_every=every, log_every=1,
            checkpoint_dir=os.path.join(d, ck)), batch)

    straight = trainer("straight", every=4)
    p, s, _ = straight.init_or_restore(0, "cpu")
    p, s = straight.run(p, s)
    whole = RankLayout(cfg, mesh).gather({"params": p, "opt": s})
    if whole is not None:
        save_checkpoint(os.path.join(d, "one_call"), 4, whole)
    crashed = trainer("crashed")
    p, s, _ = crashed.init_or_restore(0, "cpu")
    try:
        crashed.run(p, s, fail_at=2)
        raise AssertionError("no injected failure")
    except RuntimeError as e:
        failed = str(e)
    if crashed.ckpt:
        crashed.ckpt.wait()
    dist.barrier()
    resumed = trainer("crashed")
    p, s, start = resumed.init_or_restore(0, "cpu")
    resumed.run(p, s, start)
    return {"failed": failed, "start": start,
            "straight": [h["loss"] for h in straight.history],
            "resumed": [(h["step"], h["loss"]) for h in resumed.history]}


def _job(d):
    """The `tp*` jobs' config, mesh, batches (and the raw arrays) and
    AdamW config."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    spec = json.load(open(os.path.join(d, "job.json")))
    cfg = dataclasses.replace(smoke_config(spec["arch"]), **spec["over"])
    raw = np.load(os.path.join(d, "batches.npz"))
    keys = sorted({k.rsplit("_", 1)[0] for k in raw.files} - {"prompts"})
    return (cfg, make_mesh(tuple(spec["mesh"]), ("data", "model")),
            lambda step: {k: raw[f"{k}_{step}"] for k in keys}, raw,
            _opt(TP_EPS, spec["lr"]))


def job_tp(rank, d):
    """The TP / FSDP layout on the ranks of the job's mesh: each rank's
    step-0 gradient (from the reference's step-0 params, restored onto its
    blocks) against its block of the reference's global gradient (the
    largest difference, and the largest relative L2 a leaf); the
    shapes every rank holds against `fit_spec(param_specs)`'s blocks;
    3 AdamW steps through `Trainer` (its step-3 checkpoint rank 0 writes
    from the gathered blocks)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.store import flatten_with_path
    from repro_torch.launch.sharding import (NamedSharding, opt_specs,
                                             param_specs)
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import init_opt_state, value_and_grad
    from repro_torch.train.ranks import RankLayout
    cfg, mesh, batch, _, opt = _job(d)
    ranks = RankLayout(cfg, mesh)
    bundle = build_model(cfg, mesh)
    like = build_model(cfg).init(0, "meta")
    meta = {"params": like,
            "opt": init_opt_state(None, like, opt, TrainConfig())}
    want = {"params": param_specs(cfg, like, mesh),
            "opt": opt_specs(cfg, meta["opt"], None, mesh)}
    tr = Trainer(bundle, opt, TrainConfig(
        steps=3, checkpoint_every=3, checkpoint_dir=os.path.join(d, "ck"),
        log_every=1), batch)
    params, state, start = tr.init_or_restore(0, "cpu")
    coord = np.unravel_index(rank, mesh.devices.shape)
    held = {"params": params, "opt": state}
    shapes_ok = all(
        tuple(leaf.shape) == tuple(s.stop - s.start for s in NamedSharding(
            mesh, spec).slices(glob.shape, coord))
        for (_, leaf), (_, spec), (_, glob) in zip(
            flatten_with_path(held), flatten_with_path(want),
            flatten_with_path(meta)))
    split = sum(tuple(a.shape) != tuple(b.shape) for a, b in zip(
        tree_leaves(params), tree_leaves(like)))
    _, grads = value_and_grad(bundle.loss, params, ranks.batch(batch(0)))
    ranks.reduce(grads)
    ref, _ = restore_checkpoint(os.path.join(d, "grad0"), 0,
                                {"params": build_model(cfg).init(0, "cpu")},
                                shardings=ranks.shardings(
                                    {"params": like}))
    pairs = [(path, a, b) for (path, a), b in zip(
        flatten_with_path(grads), tree_leaves(ref["params"])) if a.numel()]
    grad_err = max(float((a - b).abs().max()) for _, a, b in pairs)
    grad_rels = {path: _rel(a, b) for path, a, b in pairs}
    params, state = tr.run(params, state, start)
    return {"start": start, "shapes_ok": shapes_ok, "split": split,
            "grad_err": grad_err, "grad_rel": max(grad_rels.values()),
            "grad_rels": grad_rels,
            "losses": [h["loss"] for h in tr.history],
            "grad_norms": [h["grad_norm"] for h in tr.history]}


def job_tp_crash(rank, d):
    """On the job's TP / FSDP ranks: the reference's step-0 checkpoint
    restored onto the blocks and saved again by rank 0 from the gathered
    tree; 4 steps straight, and a crash at step 2 resumed from the step-2
    checkpoint."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.ranks import RankLayout
    cfg, mesh, batch, _, opt = _job(d)

    def trainer(ck, every=2):
        return Trainer(build_model(cfg, mesh), opt, TrainConfig(
            steps=4, checkpoint_every=every, log_every=1,
            checkpoint_dir=os.path.join(d, ck)), batch)

    straight = trainer("straight", every=4)
    p, s, start0 = straight.init_or_restore(0, "cpu")
    whole = RankLayout(cfg, mesh).gather({"params": p, "opt": s})
    if whole is not None:
        save_checkpoint(os.path.join(d, "again"), 0, whole)
    p, s = straight.run(p, s)
    crashed = trainer("crashed")
    p, s, _ = crashed.init_or_restore(0, "cpu")
    try:
        crashed.run(p, s, fail_at=2)
        raise AssertionError("no injected failure")
    except RuntimeError as e:
        failed = str(e)
    if crashed.ckpt:
        crashed.ckpt.wait()
    dist.barrier()
    resumed = trainer("crashed")
    p, s, start = resumed.init_or_restore(0, "cpu")
    resumed.run(p, s, start)
    return {"failed": failed, "start0": start0, "start": start,
            "straight": [h["loss"] for h in straight.history],
            "resumed": [(h["step"], h["loss"]) for h in resumed.history]}


def job_tp_serve(rank, d):
    """Greedy tokens of `ServeEngine` on the job's TP ranks from the
    reference's step-0 params (restored onto the blocks), and of the
    one-process engine from the same params."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.train.ranks import RankLayout
    cfg, mesh, _, raw, _ = _job(d)
    ranks = RankLayout(cfg, mesh)
    whole = build_model(cfg).init(0, "cpu")
    params = restore_checkpoint(os.path.join(d, "init"), 0,
                                {"params": whole}, shardings=ranks.shardings(
                                    {"params": whole}))[0]["params"]
    prompts = raw["prompts_0"]
    b = prompts.shape[0]
    got = ServeEngine(build_model(cfg, mesh), params, max_seq=32,
                      batch_size=b, device="cpu").generate(prompts, 10)
    one = restore_checkpoint(os.path.join(d, "init"), 0,
                             {"params": whole})[0]["params"]
    plain = ServeEngine(build_model(cfg), one, max_seq=32, batch_size=b,
                        device="cpu").generate(prompts, 10)
    split = sum(tuple(a.shape) != tuple(c.shape) for a, c in zip(
        tree_leaves(params), tree_leaves(one)))
    return {"tokens": got.tolist(), "plain": plain.tolist(), "split": split}


def job_tp_all(rank, d):
    """`job_tp`, then `job_tp_serve`, in one spawn."""
    return {**job_tp(rank, d), **job_tp_serve(rank, d)}


def job_whole(rank, d):
    """Leaves split over two mesh axes, in one dim each (`tok`: P("model",
    "data"), the experts: P(None, "model", "data", None)), placed on the
    ranks of a (2, 2) mesh and put back together (`RankLayout.whole` on
    every rank, `RankLayout.gather` on rank 0)."""
    from repro_torch.checkpoint.store import flatten_with_path
    from repro_torch.models import build_model
    from repro_torch.train.ranks import RankLayout
    cfg = _cfg(fsdp=True, moe_local_combine=True)
    ranks = RankLayout(cfg, _mesh("train"))
    params = build_model(cfg).init(0, "cpu")
    blocks = ranks.place(params)
    two = sorted(path for path, spec in flatten_with_path(
        ranks.specs(params)) if sum(a is not None for a in spec) == 2)
    back = ranks.whole(blocks)
    gathered = ranks.gather(blocks)
    pairs = zip(tree_leaves(back), tree_leaves(params))
    out = {"two_dim": two, "whole_equal": all(torch.equal(a, b)
                                               for a, b in pairs)}
    if gathered is not None:
        out["gather_equal"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(gathered), tree_leaves(params)))
    return out


def rank_main(rank, world, jobs):
    """One rank: every (job, directory) of `jobs` in order, in one
    process group."""
    torch.set_num_threads(1)
    job, d = jobs[0]
    dist.init_process_group("gloo",
                            init_method=f"file://{d}/pg.{world}.{job}",
                            rank=rank, world_size=world)
    try:
        for job, d in jobs:
            out = globals()[f"job_{job}"](rank, d)
            with open(os.path.join(d, f"{job}.{rank}.json"), "w") as f:
                json.dump(out, f)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world = int(sys.argv[1])
    jobs = [tuple(a.split("=", 1)) for a in sys.argv[2:]]
    mp.spawn(rank_main, args=(world, jobs), nprocs=world, join=True)
