"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Container scale by default (the smoke config); `--full` takes the
assigned config.  The data pipeline is deterministic by step and
checkpoints are preemption-safe: the same invocation resumes after a
failure, on another mesh if asked (`restore_checkpoint` places what it
reads).  `--device` picks the device (the card by default).

`--mesh single|multi` builds the production mesh ((data 16, model 16) or
(pod 2, data 16, model 16)), its positions stacked on the device, and
hands it to the model, as the reference's ambient mesh: the MoE block's
EP combine runs over its `model` axis when the config sets
`moe_local_combine`; every other product is the one-device step's, and
the params and optimizer state are restored without shardings, as the
reference's launcher restores them.  `--checkpoint-every`, `--log-every`
and `--fail-at` (a crash injected before that step, for restart drills)
default to the reference launcher's cadence and to no crash.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import make_smoke_batch
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--mesh", default=None, choices=("single", "multi"),
                    help="train on the single- or multi-pod production "
                    "mesh, its positions stacked on the device (default: "
                    "no mesh)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="steps between checkpoints (default: max(20, "
                    "steps // 5))")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash before this step")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    mesh = None
    if args.mesh:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
        print("mesh " + " ".join(f"{a}={n}" for a, n in mesh.shape.items())
              + f" ({mesh.devices.size} positions stacked on {dev})")
    bundle = build_model(cfg, mesh)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    tc = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every
                     or max(20, args.steps // 5),
                     grad_compression=args.grad_compression,
                     log_every=args.log_every)

    if cfg.family == "encoder":
        def batch_fn(step):
            return make_smoke_batch(cfg, args.batch, args.seq, "train",
                                    seed=step, device=dev)
    else:
        dcfg = DataConfig(cfg.vocab, args.seq, args.batch)

        def batch_fn(step):
            b = batch_for_step(dcfg, step)
            if cfg.family == "vlm":
                rngp = np.random.RandomState(step)
                b["patch_embeds"] = rngp.randn(
                    args.batch, cfg.num_patches, cfg.d_model
                ).astype(np.float32) * 0.02
            return b

    trainer = Trainer(bundle, opt_cfg, tc, batch_fn)
    params, opt_state, start = trainer.init_or_restore(0, dev)
    n_params = sum(int(p.numel()) for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params:,}")
    t0 = time.time()
    try:
        params, opt_state = trainer.run(params, opt_state, start,
                                        fail_at=args.fail_at)
    finally:
        if trainer.ckpt:          # a checkpoint in flight lands first
            trainer.ckpt.wait()
    dt = time.time() - t0
    for h in trainer.history:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f} {h['sec']*1e3:.0f}ms")
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks/dt:.0f} tok/s, "
          f"stragglers={len(trainer.stragglers)}")
    return trainer.history


if __name__ == "__main__":
    main()
