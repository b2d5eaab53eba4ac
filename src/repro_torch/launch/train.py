"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Container scale by default (the smoke config); `--full` takes the
assigned config.  The data pipeline is deterministic by step and
checkpoints are preemption-safe: the same invocation resumes after a
failure.  `--device` picks the device (the card by default).  Mesh
training (`--mesh`) needs the launcher's partition rules
(`launch/sharding.py`), not ported yet (ROADMAP 1.14e): it is refused.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch.specs import make_smoke_batch
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.loop import TrainConfig, Trainer

MESH_ITEM = ("--mesh: mesh training needs launch/sharding.py's partition "
             "rules, which wait for ROADMAP 1.14e")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--mesh", default=None,
                    help="'single'|'multi' production mesh: refused, "
                    "ROADMAP 1.14e")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error(MESH_ITEM)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    bundle = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    tc = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=max(20, args.steps // 5),
                     grad_compression=args.grad_compression)

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
    params, opt_state = trainer.run(params, opt_state, start)
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
