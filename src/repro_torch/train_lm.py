"""End-to-end training run: a ~20M-parameter llama-family model (6
layers, d 256) on deterministic data, with checkpointing and resume.

The counterpart of examples/train_lm.py: `Trainer` with AdamW (lr 1e-3,
20 warm-up steps, cosine to `steps`), a batch of 8 x 256 tokens a step
from `batch_for_step`, a checkpoint every steps / 4 steps.  Given a
checkpoint directory that already holds a step, the run resumes from it;
`fail_at` injects a crash at that step (run again to resume).

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 200]   # the card
    PYTHONPATH=src python -m repro_torch.train_lm --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Optional

from repro_torch.configs import smoke_config
from repro_torch.core import resolve_device
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainConfig, Trainer


def config(d_model: int = 256, n_layers: int = 6):
    return dataclasses.replace(smoke_config("llama3.2-3b"),
                               d_model=d_model, n_layers=n_layers,
                               d_ff=4 * d_model, vocab=2048, n_heads=8,
                               n_kv=4, d_head=d_model // 8)


def main(device="cuda", steps: int = 200, seq_len: int = 256,
         batch: int = 8, d_model: int = 256, n_layers: int = 6,
         checkpoint_dir: Optional[str] = None, fail_at: Optional[int] = None,
         log_every: int = 20) -> list[dict]:
    """Train (or resume) and print the log; returns the Trainer's history
    (step, loss, grad_norm, sec)."""
    dev = resolve_device(device)
    cfg = config(d_model, n_layers)
    bundle = build_model(cfg)
    dcfg = DataConfig(cfg.vocab, seq_len=seq_len, global_batch=batch)
    ckpt = checkpoint_dir or tempfile.mkdtemp(prefix="train_lm_ckpt_")
    tc = TrainConfig(steps=steps, checkpoint_every=max(steps // 4, 1),
                     checkpoint_dir=ckpt, log_every=log_every)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    trainer = Trainer(bundle, opt, tc, lambda step: batch_for_step(dcfg,
                                                                   step))
    params, opt_state, start = trainer.init_or_restore(0, dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"params: {n / 1e6:.1f}M  steps: {steps}  start: {start}  "
          f"ckpt: {ckpt}  device: {dev}")
    t0 = time.time()
    trainer.run(params, opt_state, start, fail_at=fail_at)
    dt = time.time() - t0
    for h in trainer.history:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}")
    toks = (steps - start) * dcfg.global_batch * dcfg.seq_len
    if trainer.history:
        print(f"throughput: {toks / dt:,.0f} tok/s  "
              f"(loss {trainer.history[0]['loss']:.3f} -> "
              f"{trainer.history[-1]['loss']:.3f})")
    return trainer.history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=None)
    a = ap.parse_args()
    main(device=a.device, steps=a.steps, checkpoint_dir=a.checkpoint_dir,
         fail_at=a.fail_at)
