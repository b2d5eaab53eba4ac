"""The port's training steps against the reference's at
granite-moe-1b-a400m's published widths, cut to 2 layers, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_moe_train_study.py \\
        [--layers 2] [--steps 3] [--batch 1] [--seq 128]

Both packages start from the reference's PRNGKey(0) weights (carried
across with `interop.lm_params`) and take `--steps` steps of
`batch_for_step` tokens with `chip_smoke.py`'s training schedule (lr
3e-4, 2 warm-up steps, a cosine to 0 at step 12), at f32 compute and at
the published bf16.  Each line is one JSON object: the step, both losses
and grad norms, and their relative differences.  At f32 they are held to
`tests/test_torch_train.py`'s 1e-5; at bf16 the readings are recorded
beside the reference's own bf16-against-f32 difference (the two packages
round bf16 intermediates at different places).  ~25 s a compute dtype.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
from repro.data import pipeline as RP
from repro.models import api as japi
from repro.optim import AdamWConfig as RAdamW
from repro.train import loop as RL
from repro_torch import interop
from repro_torch.data import pipeline as TP
from repro_torch.models import api as tapi
from repro_torch.optim import AdamWConfig
from repro_torch.train import loop as TL

ARCH = "granite-moe-1b-a400m"
OPT = RAdamW(lr=3e-4, warmup_steps=2, total_steps=12)
F32_TOL = 1e-5


def run(layers: int, steps: int, batch: int, seq: int, compute: str
        ) -> list[dict]:
    cfg = dataclasses.replace(RC.get_config(ARCH), n_layers=layers,
                              compute_dtype=compute)
    jb = japi.build_model(cfg)
    jp = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    topt = AdamWConfig(**dataclasses.asdict(OPT))
    jstep = RL.make_train_step(jb, OPT, RL.TrainConfig(), donate=False)
    tstep = TL.make_train_step(tapi.build_model(interop.arch_config(cfg)),
                               topt, TL.TrainConfig(), donate=False)
    js = RL.init_opt_state(jb, jp, OPT, RL.TrainConfig())
    ts = TL.init_opt_state(None, tp, topt, TL.TrainConfig())
    rows = []
    for step in range(steps):
        raw = RP.batch_for_step(RP.DataConfig(cfg.vocab, seq, batch), step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in raw.items()})
        tp, ts, tm = tstep(tp, ts, TP.batch_for_step(
            TP.DataConfig(cfg.vocab, seq, batch), step))
        rec = {"compute": compute, "step": step + 1}
        for name in ("loss", "grad_norm"):
            ref, port = float(jm[name]), float(tm[name])
            rec.update({f"ref_{name}": ref, f"port_{name}": port,
                        f"rel_{name}": abs(port / ref - 1)})
        rows.append(rec)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args()
    torch.set_num_threads(4)
    by = {}
    for compute in ("float32", "bfloat16"):
        by[compute] = run(args.layers, args.steps, args.batch, args.seq,
                          compute)
        for rec in by[compute]:
            print(json.dumps(rec), flush=True)
    worst = max(max(r["rel_loss"], r["rel_grad_norm"])
                for r in by["float32"])
    ref_bf16 = max(abs(b["ref_loss"] / f["ref_loss"] - 1)
                   for b, f in zip(by["bfloat16"], by["float32"]))
    print(json.dumps({"f32_worst_rel": worst, "f32_limit": F32_TOL,
                      "f32_agree": worst <= F32_TOL,
                      "ref_bf16_vs_f32_loss_rel": ref_bf16}))


if __name__ == "__main__":
    main()
