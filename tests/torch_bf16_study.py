"""Readings behind the bfloat16 limits of the Mamba2 / RWKV6 port, on the
CPU (the reference and the port on the same weights).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_bf16_study.py \\
        [--smoke-seeds 3] [--depth]

Part 1 (smoke): every reading that `tests/test_torch_bf16_families.py`
holds, at `--smoke-seeds` seed offsets: for each check, the largest ratio
rel(port_bf16, ref_bf16) / rel(ref_bf16, ref_f32) over the seeds (the
test holds it <= BLOCK_RATIO for blocks, MODEL_RATIO for models), and the
recurrences' largest relative state and output errors on bf16 inputs
(held elementwise at 1e-4).  Run it with a broken copy of `repro_torch`
first on PYTHONPATH to read a planted fault.

Part 2 (`--depth`): the two-path readings of the served stacks as depth
grows, d_model 512, seed-0 weights, for the reference and the port, at
bf16 and f32 compute: zamba2's prefill logits against a token-by-token
replay of the same 2 x 64 prompt (attn_every 6, ssm_state 64), and
rwkv6's chunked prefill against its scan prefill (2 x 128, chunk 64).
Each line is one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
import test_torch_bf16_families as B
from repro.models import api as japi
from repro_torch import interop
from repro_torch.models import api as tapi


def smoke_part(seeds: int) -> None:
    worst: dict = {}
    for s in range(seeds):
        for check, leaves in B.all_readings(s).items():
            for leaf, (port_ref, ref_err) in leaves.items():
                key = f"{check}/{leaf}".replace("//", "/")
                worst[key] = max(worst.get(key, 0.0), port_ref / ref_err)
    for kind in ("rwkv_scan", "rwkv_chunked", "ssd_chunked"):
        for s in range(seeds):
            args, s0 = B._recurrence_inputs(kind, s)
            (wy, ws), (gy, gs) = B._run_recurrence(kind, args, s0)
            key = f"recurrence/{kind}"
            worst[key + "/state"] = max(worst.get(key + "/state", 0.0),
                                        B.rel(gs, ws))
            worst[key + "/out"] = max(worst.get(key + "/out", 0.0),
                                      B.rel(gy, wy))
    for key, v in worst.items():
        print(json.dumps({"part": "smoke", "seeds": seeds, "check": key,
                          "worst": v}), flush=True)


def _zamba2(n_layers: int, compute: str):
    cfg = RC.smoke_config("zamba2-1.2b")
    return dataclasses.replace(cfg, n_layers=n_layers, d_model=512,
                               n_heads=8, n_kv=8, d_head=64, d_ff=2048,
                               ssm_state=64, attn_every=6,
                               compute_dtype=compute)


def _rwkv6(n_layers: int, compute: str, mode: str = "scan"):
    cfg = RC.smoke_config("rwkv6-3b")
    return dataclasses.replace(cfg, n_layers=n_layers, d_model=512,
                               d_ff=1792, ssm_chunk=64, rwkv_mode=mode,
                               compute_dtype=compute)


def zamba2_replay(n_layers: int, compute: str) -> dict:
    cfg = _zamba2(n_layers, compute)
    jb = japi.build_model(cfg)
    jp = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tcfg = interop.arch_config(cfg)
    tb = tapi.build_model(tcfg)
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 64)).astype(
        np.int32)
    out = {}
    # the reference
    pre = jax.jit(jb.prefill)(jp, {"tokens": jnp.asarray(toks)})
    dec = jax.jit(jb.decode)
    cache = jb.init_cache(2, 64)
    for t in range(64):
        lg, cache = dec(jp, cache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                        jnp.int32(t))
    out["reference"] = B.rel(lg, pre)
    # the port
    tt = torch.as_tensor(toks).long()
    with torch.inference_mode():
        pre = tb.prefill(tp, {"tokens": tt})
        cache = tb.init_cache(2, 64, "cpu")
        for t in range(64):
            lg, cache = tb.decode(tp, cache, {"tokens": tt[:, t:t + 1]}, t)
    out["port"] = B.rel(lg, pre)
    return out


def rwkv6_chunked_vs_scan(n_layers: int, compute: str) -> dict:
    scan, chunked = _rwkv6(n_layers, compute), _rwkv6(n_layers, compute,
                                                      "chunked")
    jp = jax.jit(japi.build_model(scan).init)(jax.random.PRNGKey(0))
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.RandomState(0).randint(0, scan.vocab, (2, 128)).astype(
        np.int32)
    out = {}
    got = [jax.jit(japi.build_model(c).prefill)(
        jp, {"tokens": jnp.asarray(toks)}) for c in (chunked, scan)]
    out["reference"] = B.rel(*got)
    with torch.inference_mode():
        got = [tapi.build_model(interop.arch_config(c)).prefill(
            tp, {"tokens": torch.as_tensor(toks).long()})
            for c in (chunked, scan)]
    out["port"] = B.rel(*got)
    return out


def depth_part() -> None:
    for name, fn, depths in (("zamba2 replay vs prefill", zamba2_replay,
                              (2, 6, 12, 38)),
                             ("rwkv6 chunked vs scan", rwkv6_chunked_vs_scan,
                              (2, 8, 32))):
        for n_layers in depths:
            for compute in ("bfloat16", "float32"):
                t0 = time.perf_counter()
                r = fn(n_layers, compute)
                print(json.dumps({"part": "depth", "reading": name,
                                  "d_model": 512, "n_layers": n_layers,
                                  "compute": compute, **r,
                                  "s": round(time.perf_counter() - t0, 1)}),
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke-seeds", type=int, default=3)
    ap.add_argument("--depth", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    if args.smoke_seeds:
        smoke_part(args.smoke_seeds)
    if args.depth:
        depth_part()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
