"""Dry run of every (arch x shape) cell on the production meshes, on the
meta device, with roofline terms at the H100's constants.

The counterpart of the reference's `launch/dryrun.py`.  The reference
lowers and compiles each cell for 512 placeholder devices and reads XLA's
numbers; the port has no compiler to ask, so a cell is built abstractly
(the bundle, its meta shape trees, a meta batch, the partition specs of
`launch/sharding.py` on `make_production_mesh`) and the same step the
reference lowers is counted by `op_cost.step_cost` on meta: nothing is
computed or allocated.  Hand kernels are charged as kernels
(`fused_kernels=True`), as the reference's count charges its
`pallas_call`s.  RWKV6's train and prefill cells, a Python loop over
their 4,096 or 32,768 tokens, are counted at 16 and 32 tokens and
extrapolated (`counted_at_seq`): their count is affine in the length,
which `tests/test_torch_dryrun.py` holds.

Record keys are the reference's where they mean the same: FLOPs and
bytes a device are the count over the chips (`dryrun.py:273-274`);
`model_flops` is `analytic_model_flops`, pure arithmetic copied from the
reference; `params` / `active_params` the config's counts.  Added:
`trace_s` (the counted run's wall), `memory` (bytes a position of the
params, optimizer state, cache and batch under their specs:
`sharding.per_position_bytes`, arithmetic, where the reference reads
`memory_analysis`) and `constants` (the card they are for).  Dropped:
XLA's loop-once fields, `lower_s`, `compile_s`.

Collectives.  The reference parses the compiled HLO for each collective's
result shape (`collective_bytes`); there is no HLO here and no twin of
that parser.  The bytes a device come instead from the specs, by this
convention, each term the bytes of the collective's result on one
position:

* all-gather: a leaf whose spec names a batch axis ("pod" / "data": the
  FSDP weights) is gathered over those axes for each use, once in a
  prefill or decode step and twice in a train step (forward, backward):
  its bytes over the model axis's size, the gathered weight held split
  over the model axis whether its spec names it or not (the partitioner
  splits the product's other dim there: granite-8b's `wk` / `wv`,
  replicated over "model" by the GQA rule, read so in the reference's
  HLO);
* reduce-scatter (train): the gradient of such a leaf, its bytes over all
  its axes' sizes;
* all-reduce (train): the gradient of a leaf replicated over the batch
  axes, its bytes over its model axes' sizes;
* all-reduce (activations): a product whose contracted dim is split over
  "model" (the row-parallel `wo`, the MLP's `wv`, `out_proj`, a vocab-split
  embedding's gather) sums its output over the axis: tokens a position x
  its output dim x the compute dtype's bytes, once for each layer the
  leaf stacks (for each group for Zamba2's shared block); in a train step
  also the input gradient of a product whose output dim is split over
  "model" (the column-parallel `wq`, `wk` of the MLP, ...);
* not modelled (absent from `collectives`): the expert-parallel
  dispatch's all-to-all, the collective-permutes XLA may add.

At granite-8b decode_32k on the single-pod mesh this reads an all-gather
within 10 % of the reference's HLO figure (`tests/test_torch_dryrun.py`).

Roofline: compute at the peak of the config's compute dtype (bf16 on the
tensor cores, else FP32), memory at the HBM rate, collectives at one
inter-node link (`repro_torch.hardware`).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --all   # every live cell, one process
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
import time

import torch

from repro_torch import hardware as hw
from repro_torch.checkpoint.store import flatten_with_path
from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (batch_specs, cache_specs, entry_axes,
                                         opt_specs, param_specs,
                                         per_position_bytes)
from repro_torch.launch.specs import input_specs
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainConfig, init_opt_state, \
    make_train_step

BATCH_AXES = ("pod", "data")
RECORD = "dryrun_torch_results.json"


def analytic_model_flops(cfg, shape) -> float:
    """Useful-FLOPs estimate (no remat, no capacity waste): matmul params ×
    6·tokens (train) / 2·tokens (inference) + attention/SSM state terms.
    The reference's arithmetic, term for term."""
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    d, hd = cfg.d_model, cfg.head_dim
    # per-token matmul params, non-embedding (embed lookup is a gather)
    if cfg.family == "ssm":
        per_layer = 4 * d * d + 2 * d * cfg.d_ff + d * LORA_FLOPS_DIM
    else:
        attn_p = d * cfg.n_heads * hd * 2 + d * cfg.n_kv * hd * 2
        if cfg.family == "moe":
            ffn_p = cfg.moe_top_k * 3 * d * cfg.d_ff + d * cfg.n_experts
        else:
            ffn_p = 3 * d * cfg.d_ff
        per_layer = attn_p + ffn_p
        if cfg.family == "hybrid":
            d_in = 2 * d
            mamba_p = d * (2 * d_in + 2 * cfg.ssm_state) + d_in * d
            n_attn = cfg.n_layers // max(cfg.attn_every, 1)
            total_p = cfg.n_layers * mamba_p + n_attn * (
                attn_p + 3 * d * cfg.d_ff)
            per_layer = None
    if cfg.family == "hybrid":
        matmul = total_p
    else:
        matmul = cfg.n_layers * per_layer
    matmul += d * (cfg.num_classes if cfg.family == "encoder" else cfg.vocab)
    flops = mult * matmul * tokens
    # attention context term (scores + pv): fwd = 4·hd·H·ctx per token
    if cfg.family not in ("ssm",):
        ctx_layers = []
        if cfg.family == "hybrid":
            n_attn = cfg.n_layers // max(cfg.attn_every, 1)
            ctx_layers = [("full", n_attn)]
        elif cfg.global_every > 1 and cfg.window > 0:
            g = cfg.n_layers // cfg.global_every
            ctx_layers = [("win", g * (cfg.global_every - 1)), ("full", g)]
        else:
            ctx_layers = [("win" if cfg.window > 0 else "full",
                           cfg.n_layers)]
        t = shape.seq_len
        for kindw, n_l in ctx_layers:
            if shape.kind == "decode":
                ctx = min(cfg.window, t) if (kindw == "win" or (
                    cfg.family == "hybrid" and t > cfg.shared_attn_window)
                ) else t
                if cfg.family == "hybrid":
                    ctx = min(cfg.shared_attn_window, t)
                per_tok = 4 * hd * cfg.n_heads * ctx
            else:
                ctx = min(cfg.window, t) if kindw == "win" else t
                avg = ctx if kindw == "win" else t / 2
                per_tok = 4 * hd * cfg.n_heads * avg
            flops += (3.0 if shape.kind == "train" else 1.0) * \
                n_l * per_tok * tokens
    # SSM state terms
    if cfg.family in ("ssm", "hybrid"):
        if cfg.family == "ssm":
            n_heads = d // 64
            per_tok = 4 * n_heads * 64 * 64          # wkv state update+read
            flops += (3.0 if shape.kind == "train" else 1.0) * \
                cfg.n_layers * per_tok * tokens
        else:
            d_in = 2 * d
            nh = d_in // 64
            per_tok = 4 * nh * 64 * cfg.ssm_state
            flops += (3.0 if shape.kind == "train" else 1.0) * \
                cfg.n_layers * per_tok * tokens
    return float(flops)


LORA_FLOPS_DIM = 2 * 32 * 6   # rwkv ddlerp loras (5 mix + decay)


def spec_collectives(cfg, kind: str, params, pspecs, mesh,
                     tokens_local: int) -> dict[str, float]:
    """Collective bytes a device of one step under the specs, by the
    module docstring's convention."""
    sizes = mesh.shape
    train = kind == "train"
    act = 2 if cfg.compute_dtype == "bfloat16" else 4
    groups = cfg.n_layers // max(cfg.attn_every, 1) \
        if cfg.family == "hybrid" else 1
    model = math.prod(v for k, v in sizes.items() if k not in BATCH_AXES)
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0}
    for (path, leaf), (_, spec) in zip(flatten_with_path(params),
                                       flatten_with_path(pspecs)):
        nbytes = leaf.numel() * leaf.element_size()
        dims = [entry_axes(a) for a in spec] + [()] * (leaf.dim() - len(spec))
        split_b = math.prod(sizes[n] for ns in dims for n in ns
                            if n in BATCH_AXES)
        split_m = math.prod(sizes[n] for ns in dims for n in ns
                            if n not in BATCH_AXES)
        if split_b > 1:
            out["all-gather"] += (2 if train else 1) * nbytes / model
            if train:
                out["reduce-scatter"] += nbytes / (split_b * split_m)
        elif train:
            out["all-reduce"] += nbytes / split_m
        if leaf.dim() < 2 or re.search(r"norm|conv", path):
            continue
        lead = dims[:-2]
        if any(lead):           # an expert dim split over model: EP
            continue
        uses = math.prod(leaf.shape[:-2]) * (
            groups if "shared_" in path else 1)
        d_in, d_out = leaf.shape[-2], leaf.shape[-1]
        if re.search(r"\btok\b", path):     # the embedding's gather
            if "model" in dims[-2]:
                out["all-reduce"] += tokens_local * d_out * act
            continue
        if "model" in dims[-2]:
            out["all-reduce"] += uses * tokens_local * d_out * act
        if train and "model" in dims[-1]:
            out["all-reduce"] += uses * tokens_local * d_in * act
    return {k: v for k, v in out.items() if v}


# RWKV6's token scan is a Python loop over the tokens: its count at T is
# affine in T (every op is per token or independent of T), so a train or
# prefill cell is counted at these two lengths and extrapolated, exactly
LINEAR_SEQS = (16, 32)


def _affine_in_seq(cfg, kind: str) -> bool:
    return cfg.family == "ssm" and cfg.rwkv_mode == "scan" \
        and kind in ("train", "prefill")


def _at_seq(batch: dict, seq: int) -> dict:
    return {k: torch.empty((v.shape[0], seq) + tuple(v.shape[2:]),
                           dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def _extrapolate(c1, c2, seq: int) -> op_cost.CostCounter:
    """The counter at `seq` from those at LINEAR_SEQS, class by class."""
    t1, t2 = LINEAR_SEQS
    m = (seq - t1) // (t2 - t1)
    if (seq - t1) % (t2 - t1):
        raise ValueError(f"sequence {seq} is not on the grid of "
                         f"{LINEAR_SEQS}")
    out = op_cost.CostCounter()
    for cls in set(c1.by_class) | set(c2.by_class):
        a = c1.by_class.get(cls, op_cost.Cost())
        b = c2.by_class.get(cls, op_cost.Cost())
        out.by_class[cls] = op_cost.Cost(a.flops + (b.flops - a.flops) * m,
                                         a.bytes + (b.bytes - a.bytes) * m)
    for kind in set(c1.collectives) | set(c2.collectives):
        a, b = c1.collectives.get(kind, 0.0), c2.collectives.get(kind, 0.0)
        out.collectives[kind] = a + (b - a) * m
    return out


def _meta_batch(cfg, shape_name: str) -> dict:
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in input_specs(cfg, shape_name).items()}


def _tokens_local(batch: dict, bspecs: dict, mesh, kind: str) -> int:
    key = "frames" if "frames" in batch else "tokens"
    leaf, spec = batch[key], bspecs[key]
    split = math.prod(mesh.shape[n] for n in entry_axes(spec[0]))
    t = 1 if kind == "decode" else leaf.shape[1]
    return leaf.shape[0] // split * t


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
               overrides: dict | None = None) -> dict:
    """The dry run's record of one cell (module docstring)."""
    cfg = get_config(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    bundle = build_model(cfg, mesh)
    chips = mesh.devices.size
    t0 = time.time()

    pshape = bundle.init(0, "meta")
    pspec = param_specs(cfg, pshape, mesh)
    batch = _meta_batch(cfg, shape_name)
    bspec = batch_specs(cfg, batch, mesh)
    memory = {"params": per_position_bytes(pshape, pspec, mesh),
              "batch": per_position_bytes(batch, bspec, mesh)}
    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
            else "float32")
        tc = TrainConfig(microbatches=1)
        step = make_train_step(bundle, opt_cfg, tc, donate=False)
        oshape = init_opt_state(bundle, pshape, opt_cfg, tc)
        memory["opt"] = per_position_bytes(
            oshape, opt_specs(cfg, oshape, pspec, mesh), mesh)
        fn, args = step, (pshape, oshape)
    elif shape.kind == "prefill":
        fn, args = (lambda p, b: bundle.prefill(p, b)), (pshape,)
    else:
        cshape = bundle.init_cache(shape.global_batch, shape.seq_len,
                                   "meta")
        memory["cache"] = per_position_bytes(
            cshape, cache_specs(cfg, cshape, mesh), mesh)
        pos = shape.seq_len - 1
        fn = lambda p, c, b: bundle.decode(p, c, b, pos)    # noqa: E731
        args = (pshape, cshape)

    def count(b: dict) -> op_cost.CostCounter:
        counter = op_cost.CostCounter(fused_kernels=True)
        op_cost.step_cost(fn, *args, b, counter=counter)
        return counter

    counted_at = None
    if _affine_in_seq(cfg, shape.kind):
        counted_at = LINEAR_SEQS
        counter = _extrapolate(*(count(_at_seq(batch, t))
                                 for t in LINEAR_SEQS), shape.seq_len)
    else:
        counter = count(batch)
    cost = counter.total
    trace_s = time.time() - t0

    coll = spec_collectives(cfg, shape.kind, pshape, pspec, mesh,
                            _tokens_local(batch, bspec, mesh, shape.kind))
    for kind, b in counter.collectives.items():     # the EP combine's
        coll[kind] = coll.get(kind, 0.0) + b
    flops_dev = cost.flops / chips
    bytes_dev = cost.bytes / chips
    coll_dev = sum(coll.values())
    peak = hw.PEAK_BF16_PER_S if cfg.compute_dtype == "bfloat16" \
        else hw.PEAK_FP32_PER_S
    terms = {"compute_s": flops_dev / peak,
             "memory_s": bytes_dev / hw.PEAK_BYTES_PER_S,
             "collective_s": coll_dev / hw.LINK_BYTES_PER_S}
    model_flops = analytic_model_flops(cfg, shape)
    hlo_flops_total = flops_dev * chips
    memory["total"] = sum(memory.values())
    return {
        "arch": arch_id, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "trace_s": round(trace_s, 3), "counted_at_seq": counted_at,
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev, "collectives": coll,
        "memory": {f"{k}_gb": v / 1e9 for k, v in memory.items()},
        "bytes_by_class": {k: c.bytes for k, c in counter.by_class.items()},
        "roofline": {**terms, "dominant": max(terms, key=terms.get)},
        "model_flops": float(model_flops),
        "hlo_flops_total": float(hlo_flops_total),
        "useful_flops_ratio": float(model_flops / hlo_flops_total)
        if hlo_flops_total else None,
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
        "constants": dict(hw.CONSTANTS, compute_peak="bf16"
                          if cfg.compute_dtype == "bfloat16" else "fp32"),
    }


def run_all(multi_pod: bool, out_path: str, archs=None, shapes=None) -> int:
    """Every live cell in this process (there is no compile to isolate);
    the records written to `out_path` after each cell."""
    fails = 0
    results = []
    for arch in (archs or ARCH_IDS):
        cfg = get_config(arch)
        for shape in (shapes or applicable_shapes(cfg)):
            t0 = time.time()
            try:
                rec = lower_cell(arch, shape, multi_pod)
            except Exception as e:      # recorded, and the sweep fails
                fails += 1
                print(f"FAIL {arch} {shape}: {e!r}"[:600], flush=True)
                results.append({"arch": arch, "shape": shape,
                                "error": repr(e)[:2000]})
            else:
                results.append(rec)
                r = rec["roofline"]
                print(f"OK   {arch:24s} {shape:12s} dom={r['dominant']:12s}"
                      f" comp={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s"
                      f" coll={r['collective_s']:.4f}s"
                      f" ({time.time() - t0:.1f}s)", flush=True)
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    return fails


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=RECORD)
    ap.add_argument("--override", default=None,
                    help="JSON dict of ArchConfig overrides (perf sweeps)")
    args = ap.parse_args(argv)

    if args.all:
        fails = run_all(args.multi_pod, args.out)
        sys.exit(1 if fails else 0)

    overrides = json.loads(args.override) if args.override else None
    rec = lower_cell(args.arch, args.shape, args.multi_pod, overrides)
    print(json.dumps(rec) if args.json else json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
