"""The port's dry runs (`repro_torch.launch.dryrun`, `fvs_dryrun`) against
the reference's, on the meta device.

The reference's dry runs must run in their own process (their module sets
XLA_FLAGS for 512 placeholder devices before JAX starts), so one
subprocess runs them once for the module: `analytic_model_flops` of every live
cell, `lower_cell` of granite-8b decode_32k on the single-pod mesh (the
HLO collective anchor) and of two smoke-overridden cells (a train and a
decode step) on both meshes, and `fvs_dryrun` on a 200,000 x 128 store
(64 queries, 64 leaves searched) with and without `--pallas`, beside its
`abstract_sharded_fvs` shapes.  Held: analytic FLOPs exactly; FLOPs,
`params` and `active_params` of the smoke cells exactly (a train step
after the one-hot term of `op_cost.design_terms`); granite-8b's
all-gather (and all-reduce) within 10 %; the FVS all-gather exactly and
its FLOPs a device exactly after the query projection the port does once
for every shard (see `fvs_dryrun`'s docstring).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, applicable_shapes, get_config, \
    smoke_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import dryrun as D
from repro_torch.launch import fvs_dryrun as F
from repro_torch.launch import op_cost as OC

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE_CELLS = (("granite-8b", "train_4k"), ("granite-moe-1b-a400m",
                                            "decode_32k"))
FVS = dict(n=200_000, dim=128, queries=64, leaves_searched=64)
V5E_PEAK_FLOPS = 197e12     # the reference's record holds seconds at this

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import contextlib, dataclasses, io, json, sys
    sys.path.insert(0, "src")
    from repro.configs import SHAPES, applicable_shapes, get_config, \\
        smoke_config
    from repro.configs.registry import ARCH_IDS
    from repro.launch import dryrun as D
    from repro.launch import fvs_dryrun as F
    from repro.launch.mesh import make_production_mesh

    SMOKE_CELLS, FVS = %(cells)r, %(fvs)r
    out = {"model_flops": {}, "cells": {}, "fvs": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in applicable_shapes(cfg):
            out["model_flops"][arch + "/" + s] = D.analytic_model_flops(
                cfg, SHAPES[s])

    def smoke(arch):
        full, sm = get_config(arch), smoke_config(arch)
        return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
                if getattr(sm, f.name) != getattr(full, f.name)}

    cells = [("granite-8b", "decode_32k", False, None)] + [
        (a, s, mp, smoke(a)) for a, s in SMOKE_CELLS for mp in (False, True)]
    for arch, shape, mp, over in cells:
        rec = D.lower_cell(arch, shape, mp, over)
        key = "/".join((arch, shape, str(int(mp)), str(int(bool(over)))))
        out["cells"][key] = {k: rec[k] for k in (
            "flops_per_device", "collectives", "params", "active_params",
            "chips")}
    sh, meta = F.abstract_sharded_fvs(make_production_mesh(), FVS["n"],
                                      FVS["dim"], 512)
    shapes = {f.name: [list(getattr(sh.index, f.name).shape),
                       str(getattr(sh.index, f.name).dtype)]
              for f in dataclasses.fields(sh.index)
              if hasattr(getattr(sh.index, f.name), "shape")}
    shapes["vectors"] = [list(sh.store.vectors.shape),
                         str(sh.store.vectors.dtype)]
    shapes["norms_sq"] = [list(sh.store.norms_sq.shape),
                          str(sh.store.norms_sq.dtype)]
    out["fvs"]["shapes"], out["fvs"]["words"] = shapes, meta["words"]
    for pallas in (False, True):
        sys.argv = ["fvs_dryrun", "--n", str(FVS["n"]), "--dim",
                    str(FVS["dim"]), "--queries", str(FVS["queries"]),
                    "--leaves-searched", str(FVS["leaves_searched"])] + (
                        ["--pallas"] if pallas else [])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            F.main()
        out["fvs"]["pallas" if pallas else "plain"] = json.loads(
            buf.getvalue())
    print(json.dumps(out))
""")


class _Reference:
    """The reference's dry runs in a subprocess, started at once and read
    when a test first needs them: the port's side of the tests runs
    meanwhile."""

    def __init__(self):
        code = _REFERENCE % {"cells": SMOKE_CELLS, "fvs": FVS}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(ROOT),
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._data = None

    def __getitem__(self, key):
        if self._data is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            self._data = json.loads(out.strip().splitlines()[-1])
        return self._data[key]


@pytest.fixture(scope="module", autouse=True)
def reference():
    ref = _Reference()
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.wait()


def _smoke_overrides(arch):
    full, sm = get_config(arch), smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if getattr(sm, f.name) != getattr(full, f.name)}


CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]


# the port-only tests first: the reference's subprocess runs meanwhile

class _Devices(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


def test_dry_runs_allocate_nothing_off_meta():
    mode = _Devices()
    with mode:
        D.lower_cell("granite-moe-1b-a400m", "train_4k", False,
                     _smoke_overrides("granite-moe-1b-a400m"))
        F.run(**FVS)
    assert mode.seen == {"meta"}


def test_run_all_writes_its_records(tmp_path):
    out = tmp_path / "records.json"
    assert D.run_all(False, str(out), archs=["zamba2-1.2b"],
                     shapes=["long_500k"]) == 0
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["shape"]) for r in recs] == [
        ("zamba2-1.2b", "long_500k")]
    assert D.RECORD.startswith("dryrun_torch")


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_rwkv6_count_is_affine_in_the_length(kind):
    # lower_cell counts RWKV6's train and prefill cells at 16 and 32 tokens
    # and extrapolates: the direct count at another length is the same
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, init_opt_state, \
        make_train_step
    cfg = smoke_config("rwkv6-3b")
    assert D._affine_in_seq(cfg, kind)
    bundle = build_model(cfg)
    p = bundle.init(0, "meta")
    if kind == "train":
        opt = AdamWConfig()
        fn = make_train_step(bundle, opt, TrainConfig(), donate=False)
        args = (p, init_opt_state(bundle, p, opt, TrainConfig()))
        specs = {"tokens": torch.int32, "targets": torch.int32,
                 "mask": torch.float32}
    else:
        fn, args, specs = bundle.prefill, (p,), {"tokens": torch.int32}

    def count(seq):
        counter = OC.CostCounter(fused_kernels=True)
        OC.step_cost(fn, *args, {k: torch.empty((2, seq), dtype=d,
                                                device="meta")
                                 for k, d in specs.items()},
                     counter=counter)
        return counter

    got = D._extrapolate(count(16), count(32), 80)
    want = count(80)
    assert got.by_class == want.by_class
    assert got.total.flops > 0


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_smoke_cells_equal_the_reference(reference, arch, shape, multi_pod):
    over = _smoke_overrides(arch)
    rec = D.lower_cell(arch, shape, multi_pod, over)
    want = reference["cells"][f"{arch}/{shape}/{int(multi_pod)}/1"]
    cfg = dataclasses.replace(get_config(arch), **over)
    spec = SHAPES[shape]
    kind = "grad" if spec.kind == "train" else spec.kind
    terms = OC.design_terms(cfg, kind, spec.global_batch, spec.seq_len)
    assert rec["chips"] == want["chips"] == (512 if multi_pod else 256)
    assert rec["flops_per_device"] * rec["chips"] + sum(terms.values()) \
        == want["flops_per_device"] * want["chips"]
    assert (rec["params"], rec["active_params"]) == (want["params"],
                                                     want["active_params"])
    assert rec["model_flops"] == D.analytic_model_flops(cfg, spec)
    assert rec["roofline"]["dominant"] in rec["roofline"]
    assert rec["memory"]["total_gb"] > 0
    assert rec["constants"]["card"].startswith("NVIDIA H100")


def test_granite_decode_collectives_near_the_reference_hlo(reference):
    rec = D.lower_cell("granite-8b", "decode_32k")
    want = reference["cells"]["granite-8b/decode_32k/0/0"]
    assert rec["flops_per_device"] == want["flops_per_device"]
    for kind in ("all-gather", "all-reduce"):
        assert abs(rec["collectives"][kind] / want["collectives"][kind]
                   - 1) <= 0.10, (rec["collectives"], want["collectives"])
    # the other kinds the reference's HLO holds are recorded, not modelled
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce",
                                       "reduce-scatter"}


def test_fvs_shapes_equal_the_reference(reference):
    from repro_torch.launch.mesh import make_production_mesh
    sh, meta = F.abstract_sharded_fvs(make_production_mesh(), FVS["n"],
                                      FVS["dim"], 512)
    want = dict(reference["fvs"]["shapes"])
    got = {f.name: [list(getattr(sh.index, f.name).shape),
                    str(getattr(sh.index, f.name).dtype)]
           for f in dataclasses.fields(sh.index)
           if isinstance(getattr(sh.index, f.name), torch.Tensor)}
    got["vectors"] = [list(sh.store.vectors.shape), "float32"]
    got["norms_sq"] = [list(sh.store.norms_sq.shape), "float32"]
    extra = got.pop("row_norms_sq")       # the port's own leaf
    assert extra[0] == got["leaf_rowids"][0]
    for name, (shape, dtype) in got.items():
        assert want[name][0] == shape, name
        assert want[name][1] == dtype.replace("torch.", ""), name
    assert meta == {"words": reference["fvs"]["words"]}


@pytest.mark.parametrize("pallas", (False, True))
def test_fvs_dryrun_against_the_reference(reference, pallas):
    rec = F.run(pallas=pallas, **FVS)
    want = reference["fvs"]["pallas" if pallas else "plain"]
    s = 16
    assert rec["collectives"] == want["collectives"] == {
        "all-gather": s * FVS["queries"] * 10 * 8.0}
    # the port projects the queries once for every shard, the reference
    # once a shard: (S - 1) / S of 2 x Q x d x d fewer FLOPs a device
    proj = 2.0 * FVS["queries"] * FVS["dim"] * FVS["dim"]
    got = rec["flops_per_device"] + (s - 1) / s * proj
    ref = want["roofline"]["compute_s"] * V5E_PEAK_FLOPS
    assert abs(got / ref - 1) < 1e-9, (got, ref)
    assert rec["kernel_calls"] == ({"leaf_scan": 1} if pallas else {})
    assert rec["queries_per_s_bound"] > 0
    assert rec["roofline"]["dominant"] == "memory_s"


def test_fvs_default_all_gather_is_the_references():
    # 16 shards x 128 queries x k 10 x (4 + 4) bytes, at the defaults
    # (10M x 768); the count takes seconds on meta
    rec = F.run()
    assert rec["collectives"] == {"all-gather": 163_840.0}
    assert rec["mesh"] == "16x16" and rec["chips"] == 256


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_model_flops_equal_the_reference(reference, arch, shape):
    got = D.analytic_model_flops(get_config(arch), SHAPES[shape])
    assert got == reference["model_flops"][f"{arch}/{shape}"]
