"""The port's partition rules (`repro_torch.launch.sharding`) and shape
trees against the reference's, at the published shapes of every
architecture, and the placement of a checkpoint's leaves on a mesh.

Specs are compared exactly, as tuples of axis entries: for every leaf of
the params, the AdamW state (with and without the int8 error buffers),
the batch of every applicable shape (with and without `shard_seq`) and
the decode cache, on both production meshes and a (4, 8) mesh (the
reference's side on a stand-in mesh with the same names and shape, as
its own rule tests use).  Shape trees come from `bundle.init(0, "meta")`
and equal `jax.eval_shape`'s path for path.  A checkpoint the reference
wrote restores through `shardings=` to the file's values: whole on a
stacked mesh, and in blocks that `gather` puts back together on 2 gloo
ranks.
"""
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch import sharding as RSH
from repro.launch import specs as RS
from repro.models import api as japi
from repro.optim import AdamWConfig as RAdamW
from repro.train import loop as RL
from repro_torch import interop
from repro_torch.checkpoint import leaf_paths, restore_checkpoint
from repro_torch.checkpoint.store import flatten_with_path, unflatten
from repro_torch.configs.base import applicable_shapes
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import api as tapi
from repro_torch.optim import AdamWConfig
from repro_torch.train import loop as TL

MESHES = {"single": lambda: make_production_mesh(),
          "multi": lambda: make_production_mesh(multi_pod=True),
          "4x8": lambda: make_mesh((4, 8), ("data", "model"))}
CACHE_BATCH, CACHE_SEQ = 128, 4096


def fake_mesh(mesh):
    """The reference's side of `mesh`: its axis names and shape, which is
    all the reference's rules read."""
    class Devices:
        shape = mesh.devices.shape

    class Fake:
        axis_names = mesh.axis_names
        devices = Devices
    return Fake()


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference, port) shape trees of `arch` at its published config:
    params, AdamW state without and with error buffers, the decode cache
    (None for the encoder) and each applicable shape's batch."""
    cfg = RC.get_config(arch)
    jb = japi.build_model(cfg)
    tb = tapi.build_model(interop.arch_config(cfg))
    jp = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    tp = tb.init(0, "meta")
    ref, port = {"params": jp}, {"params": tp}
    for gc in (False, True):
        ref[f"opt{int(gc)}"] = jax.eval_shape(lambda p: RL.init_opt_state(
            jb, p, RAdamW(), RL.TrainConfig(grad_compression=gc)), jp)
        port[f"opt{int(gc)}"] = TL.init_opt_state(
            tb, tp, AdamWConfig(), TL.TrainConfig(grad_compression=gc))
    ref["cache"] = port["cache"] = None
    if jb.init_cache is not None:
        ref["cache"] = jax.eval_shape(
            lambda: jb.init_cache(CACHE_BATCH, CACHE_SEQ))
        port["cache"] = tb.init_cache(CACHE_BATCH, CACHE_SEQ, "meta")
    tcfg = interop.arch_config(cfg)
    for shape in applicable_shapes(tcfg):
        ref[shape] = RS.input_specs(cfg, shape)
        port[shape] = {k: torch.empty(s, dtype=d, device="meta")
                       for k, (s, d) in input_specs(tcfg, shape).items()}
    return cfg, tcfg, ref, port


def ref_flat(tree):
    return [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_flat(tree):
    return [(p, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in flatten_with_path(tree)]


def ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, RSH.P))]


def port_specs(tree):
    return [tuple(s) for _, s in flatten_with_path(tree)]


def assert_divides(shapes, specs, mesh):
    sizes = mesh.shape
    for (path, leaf), (_, spec) in zip(flatten_with_path(shapes),
                                       flatten_with_path(specs)):
        assert len(spec) == leaf.dim(), (path, spec)
        for dim, ax in zip(leaf.shape, spec):
            names = () if ax is None else (ax if isinstance(ax, tuple)
                                           else (ax,))
            prod = int(np.prod([sizes[a] for a in names]))
            assert dim % prod == 0, (path, spec, tuple(leaf.shape))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_shape_trees_equal_eval_shape_and_allocate_nothing(arch):
    _, _, ref, port = trees(arch)
    for part in ("params", "opt0", "opt1", "cache"):
        if ref[part] is None:
            continue
        assert port_flat(port[part]) == ref_flat(ref[part]), part
        assert all(t.is_meta for _, t in flatten_with_path(port[part]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_specs_equal_reference(arch, mesh_name):
    cfg, tcfg, ref, port = trees(arch)
    mesh = MESHES[mesh_name]()
    fake = fake_mesh(mesh)
    pspec = SH.param_specs(tcfg, port["params"], mesh)
    assert port_specs(pspec) == ref_specs(
        RSH.param_specs(cfg, ref["params"], fake))
    assert_divides(port["params"], pspec, mesh)
    for part in ("opt0", "opt1"):
        got = SH.opt_specs(tcfg, port[part], pspec, mesh)
        assert port_specs(got) == ref_specs(RSH.opt_specs(
            cfg, ref[part], None, fake)), part
        assert_divides(port[part], got, mesh)
    for shape in applicable_shapes(tcfg):
        for seq in (False, True):
            got = SH.batch_specs(tcfg, port[shape], mesh, shard_seq=seq)
            assert port_specs(got) == ref_specs(RSH.batch_specs(
                cfg, ref[shape], fake, shard_seq=seq)), (shape, seq)
            assert_divides(port[shape], got, mesh)
    if ref["cache"] is not None:
        got = SH.cache_specs(tcfg, port["cache"], mesh)
        assert port_specs(got) == ref_specs(RSH.cache_specs(
            cfg, ref["cache"], fake))
        assert_divides(port["cache"], got, mesh)
    named = SH.to_named(pspec, mesh)
    assert all(isinstance(s, SH.NamedSharding) and s.mesh is mesh
               for _, s in flatten_with_path(named))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_unfitted_specs_equal_reference(arch):
    # no mesh: the rules' templates as they are, padded to each leaf
    cfg, tcfg, ref, port = trees(arch)
    pspec = SH.param_specs(tcfg, port["params"])
    assert port_specs(pspec) == ref_specs(
        RSH.param_specs(cfg, ref["params"]))
    assert port_specs(SH.opt_specs(tcfg, port["opt1"], pspec)) == \
        ref_specs(RSH.opt_specs(cfg, ref["opt1"], None))


class FakeMesh:
    axis_names = ("data", "model")

    class devices:
        shape = (4, 8)


# tests/test_distributed.py's fit_spec cases
@pytest.mark.parametrize("spec,shape,want", [
    (("model", None), (16, 4), ("model", None)),
    (("model", None), (17, 4), (None, None)),
    ((("data", "model"),), (32,), (("data", "model"),)),
    ((("data", "model"),), (4,), ("data",)),
    (("bogus",), (8,), (None,)),
])
def test_fit_spec_divisibility(spec, shape, want):
    got = SH.fit_spec(SH.P(*spec), shape, FakeMesh())
    assert got == SH.P(*want) and tuple(got) == want
    assert tuple(RSH.fit_spec(RSH.P(*spec), shape, FakeMesh())) == want


def test_partition_spec_is_tuple_like():
    s = SH.P("data", ["pod", "data"], None)
    assert tuple(s) == ("data", ("pod", "data"), None) and len(s) == 3
    assert s[1] == ("pod", "data") and s == SH.P("data", ("pod", "data"),
                                                  None)
    assert hash(s) == hash(SH.P(*tuple(s))) and SH.P() == ()


@pytest.mark.parametrize("spec", [(None, None), ("model", None),
                                  ("data", "model"), (("data", "model"),
                                                      None),
                                  (None, ("model", "data"))])
def test_blocks_gather_back_to_the_value(spec):
    # every position's block of a (2, 4) mesh, put back together
    mesh = make_mesh((2, 4), ("data", "model"))
    value = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    shd = SH.NamedSharding(mesh, SH.P(*spec))
    blocks = [value[shd.slices(value.shape, np.unravel_index(r, (2, 4)))]
              for r in range(8)]
    assert torch.equal(SH.gather(blocks, shd), value)
    split = [value.shape[i] // blocks[0].shape[i] for i in range(2)]
    want = [int(np.prod([mesh.shape[n] for n in
                         (() if a is None else (a if isinstance(a, tuple)
                                                else (a,)))]))
            for a in spec]
    assert split == want
    if max(split) > 1:          # an uneven split is refused
        with pytest.raises(ValueError, match="does not split"):
            shd.slices((15, 23), (0, 0))


def test_per_position_bytes_is_the_split_arithmetic():
    cfg, tcfg, _, port = trees("granite-moe-1b-a400m")
    mesh = MESHES["single"]()
    pspec = SH.param_specs(tcfg, port["params"], mesh)
    whole = sum(t.numel() * t.element_size()
                for _, t in flatten_with_path(port["params"]))
    got = SH.per_position_bytes(port["params"], pspec, mesh)
    # experts, the embedding and q / o split 16 ways; norms, router and
    # the kv projections stay whole
    assert whole / 16 < got < whole / 2
    leaves = flatten_with_path(port["params"])
    whole_specs = unflatten(port["params"], [SH.P()] * len(leaves))
    assert SH.per_position_bytes(port["params"], whole_specs, mesh) == whole


# ---------------------------------------------------------------------------
# placement of a checkpoint the reference wrote
# ---------------------------------------------------------------------------

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def ref_checkpoint(tmp_path_factory):
    """The reference's smoke params and AdamW state after one step, as its
    Trainer writes them, and the port's like-tree."""
    cfg = RC.smoke_config(ARCH)
    d = tmp_path_factory.mktemp("ref_ckpt")
    jb = japi.build_model(cfg)
    tr = RL.Trainer(jb, RAdamW(lr=1e-3, warmup_steps=1), RL.TrainConfig(
        steps=1, checkpoint_dir=str(d), log_every=1),
        lambda s: RS.make_smoke_batch(cfg, 2, 16, "train", seed=s))
    tr.run(*tr.init_or_restore(jax.random.PRNGKey(0))[:2])
    tcfg = interop.arch_config(cfg)
    tb = tapi.build_model(tcfg)
    tp = tb.init(0, "meta")
    like = {"params": tp, "opt": TL.init_opt_state(tb, tp, AdamWConfig(),
                                                  TL.TrainConfig())}
    return str(d), cfg, tcfg, like


def _file_values(d):
    path = pathlib.Path(d) / "step_00000001"
    return {p.stem: np.load(p) for p in path.glob("*.npy")}


def _shardings(tcfg, like, mesh):
    pspec = SH.param_specs(tcfg, like["params"], mesh)
    return {"params": SH.to_named(pspec, mesh),
            "opt": SH.to_named(SH.opt_specs(tcfg, like["opt"], pspec,
                                            mesh), mesh)}


def test_restore_with_shardings_on_a_stacked_mesh(ref_checkpoint):
    d, _, tcfg, like = ref_checkpoint
    mesh = make_mesh((1, 4), ("data", "model"))
    tree, _ = restore_checkpoint(d, 1, like,
                                 shardings=_shardings(tcfg, like, mesh))
    files = _file_values(d)
    got = leaf_paths(tree)
    assert len(got) == len(files)
    for name, t in got:
        assert t.device.type == "cpu" and not t.is_meta
        assert np.array_equal(t.numpy(), files[name]), name
    # a device leaf, a None subtree and a single placement over a subtree
    mixed = {"params": torch.device("cpu"), "opt": None}
    tree2, _ = restore_checkpoint(d, 1, like, device="cpu",
                                  shardings=mixed)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaf_paths(tree2), got))


def test_trainer_passes_shardings_through(ref_checkpoint, tmp_path):
    d, _, tcfg, like = ref_checkpoint
    shutil.copytree(d, tmp_path / "ck")
    mesh = make_mesh((2, 2), ("data", "model"))
    tr = TL.Trainer(tapi.build_model(tcfg), AdamWConfig(), TL.TrainConfig(
        steps=1, checkpoint_dir=str(tmp_path / "ck")), lambda s: {})
    seen = {}
    real = TL.restore_checkpoint

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)
    shd = _shardings(tcfg, like, mesh)
    TL.restore_checkpoint = spy
    try:
        params, state, start = tr.init_or_restore(0, "cpu", shardings=shd)
    finally:
        TL.restore_checkpoint = real
    assert start == 1 and seen["shardings"] is shd
    files = _file_values(d)
    assert np.array_equal(params["embed"]["tok"].numpy(),
                          files["params_embed_tok"])


_RANKS = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, world, tmp, ckpt):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world)
        try:
            from repro_torch.checkpoint import leaf_paths, restore_checkpoint
            from repro_torch.configs import smoke_config
            from repro_torch.launch import sharding as SH
            from repro_torch.launch.mesh import make_mesh
            from repro_torch.models import api
            from repro_torch.optim import AdamWConfig
            from repro_torch.train import loop as TL
            cfg = smoke_config("granite-moe-1b-a400m")
            bundle = api.build_model(cfg)
            tp = bundle.init(0, "meta")
            like = {"params": tp, "opt": TL.init_opt_state(
                bundle, tp, AdamWConfig(), TL.TrainConfig())}
            mesh = make_mesh((1, world), ("data", "model"))
            pspec = SH.param_specs(cfg, tp, mesh)
            shd = {"params": SH.to_named(pspec, mesh),
                   "opt": SH.to_named(SH.opt_specs(cfg, like["opt"], pspec,
                                                   mesh), mesh)}
            tree, _ = restore_checkpoint(ckpt, 1, like, shardings=shd)
            torch.save({n: t for n, t in leaf_paths(tree)},
                       f"{tmp}/blocks{rank}.pt")
            # training through the EP combine on the group: loss and
            # the router's gradient those of the plain block
            import dataclasses
            ep = api.build_model(dataclasses.replace(
                cfg, moe_local_combine=True), mesh)
            batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
                     "targets": torch.zeros((2, 8), dtype=torch.int32),
                     "mask": torch.ones((2, 8))}
            params = api.build_model(cfg).init(0, "cpu")
            le, ge = TL.value_and_grad(ep.loss, params, batch)
            lp, gp = TL.value_and_grad(api.build_model(cfg).loss, params,
                                       batch)
            router = [g["layers"]["ffn"]["router"] for g in (ge, gp)]
            with open(f"{tmp}/rank{rank}.json", "w") as f:
                json.dump({"group": mesh.group is not None,
                           "loss_rel": abs(float(le) / float(lp) - 1),
                           "router_err": float((router[0] - router[1]
                                                ).abs().max())}, f)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(rank_main, args=(2, sys.argv[1], sys.argv[2]), nprocs=2,
                 join=True)
""")


def test_restore_with_shardings_on_gloo_ranks(ref_checkpoint, tmp_path):
    # each of 2 ranks restores its block of every leaf; gather puts them
    # back together into the file's values; a gradient through the EP
    # combine on the group is the plain block's
    d, _, tcfg, like = ref_checkpoint
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp_path), d],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    blocks = [torch.load(tmp_path / f"blocks{r}.pt") for r in range(2)]
    mesh = make_mesh((1, 2), ("data", "model"))
    named = _shardings(tcfg, like, mesh)
    files = _file_values(d)
    split = 0
    for name, shd in leaf_paths(named):
        parts = [b[name] for b in blocks]
        split += parts[0].shape != files[name].shape
        assert np.array_equal(SH.gather(parts, shd).numpy(), files[name]), \
            name
    assert split >= 8          # the experts, the embedding, q / o, moments
    for r in range(2):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec["group"] and rec["loss_rel"] <= 1e-6, rec
        assert rec["router_err"] <= 1e-6, rec
