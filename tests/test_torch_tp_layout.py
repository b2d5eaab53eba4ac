"""The layout of every leaf on the ranks of a process group
(`launch.sharding.rank_specs`), on the meta device at the published
shapes: for every family, RWKV6 and Zamba2 among them, on (data 2,
model 2), (pod 2, data 2, model 4) and the production (data 1, model 16),
every leaf of the params and of the AdamW state with its int8 error
buffers takes the fitted spec that `param_specs` / `opt_specs` give it,
and each position's blocks add up to `per_position_bytes`; the SSM
states' heads over `model` (`cache_specs`); attention heads that a
rank's q columns cut, or whose GQA groups do not fall whole on a rank
(`rank_heads`); and the `sp` scheme's layout for every family (the
dense weights FSDP over `data`, only experts over `model`).  No process
group is needed: the layout is arithmetic on the shapes.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro_torch.checkpoint.store import flatten_with_path
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import loop as TL

SSM_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
TP_ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b", "granite-8b",
            "gemma3-12b", "llama3.2-3b", "granite-20b",
            "llava-next-mistral-7b", "hubert-xlarge") + SSM_ARCHS
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model")),
          "1x16": ((1, 16), ("data", "model"))}
# a leaf whose last dim splits over `model` wherever it divides it
SPLIT_LEAF = {"rwkv6-3b": "['layers']['tmix']['wr']",
              "zamba2-1.2b": "['mamba_groups']['in_proj']"}


def _trees(arch):
    cfg = get_config(arch)
    params = build_model(cfg).init(0, "meta")
    opt = TL.init_opt_state(None, params, AdamWConfig(),
                            TL.TrainConfig(grad_compression=True))
    return cfg, params, opt


def _specs(tree):
    return [tuple(s) for _, s in flatten_with_path(tree)]


def _block_bytes(shapes, specs, mesh, coord) -> int:
    total = 0
    for (_, leaf), (_, spec) in zip(flatten_with_path(shapes),
                                    flatten_with_path(specs)):
        block = SH.NamedSharding(mesh, spec).slices(leaf.shape, coord)
        total += int(np.prod([s.stop - s.start for s in block])) \
            * leaf.element_size()
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_rank_specs_are_the_fitted_param_specs(arch, mesh_name):
    cfg, params, opt = _trees(arch)
    mesh = make_mesh(*MESHES[mesh_name])
    pspecs = SH.rank_specs(cfg, params, mesh)
    assert _specs(pspecs) == _specs(SH.param_specs(cfg, params, mesh))
    assert _specs(SH.rank_specs(cfg, opt, mesh)) \
        == _specs(SH.opt_specs(cfg, opt, None, mesh))
    # the q / o columns (RWKV6's r, Mamba2's in_proj) split over `model`
    # wherever they divide it
    leaf = SPLIT_LEAF.get(arch, "['layers']['attn']['wq']")
    assert "model" in SH.entry_axes(dict(flatten_with_path(pspecs))[leaf][-1])
    want = SH.per_position_bytes(params, pspecs, mesh)
    for coord in itertools.product(*map(range, mesh.devices.shape)):
        assert _block_bytes(params, pspecs, mesh, coord) == want, coord


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_families_are_whole_on_a_model_axis_of_one(arch):
    cfg, params, opt = _trees(arch)
    mesh = make_mesh((2, 1), ("data", "model"))
    pspecs = SH.rank_specs(cfg, params, mesh)
    assert _specs(pspecs) == _specs(SH.param_specs(cfg, params, mesh))
    assert SH.per_position_bytes(params, pspecs, mesh) == sum(
        leaf.numel() * leaf.element_size()
        for _, leaf in flatten_with_path(params))


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_ssm_families_split_over_a_model_axis(arch, shape):
    """The fitted specs split RWKV6's and Zamba2's blocks over `model`,
    and their decode states' heads with them (40 and 64 heads divide 2
    and 4): what `layers.rank_cache` cuts a rank's block of."""
    cfg, params, _ = _trees(arch)
    mesh = make_mesh(shape, ("data", "model"))
    pspecs = SH.rank_specs(cfg, params, mesh)
    assert _specs(pspecs) == _specs(SH.param_specs(cfg, params, mesh))
    assert "model" in SH.entry_axes(
        dict(flatten_with_path(pspecs))[SPLIT_LEAF[arch]][-1])
    cache = build_model(cfg).init_cache(4, 64, "meta")
    state = {path: spec for path, spec in flatten_with_path(
        SH.cache_specs(cfg, cache, mesh)) if "wkv" in path or "ssm" in path}
    assert state and all(spec[-3] == "model" for spec in state.values())


@pytest.mark.parametrize("arch, over, s", [
    ("llama3.2-3b", {}, 16),                     # 24 q heads over 16
    ("granite-20b", {}, 32),                     # 48 q heads over 32
    ("granite-8b", {"n_heads": 12, "n_kv": 3}, 2),   # GQA groups of 4
])
def test_heads_that_do_not_split_whole_are_refused(arch, over, s):
    """No longer refused: the ranks take the fitted specs, and
    `rank_heads` gives each its q columns, cut heads or uneven groups."""
    cfg = dataclasses.replace(get_config(arch), **over)
    params = build_model(cfg).init(0, "meta")
    mesh = make_mesh((1, s), ("data", "model"))
    assert _specs(SH.rank_specs(cfg, params, mesh)) \
        == _specs(SH.param_specs(cfg, params, mesh))
    splits = [SH.rank_heads(cfg, s, r) for r in range(s)]
    cols = cfg.n_heads * cfg.head_dim
    assert [(p.c0, p.c1) for p in splits] == [
        (r * cols // s, (r + 1) * cols // s) for r in range(s)]
    if cfg.n_heads % s:
        assert not any(p.whole for p in splits)
    else:
        assert all(p.whole for p in splits)
        assert not all(p.grouped for p in splits)


def test_sp_scheme_is_refused():
    """No longer refused: under `sp` the ranks take the fitted specs,
    the dense weights FSDP over `data` with no `model` dim."""
    cfg = dataclasses.replace(smoke_config("granite-8b"),
                              sharding_scheme="sp")
    params = build_model(cfg).init(0, "meta")
    mesh = make_mesh((2, 2), ("data", "model"))
    specs = SH.rank_specs(cfg, params, mesh)
    assert _specs(specs) == _specs(SH.param_specs(cfg, params, mesh))
    assert dict(flatten_with_path(specs))["['layers']['attn']['wq']"] \
        == (None, "data", None)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1)])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "granite-8b",
                                  "gemma3-12b", "llava-next-mistral-7b",
                                  "hubert-xlarge", "rwkv6-3b",
                                  "zamba2-1.2b"])
def test_sp_rank_specs_are_the_param_specs(arch, shape):
    """Every family under `sp` on (1, 2), (2, 2) and (2, 1), at the
    published shapes: the params' and the AdamW state's specs on ranks
    are `param_specs` / `opt_specs`'; only a MoE's experts split over
    `model`, and a leaf's d_model dim over `data` with fsdp off."""
    cfg, params, opt = _trees(arch)
    cfg = dataclasses.replace(cfg, sharding_scheme="sp", fsdp=False)
    mesh = make_mesh(shape, ("data", "model"))
    pspecs = SH.rank_specs(cfg, params, mesh)
    assert _specs(pspecs) == _specs(SH.param_specs(cfg, params, mesh))
    assert _specs(SH.rank_specs(cfg, opt, mesh)) \
        == _specs(SH.opt_specs(cfg, opt, None, mesh))
    over_model = sorted(path for path, spec in flatten_with_path(pspecs)
                        if "model" in {n for a in spec
                                       for n in SH.entry_axes(a)})
    experts = [f"['layers']['ffn']['{n}']" for n in ("wd", "wg", "wu")]
    assert over_model == (experts if cfg.family == "moe" else [])
    if shape[0] > 1:
        leaf = SPLIT_LEAF.get(arch, "['layers']['attn']['wq']")
        assert dict(flatten_with_path(pspecs))[leaf][-2] == "data"


@pytest.mark.parametrize("h, kv, s, r, want", [
    # granite-8b: 4 kv heads a rank
    (32, 8, 2, 1, (512, 1024, 16, 32, 4, 8, True, True)),
    # granite-20b (MQA): the one kv head
    (48, 1, 4, 3, (1152, 1536, 36, 48, 0, 1, True, True)),
    # llama3.2-3b: groups of 3
    (24, 8, 4, 2, (384, 576, 12, 18, 4, 6, True, True)),
    # hubert: MHA
    (16, 16, 4, 1, (128, 256, 4, 8, 4, 8, True, True)),
    # llama3.2-3b over 16: 1.5 heads a rank, cut
    (24, 8, 16, 1, (48, 96, 1, 3, 0, 1, False, False)),
    # granite-20b over 32: 1.5 heads a rank, cut
    (48, 1, 32, 5, (240, 288, 7, 9, 0, 1, False, False)),
    # 12 heads and 3 kv heads over 2: whole heads, groups of 4 cut
    (12, 3, 2, 0, (0, 192, 0, 6, 0, 2, True, False)),
    # 24 heads, groups of 3, over 12: heads 2, 3 read kv heads 0, 1
    (24, 8, 12, 1, (64, 128, 2, 4, 0, 2, True, True)),
])
def test_rank_heads_are_whole_heads_and_their_kv_heads(h, kv, s, r, want):
    cfg = dataclasses.replace(smoke_config("granite-8b"), n_heads=h,
                              n_kv=kv)
    assert cfg.head_dim == 32
    assert SH.rank_heads(cfg, s, r) == want
