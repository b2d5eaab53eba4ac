"""The layout of every leaf on the ranks of a process group
(`launch.sharding.rank_specs`), on the meta device at the published
shapes: for the dense, MoE, VLM and encoder families on (data 2, model 2)
and (pod 2, data 2, model 4), every leaf of the params and of the AdamW
state with its int8 error buffers takes the fitted spec that
`param_specs` / `opt_specs` give it, and each position's blocks add up
to `per_position_bytes`; RWKV6 and Zamba2 at a `model` axis of 1, and
what the ranks refuse (ROADMAP 1.15b).  No process group is needed: the
layout is arithmetic on the shapes.
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

TP_ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b", "granite-8b",
            "gemma3-12b", "llama3.2-3b", "granite-20b",
            "llava-next-mistral-7b", "hubert-xlarge")
SSM_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}


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
    # the q / o heads split over `model` wherever they divide it
    wq = dict(flatten_with_path(pspecs))["['layers']['attn']['wq']"]
    assert "model" in SH.entry_axes(wq[-1])
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
def test_ssm_families_refuse_a_model_axis(arch, shape):
    cfg, params, _ = _trees(arch)
    with pytest.raises(ValueError, match="ROADMAP 1.15b"):
        SH.rank_specs(cfg, params, make_mesh(shape, ("data", "model")))


@pytest.mark.parametrize("arch, over, s", [
    ("llama3.2-3b", {}, 16),                     # 24 q heads over 16
    ("granite-20b", {}, 32),                     # 48 q heads over 32
    ("granite-8b", {"n_heads": 12, "n_kv": 3}, 2),   # GQA groups of 4
])
def test_heads_that_do_not_split_whole_are_refused(arch, over, s):
    cfg = dataclasses.replace(get_config(arch), **over)
    params = build_model(cfg).init(0, "meta")
    with pytest.raises(ValueError, match="ROADMAP 1.15b"):
        SH.rank_specs(cfg, params, make_mesh((1, s), ("data", "model")))


def test_sp_scheme_is_refused():
    cfg = dataclasses.replace(smoke_config("granite-8b"),
                              sharding_scheme="sp")
    params = build_model(cfg).init(0, "meta")
    with pytest.raises(ValueError, match="ROADMAP 1.15b"):
        SH.rank_specs(cfg, params, make_mesh((2, 2), ("data", "model")))


@pytest.mark.parametrize("h, kv, s, r, want", [
    (32, 8, 2, 1, (16, 32, 4, 8)),     # granite-8b: 4 kv heads a rank
    (48, 1, 4, 3, (36, 48, 0, 1)),     # granite-20b (MQA): the one kv head
    (24, 8, 4, 2, (12, 18, 4, 6)),     # llama3.2-3b: groups of 3
    (16, 16, 4, 1, (4, 8, 4, 8)),      # hubert: MHA
])
def test_rank_heads_are_whole_heads_and_their_kv_heads(h, kv, s, r, want):
    cfg = dataclasses.replace(smoke_config("granite-8b"), n_heads=h,
                              n_kv=kv)
    assert SH.rank_heads(cfg, s, r) == want
