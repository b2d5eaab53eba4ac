"""RWKV6 and Zamba2 on the ranks of a gloo process group (smoke rwkv6-3b
and zamba2-1.2b, no fsdp) against the reference's mesh, with the limits
of `test_torch_tp_decoders.py` (`tests/torch_tp.py`), the step-0
gradient by the relative L2 of each leaf (RWKV6's grad norm is 1,673
there: `test_torch_losses.py`'s rule):

* a batch split over 2 data ranks on a (data 2, model 1) mesh, where
  their weights stay whole as the rules fit them;
* a (data 1, model 2) mesh, where RWKV6's r / k / v / g / o columns,
  channel-mix hidden dim, Mamba2's in_proj columns and out_proj rows,
  the shared attention's heads and the vocab split over `model`: one of
  RWKV6's 2 heads a rank, and 2 of Mamba2's 4.

The (2, 2) mesh with fsdp and serving: `test_torch_tp_ssm_fsdp.py`;
(1, 4), where the heads are cut: `test_torch_tp_ssm_cut.py`; the `sp`
scheme: `test_torch_tp_sp_ssm.py`.  The four jobs run in one spawn of 2
ranks.

The jobs step at lr 1e-4, not 1e-3: at 1e-3 the port in one process,
with no ranks, already departs from the reference after 3 steps by
1.07e-4 in RWKV6's grad norm and 1.65e-5 in Zamba2's loss (the ranks by
2.2e-4 and 1.65e-5), so those steps would measure the two families'
sensitivity to the order of additions, not the ranks.
"""
import dataclasses
import json
import shutil

import pytest

import torch_tp as T
from repro_torch.checkpoint.store import flatten_with_path
from repro_torch.configs import smoke_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model

JOBS = {"rwkv": "rwkv6-3b", "zamba": "zamba2-1.2b"}
MESHES = {"data": (2, 1), "model": (1, 2)}
# leaves that (1, 2) splits: the vocab, the blocks' split weights
SPLIT = {"rwkv": 8, "zamba": 6}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ssm")
    out = {(name, axis): T.make_job(root / f"{name}_{axis}", arch, mesh,
                                    "ssm", seed=23, lr=1e-4)
           for name, arch in JOBS.items() for axis, mesh in MESHES.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    recs = T.spawns([("tp", d, 2) for d in out.values()])
    return {key: (d, recs["tp", d]) for key, d in out.items()}


def held_to_the_reference(d, recs, split) -> None:
    """Every rank's record of a `tp` job in `d` held to the reference's:
    `split` leaves are blocks (at least), every leaf's step-0 gradient
    within 1e-4 (relative L2) of its block of the reference's, the 3
    steps' losses within 1e-5 and grad norms within 1e-4, the params
    rank 0 writes within 1e-4."""
    want = json.loads((d / "ref.json").read_text())
    for rec in recs:
        assert rec["start"] == 0 and rec["shapes_ok"], rec
        assert rec["split"] >= split, rec
        assert rec["grad_rel"] <= 1e-4, rec["grad_rels"]
        assert rec["losses"] == recs[0]["losses"]
    got = recs[0]
    assert max(map(T.rel, got["losses"], want["losses"])) <= 1e-5
    assert max(map(T.rel, got["grad_norms"], want["grad_norms"])) <= 1e-4
    T.final_params_close(d)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_ssm_family_on_data_ranks_matches_the_reference(jobs, name):
    d, recs = jobs[name, "data"]
    assert all(rec["split"] == 0 for rec in recs)
    held_to_the_reference(d, recs, 0)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_ssm_family_on_model_ranks_matches_the_reference(jobs, name):
    d, recs = jobs[name, "model"]
    held_to_the_reference(d, recs, SPLIT[name])


@pytest.mark.parametrize("arch", sorted(JOBS.values()))
@pytest.mark.parametrize("shape, over", [((1, 2), {}), ((2, 2), {}),
                                         ((2, 1), {"fsdp": True})])
def test_ssm_family_refuses_what_ranks_do_not_port(arch, shape, over):
    """Nothing is refused now: a `model` axis, fsdp and the `sp` scheme
    are ported, and the ranks take the fitted specs of every leaf under
    either scheme; under `sp` no leaf splits over `model` (RWKV6 and
    Zamba2 have no experts) and the d_model dims split over `data`
    whether fsdp is set or not."""
    cfg = dataclasses.replace(smoke_config(arch), **over)
    params = build_model(cfg).init(0, "meta")
    mesh = make_mesh(shape, ("data", "model"))
    assert SH.rank_specs(cfg, params, mesh) \
        == SH.param_specs(cfg, params, mesh)
    sp = dataclasses.replace(cfg, sharding_scheme="sp")
    specs = SH.rank_specs(sp, params, mesh)
    assert specs == SH.param_specs(sp, params, mesh)
    axes = {n for _, spec in flatten_with_path(specs) for a in spec
            for n in SH.entry_axes(a)}
    assert axes == {"data"}, axes
