"""RWKV6 and Zamba2 on the ranks of a gloo process group: a batch split
over 2 data ranks on a (data 2, model 1) mesh, where their weights stay
whole as the rules fit them (smoke rwkv6-3b and zamba2-1.2b, no fsdp),
against the reference's mesh with the limits of
`test_torch_tp_decoders.py` (`tests/torch_tp.py`), the step-0 gradient
by the relative L2 of each leaf (RWKV6's grad norm is 1,673 there:
`test_torch_losses.py`'s rule); and the refusal of what the ranks do not
port for them (ROADMAP 1.15b): a `model` axis of 2, fsdp over a data
axis of 2.

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
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model

JOBS = {"rwkv": "rwkv6-3b", "zamba": "zamba2-1.2b"}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ssm")
    out = {name: T.make_job(root / name, arch, (2, 1), "ssm", seed=23, lr=1e-4)
           for name, arch in JOBS.items()}
    T.run_reference(*out.values())
    return out


@pytest.mark.parametrize("name", sorted(JOBS))
def test_ssm_family_on_data_ranks_matches_the_reference(jobs, name):
    d = jobs[name]
    shutil.copytree(d / "init", d / "ck")
    recs = T.ranks("tp", 2, d)
    want = json.loads((d / "ref.json").read_text())
    for rec in recs:
        assert rec["start"] == 0 and rec["shapes_ok"], rec
        assert rec["split"] == 0, rec
        assert rec["grad_rel"] <= 1e-4, rec
        assert rec["losses"] == recs[0]["losses"]
    got = recs[0]
    assert max(map(T.rel, got["losses"], want["losses"])) <= 1e-5
    assert max(map(T.rel, got["grad_norms"], want["grad_norms"])) <= 1e-4
    T.final_params_close(d)


def _on_ranks(shape):
    """A mesh as a process group would carry it: the refusals come before
    any collective."""
    return dataclasses.replace(make_mesh(shape, ("data", "model")),
                               group=object())


@pytest.mark.parametrize("arch", sorted(JOBS.values()))
@pytest.mark.parametrize("shape, over", [((1, 2), {}), ((2, 2), {}),
                                         ((2, 1), {"fsdp": True})])
def test_ssm_family_refuses_what_ranks_do_not_port(arch, shape, over):
    cfg = dataclasses.replace(smoke_config(arch), **over)
    with pytest.raises(ValueError, match="ROADMAP 1.15b"):
        build_model(cfg, _on_ranks(shape))
