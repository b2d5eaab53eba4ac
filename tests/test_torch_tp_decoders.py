"""The dense weights' TP and FSDP layout on the ranks of a gloo process
group (`launch.sharding.rank_specs`, the blocks of `models.layers`,
`train.ranks.RankLayout`) against the reference's (data 2, model 2)
mesh, on the CPU: smoke granite-8b (dense) with fsdp, and smoke
granite-moe with fsdp and the EP combine (experts P("model", "data",
None): two split dims).

The reference runs once a module in a subprocess (`tests/torch_tp.py`):
its params laid out by its own `param_specs` through
`restore_checkpoint(..., shardings=)`, the step-0 global gradient, 3
jitted steps.  The ranks run `tests/torch_ranks.py` (one spawn a module,
every job in it) and restore the reference's step-0 checkpoint onto
their blocks.

Limits: every rank's step-0 gradient within 1e-4 (absolute) of its block
of the reference's; over 3 steps, loss 1e-5 and grad norm 1e-4
relative, the params rank 0 gathers and writes 1e-4 (the ranks add
partials, data terms and blocks' squared norms in another order than
XLA's partitioned program); every rank holds exactly the blocks
`fit_spec(param_specs)` gives.  AdamW's eps is `torch_tp.EPS` on both
sides.  Serving and the crash-resume on such ranks:
`test_torch_tp_serving.py`.
"""
import json
import shutil

import pytest

import torch_tp as T

JOBS = {"dense": ("granite-8b", dict(fsdp=True)),
        "moe": ("granite-moe-1b-a400m", dict(fsdp=True,
                                             moe_local_combine=True))}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_decoders")
    out = {name: T.make_job(root / name, arch, (2, 2), "dense", seed=21,
                            **over)
           for name, (arch, over) in JOBS.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    recs = T.spawns([("tp", d, 4) for d in out.values()])
    return {name: (d, recs["tp", d]) for name, d in out.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_tp_fsdp_ranks_match_the_reference(jobs, name):
    d, recs = jobs[name]
    want = json.loads((d / "ref.json").read_text())
    for rec in recs:
        assert rec["start"] == 0 and rec["shapes_ok"], rec
        assert rec["split"] >= (8 if name == "moe" else 7), rec
        assert rec["grad_err"] <= 1e-4, rec
        assert rec["losses"] == recs[0]["losses"]
    got = recs[0]
    assert max(map(T.rel, got["losses"], want["losses"])) <= 1e-5
    assert max(map(T.rel, got["grad_norms"], want["grad_norms"])) <= 1e-4
    T.final_params_close(d)
