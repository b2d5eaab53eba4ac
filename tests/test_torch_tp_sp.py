"""The `sp` scheme on the ranks of a gloo process group for the attention
families, against the reference's mesh (`tests/torch_tp.py`, the
reference's config with `sharding_scheme="sp"`), with the limits of
`test_torch_tp_ssm.py` (every leaf's step-0 gradient within 1e-4
relative L2, 3 steps' losses 1e-5 and grad norms 1e-4, the params rank 0
writes 1e-4, greedy tokens equal):

* smoke granite-moe on (data 1, model 2) with the plain combine (every
  expert gathered over `model`) and on (2, 2) with the EP combine: a
  `model` rank holds 16 of the 32 positions, attention gathers K / V
  with the rank's causal offset, the routing groups are whole rows
  gathered over `model`, the loss count is global over `data` and
  `model`; both also serve (the prefill by position, the decode whole);
* smoke hubert-xlarge on (1, 2): non-causal, K / V gathered with no
  offset, the masked-position count global;
* smoke llava-next-mistral-7b on (1, 2): the 16-patch prefix placed by
  global position (positions 0-15, all rank 0's) and masked out of the
  loss.

The dense weights split over `data` on (2, 2) (the `sp` rules' FSDP),
over nothing on (1, 2); the experts over `model`.  One reference
subprocess and one spawn a world size run every job.
"""
import json
import shutil

import pytest

import torch_tp as T
from test_torch_tp_ssm import held_to_the_reference

SP = {"sharding_scheme": "sp"}
# name: (arch, family, mesh, serve, overrides, leaves split on ranks)
JOBS = {
    "moe_1x2": ("granite-moe-1b-a400m", "dense", (1, 2), True, {}, 3),
    "moe_2x2": ("granite-moe-1b-a400m", "dense", (2, 2), True,
                {"moe_local_combine": True}, 9),
    "encoder_1x2": ("hubert-xlarge", "encoder", (1, 2), False, {}, 0),
    "vlm_1x2": ("llava-next-mistral-7b", "vlm", (1, 2), False, {}, 0),
}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_sp")
    out = {name: T.make_job(root / name, arch, mesh, family, seed=31,
                            serve=serve, train=True, **SP, **over)
           for name, (arch, family, mesh, serve, over, _) in JOBS.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    recs = T.spawns([("tp_all" if JOBS[name][3] else "tp", d,
                      JOBS[name][2][0] * JOBS[name][2][1])
                     for name, d in out.items()])
    return {name: (d, recs["tp_all" if JOBS[name][3] else "tp", d])
            for name, d in out.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_sp_ranks_match_the_reference(jobs, name):
    d, recs = jobs[name]
    held_to_the_reference(d, recs, JOBS[name][5])
    assert all(rec["split"] == JOBS[name][5] for rec in recs)
    if JOBS[name][3]:
        want = json.loads((d / "serve.json").read_text())
        assert len(want) == T.PROMPTS[0] and len(want[0]) == T.NEW_TOKENS
        for rec in recs:
            assert rec["tokens"] == want
            assert rec["plain"] == want
