"""RWKV6 and Zamba2 on (data 2, model 2) gloo ranks with fsdp (smoke
rwkv6-3b and zamba2-1.2b): every weight that the rules split over
`model` and `data` is a rank's block, gathered over `data` before its
use, against the reference's mesh (`tests/torch_tp.py`): every rank's
step-0 gradient, 3 AdamW steps and the params after them, with the
limits of `test_torch_tp_ssm.py`; and greedy `ServeEngine` tokens on
the ranks (the engine gathers the fsdp blocks once; a rank's RWKV6 wkv
and Mamba2 ssm states hold its heads, `layers.rank_cache`) equal to the
reference's engine's and to the one-process port's, token for token.
Both the training and the serving of both jobs run in one spawn of 4
ranks.

The batches are `test_torch_tp_ssm.py`'s (seed 23).  On other draws the
smoke RWKV6's third step at lr 1e-4 can be chaotic: on seed 25's the
one-process port's own grad norm at step 3 moves from 515.8 to 564.3
when its params move by one ulp (the reference reads 570.0), so no
implementation holds 1e-4 there; on seed 23's the same control moves it
by 4e-5.
"""
import json
import shutil

import pytest

import torch_tp as T
from test_torch_tp_ssm import JOBS, held_to_the_reference

# leaves that (2, 2) with fsdp splits
SPLIT = {"rwkv": 11, "zamba": 8}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ssm_fsdp")
    out = {name: T.make_job(root / name, arch, (2, 2), "ssm", seed=23,
                            lr=1e-4, serve=True, train=True, fsdp=True)
           for name, arch in JOBS.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    recs = T.spawns([("tp_all", d, 4) for d in out.values()])
    return {name: (d, recs["tp_all", d]) for name, d in out.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_ssm_family_on_tp_fsdp_ranks_matches_the_reference(jobs, name):
    d, recs = jobs[name]
    held_to_the_reference(d, recs, SPLIT[name])
    want = json.loads((d / "serve.json").read_text())
    assert len(want) == T.PROMPTS[0] and len(want[0]) == T.NEW_TOKENS
    for rec in recs:
        assert rec["tokens"] == want
        assert rec["plain"] == want
