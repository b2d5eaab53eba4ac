"""RWKV6 and Zamba2 on (data 1, model 4) gloo ranks, where the columns
of a rank cut a head: smoke rwkv6-3b's 2 heads of 64 (32 columns a
rank: r, k, v and the decay gathered over `model`, every head scanned,
`u` and `ln_w` whole), in its chunked mode; smoke zamba2-1.2b at d_model
64, whose 2 Mamba2 heads are cut the same way (32 out_proj rows a rank)
and whose in_proj columns (290) do not split over 4 (whole on every
rank, through `GroupShards.copy`).  Held to the reference's mesh
(`tests/torch_tp.py`) with the limits of `test_torch_tp_ssm.py`, and
greedy `ServeEngine` tokens (the decode states hold every head) equal
to the reference's engine's and the one-process port's; one spawn of 4
ranks runs both jobs.
"""
import json
import shutil

import pytest

import torch_tp as T
from test_torch_tp_ssm import held_to_the_reference

JOBS = {"rwkv": ("rwkv6-3b", dict(rwkv_mode="chunked"), 7),
        "zamba": ("zamba2-1.2b", dict(d_model=64), 4)}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ssm_cut")
    out = {name: T.make_job(root / name, arch, (1, 4), "ssm", seed=23,
                            lr=1e-4, serve=True, train=True, **over)
           for name, (arch, over, _) in JOBS.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    recs = T.spawns([("tp_all", d, 4) for d in out.values()])
    return {name: (d, recs["tp_all", d]) for name, d in out.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_ssm_family_with_cut_heads_matches_the_reference(jobs, name):
    d, recs = jobs[name]
    held_to_the_reference(d, recs, JOBS[name][2])
    want = json.loads((d / "serve.json").read_text())
    for rec in recs:
        assert rec["tokens"] == want
        assert rec["plain"] == want
