"""The `sp` scheme on gloo ranks for RWKV6 and Zamba2, against the
reference's mesh (`tests/torch_tp.py`), with the limits of
`test_torch_tp_ssm.py` and its jobs' settings (seed 23's batches, lr
1e-4):

* smoke rwkv6-3b (scan mode) on (data 1, model 2): both token shifts
  read the previous rank's last normed position, and rank 1's wkv scan
  starts from rank 0's final state (`models.ssm.split_scan`); its
  greedy `ServeEngine` tokens on the ranks (the prefill by position,
  the decode steps whole, every head's state on every rank) equal the
  reference engine's;
* smoke zamba2-1.2b on (2, 2): the Mamba2 conv reads the previous
  rank's last 3 positions, the SSD hands its state on, the shared
  attention gathers K / V with the rank's offset, and the dense weights
  split over `data` (the `sp` rules' FSDP).

One reference subprocess; one spawn a world size.
"""
import json
import shutil

import pytest

import torch_tp as T
from test_torch_tp_ssm import held_to_the_reference

# name: (arch, mesh, serve, leaves split on ranks)
JOBS = {"rwkv_1x2": ("rwkv6-3b", (1, 2), True, 0),
        "zamba_2x2": ("zamba2-1.2b", (2, 2), False, 8)}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_sp_ssm")
    out = {name: T.make_job(root / name, arch, mesh, "ssm", seed=23,
                            lr=1e-4, serve=serve, train=True,
                            sharding_scheme="sp")
           for name, (arch, mesh, serve, _) in JOBS.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    job = {name: "tp_all" if JOBS[name][2] else "tp" for name in JOBS}
    recs = T.spawns([(job[name], d, JOBS[name][1][0] * JOBS[name][1][1])
                     for name, d in out.items()])
    return {name: (d, recs[job[name], d]) for name, d in out.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_sp_ssm_ranks_match_the_reference(jobs, name):
    d, recs = jobs[name]
    held_to_the_reference(d, recs, JOBS[name][3])
    assert all(rec["split"] == JOBS[name][3] for rec in recs)
    if JOBS[name][2]:
        want = json.loads((d / "serve.json").read_text())
        for rec in recs:
            assert rec["tokens"] == want
            assert rec["plain"] == want
