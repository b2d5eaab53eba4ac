"""Attention whose heads do not split whole over `model`, on gloo ranks
against the reference's mesh (`tests/torch_tp.py`), with the limits of
`test_torch_tp_decoders.py`, and greedy `ServeEngine` tokens equal to
the reference's engine's and the one-process port's (one spawn a world
size):

* smoke llama3.2-3b with 6 q heads and 2 kv heads on (data 1, model 4):
  48 q columns a rank, 1.5 heads, so each rank gathers q over `model`,
  attends with every head and multiplies its columns of the output by
  its `wo` rows;
* smoke granite-20b with 6 q heads (MQA) on (1, 4): the same cut, one kv
  head;
* smoke granite-8b with 12 q heads and 3 kv heads on (1, 2): whole q
  heads, 6 a rank, but GQA groups of 4 that do not fall whole on a rank
  (rank 0's heads read kv heads 0, 0, 0, 0, 1, 1), each mapped to its
  own kv head.
"""
import json
import shutil

import pytest

import torch_tp as T

JOBS = {"cut": ("llama3.2-3b", (1, 4), dict(n_heads=6, n_kv=2)),
        "cut_mqa": ("granite-20b", (1, 4), dict(n_heads=6)),
        "uneven_gqa": ("granite-8b", (1, 2), dict(n_heads=12, n_kv=3))}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_heads")
    out = {name: T.make_job(root / name, arch, mesh, "dense", seed=27,
                            serve=True, train=True, **over)
           for name, (arch, mesh, over) in JOBS.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    recs = T.spawns([("tp_all", d, JOBS[name][1][1])
                     for name, d in out.items()])
    return {name: (d, recs["tp_all", d]) for name, d in out.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_heads_that_do_not_split_whole_match_the_reference(jobs, name):
    d, recs = jobs[name]
    want = json.loads((d / "ref.json").read_text())
    for rec in recs:
        assert rec["start"] == 0 and rec["shapes_ok"], rec
        assert rec["split"] >= 3, rec
        assert rec["grad_err"] <= 1e-4, rec["grad_rels"]
        assert rec["losses"] == recs[0]["losses"]
    got = recs[0]
    assert max(map(T.rel, got["losses"], want["losses"])) <= 1e-5
    assert max(map(T.rel, got["grad_norms"], want["grad_norms"])) <= 1e-4
    T.final_params_close(d)
    tokens = json.loads((d / "serve.json").read_text())
    for rec in recs:
        assert rec["tokens"] == tokens
        assert rec["plain"] == tokens
