"""Serving and the fault-tolerant Trainer on TP / FSDP ranks, and the
layout's two-dim splits put back together, on (data 2, model 2) gloo
ranks on the CPU (`tests/torch_tp.py`, `tests/torch_ranks.py`): smoke
granite-8b with fsdp from the reference's PRNGKey(0) params.

* Greedy `ServeEngine` tokens on the ranks (heads, ffn columns and the
  vocab over `model`, the fsdp blocks gathered once by the engine, every
  kv head in each rank's cache) equal the reference's engine's, token
  for token, and the one-process port's.
* A crash at step 2 resumes onto the run without the crash; the step-0
  params and AdamW state restored onto the blocks and gathered by rank 0
  are written byte for byte as the reference wrote them.
* `RankLayout.whole` and `gather` put leaves split over two axes back
  together exactly (`tok`: P("model", "data"); granite-moe's experts:
  P(None, "model", "data", None)).

The three run in one spawn of 4 ranks.
"""
import json
import shutil

import pytest

import torch_tp as T


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The job's directory and every spawned job's records (one spawn of 4
    ranks: serving, the crash, the two-dim splits)."""
    root = tmp_path_factory.mktemp("tp_serving")
    d = T.make_job(root / "dense", "granite-8b", (2, 2), "dense", seed=24,
                   serve=True, fsdp=True)
    T.run_reference(d)
    for ck in ("straight", "crashed"):
        shutil.copytree(d / "init", d / ck)
    (root / "whole").mkdir()
    recs = T.ranks(4, [("tp_serve", d), ("tp_crash", d),
                       ("whole", root / "whole")])
    return d, {name: r for (name, _), r in recs.items()}


def test_greedy_serving_on_tp_ranks_equals_the_reference(job):
    job, recs = job
    want = json.loads((job / "serve.json").read_text())
    recs = recs["tp_serve"]
    for rec in recs:
        assert rec["split"] >= 7, rec
        assert rec["tokens"] == want
        assert rec["plain"] == want
    assert len(want) == T.PROMPTS[0] and len(want[0]) == T.NEW_TOKENS


def test_trainer_crash_on_tp_fsdp_ranks_resumes_onto_the_straight_run(job):
    job, recs = job
    recs = recs["tp_crash"]
    for rec in recs:
        assert rec["start0"] == 0 and rec["start"] == 2, rec
        assert rec["failed"] == "injected failure at step 2"
        assert rec["resumed"] == [[3, rec["straight"][2]],
                                  [4, rec["straight"][3]]]
    theirs = T.files(job / "init" / "step_00000000")
    assert theirs and T.files(job / "again" / "step_00000000") == theirs
    assert T.files(job / "straight" / "step_00000004") \
        == T.files(job / "crashed" / "step_00000004")


def test_two_dim_splits_are_put_back_together(job):
    recs = job[1]["whole"]
    for rec in recs:
        assert {"['embed']['tok']", "['embed']['unembed']",
                "['layers']['ffn']['wg']"} <= set(rec["two_dim"]), rec
        assert rec["whole_equal"], rec
    assert recs[0]["gather_equal"]
