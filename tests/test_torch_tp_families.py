"""The TP and FSDP layout on gloo ranks for the VLM and the encoder on a
(data 2, model 2) mesh: smoke llava-next-mistral-7b with fsdp (the
Mistral backbone, the patch prefix masked out of the loss) and smoke
hubert-xlarge with fsdp (its `adapter` and `head` P("data", None), the
classes whole on every `model` rank), against the reference's mesh, as
`test_torch_tp_decoders.py` holds the decoders (`tests/torch_tp.py`;
the same limits).
"""
import json
import shutil

import pytest

import torch_tp as T

JOBS = {"vlm": ("llava-next-mistral-7b", "vlm"),
        "encoder": ("hubert-xlarge", "encoder")}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_families")
    out = {name: T.make_job(root / name, arch, (2, 2), family, seed=22,
                            fsdp=True)
           for name, (arch, family) in JOBS.items()}
    T.run_reference(*out.values())
    for d in out.values():
        shutil.copytree(d / "init", d / "ck")
    recs = T.spawns([("tp", d, 4) for d in out.values()])
    return {name: (d, recs["tp", d]) for name, d in out.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_family_on_tp_fsdp_ranks_matches_the_reference(jobs, name):
    d, recs = jobs[name]
    want = json.loads((d / "ref.json").read_text())
    for rec in recs:
        assert rec["start"] == 0 and rec["shapes_ok"], rec
        assert rec["split"] >= 7, rec
        assert rec["grad_err"] <= 1e-4, rec
        assert rec["losses"] == recs[0]["losses"]
    got = recs[0]
    assert max(map(T.rel, got["losses"], want["losses"])) <= 1e-5
    assert max(map(T.rel, got["grad_norms"], want["grad_norms"])) <= 1e-4
    T.final_params_close(d)
