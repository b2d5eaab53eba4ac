"""The port's checkpoint store (`repro_torch.checkpoint`) against the
reference's on the CPU: leaf file names spelled as the reference's tree
paths, the save / restore round trip with tensors and arrays, a directory
written by either package restoring in the other, and
`CheckpointManager`'s retention."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.store as RCK
import repro_torch.checkpoint as CK

TREES = {
    "flat": lambda: {"base": np.arange(6, dtype=np.float32).reshape(2, 3)},
    "nested": lambda: {"a": {"b": np.ones(3, np.int32),
                             "c": [np.zeros(2), np.full(1, 7.0)]},
                       "z": (np.arange(4, dtype=np.uint32),),
                       "m": np.float32(2.5)},
    "list": lambda: [np.ones(2), np.zeros(3, np.int64)],
    "odd keys": lambda: {"x y": np.ones(1), "dot.key": np.zeros(2),
                         "p": {"q-r": [np.ones(1), None, np.ones(2)]}},
    "mutable index": lambda: {
        "base": np.ones((5, 4), np.float32),
        "delta": np.zeros((8, 4), np.float32),
        "tomb": np.array([1, 0xFFFFFFFF], np.uint32)},
}


@pytest.mark.parametrize("kind", sorted(TREES))
def test_leaf_names_equal_reference(kind):
    tree = TREES[kind]()
    got = CK.leaf_paths(tree)
    want = RCK._leaf_paths(tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _tensorize(tree):
    if isinstance(tree, dict):
        return {k: _tensorize(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensorize(v) for v in tree)
    if tree is None:
        return None
    return torch.as_tensor(np.array(tree))


@pytest.mark.parametrize("kind", sorted(TREES))
def test_save_restore_round_trip(tmp_path, kind):
    tree = TREES[kind]()
    like = _tensorize(tree)
    path = CK.save_checkpoint(str(tmp_path), 3, like, extra={"k": 1},
                              fsync=True)
    assert os.path.basename(path) == "step_00000003"
    assert CK.latest_step(str(tmp_path)) == 3
    manifest = CK.read_manifest(str(tmp_path), 3)
    assert manifest["extra"] == {"k": 1}
    for as_like in (tree, like):
        got, extra = CK.restore_checkpoint(str(tmp_path), 3, as_like,
                                           device="cpu")
        assert extra == {"k": 1}
        for (na, a), (nb, b) in zip(CK.leaf_paths(got),
                                    CK.leaf_paths(tree)):
            assert na == nb
            assert isinstance(a, torch.Tensor) == (as_like is like)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert type(got) is type(like)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_restores_in_the_other_package(tmp_path, writer):
    tree = TREES["nested"]()
    if writer == "reference":
        RCK.save_checkpoint(str(tmp_path), 1, tree, extra={"w": writer})
        got, extra = CK.restore_checkpoint(str(tmp_path), 1, tree)
        pairs = zip(CK.leaf_paths(got), CK.leaf_paths(tree))
    else:
        CK.save_checkpoint(str(tmp_path), 1, _tensorize(tree),
                           extra={"w": writer})
        like = RCK.jax.tree.map(jnp.asarray, tree)
        got, extra = RCK.restore_checkpoint(str(tmp_path), 1, like)
        pairs = zip(RCK._leaf_paths(got), RCK._leaf_paths(tree))
    assert extra == {"w": writer}
    for (na, a), (nb, b) in pairs:
        assert na == nb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert RCK.latest_step(str(tmp_path)) == CK.latest_step(str(tmp_path))


def test_restore_checks_integrity(tmp_path):
    tree = TREES["flat"]()
    CK.save_checkpoint(str(tmp_path), 1, tree)
    np.save(tmp_path / "step_00000001" / "base.npy", np.ones(2, np.float32))
    with pytest.raises(IOError, match="integrity"):
        CK.restore_checkpoint(str(tmp_path), 1, tree)


def test_checkpoint_manager_retention(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 5):
        t = {"w": torch.full((3,), float(step)), "s": [np.int64(step)]}
        mgr.save_async(step, t, extra={"step": step})
        t["w"].zero_()                       # the snapshot is already taken
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    assert CK.latest_step(str(tmp_path)) == 4
    got, extra = CK.restore_checkpoint(
        str(tmp_path), 4, {"w": torch.zeros(3), "s": [np.int64(0)]})
    assert extra == {"step": 4}
    assert torch.equal(got["w"], torch.full((3,), 4.0))
    assert int(got["s"][0]) == 4
    assert CK.latest_step(str(tmp_path / "missing")) is None


def _bf16_tree():
    return {"p": torch.tensor([1.0, -2.5, 3.140625, 1e-3]).to(
        torch.bfloat16), "w": torch.arange(3, dtype=torch.float32)}


def test_bf16_leaf_round_trip(tmp_path):
    tree = _bf16_tree()
    CK.save_checkpoint(str(tmp_path), 1, tree)
    assert CK.read_manifest(str(tmp_path), 1)["leaves"]["p"]["dtype"] == \
        "bfloat16"
    got, _ = CK.restore_checkpoint(str(tmp_path), 1, _bf16_tree())
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"].view(torch.int16),
                       tree["p"].view(torch.int16))
    # the async manager writes the same
    mgr = CK.CheckpointManager(str(tmp_path / "m"))
    mgr.save_async(2, tree)
    mgr.wait()
    got, _ = CK.restore_checkpoint(str(tmp_path / "m"), 2, _bf16_tree())
    assert torch.equal(got["p"], tree["p"])


def test_bf16_files_are_the_references_bytes(tmp_path):
    # the reference writes a bfloat16 leaf as its bits under |V2; the
    # port's file is the same bytes, and it restores the reference's
    import ml_dtypes
    bits = _bf16_tree()["p"].view(torch.int16).numpy()
    ref_tree = {"p": bits.view(ml_dtypes.bfloat16)}
    RCK.save_checkpoint(str(tmp_path / "ref"), 1, ref_tree)
    CK.save_checkpoint(str(tmp_path / "port"), 1, {"p": _bf16_tree()["p"]})
    ref_file = (tmp_path / "ref" / "step_00000001" / "p.npy").read_bytes()
    port_file = (tmp_path / "port" / "step_00000001" / "p.npy").read_bytes()
    assert ref_file == port_file
    assert np.load(tmp_path / "ref" / "step_00000001" / "p.npy").dtype.str \
        == "|V2"
    assert RCK.read_manifest(str(tmp_path / "ref"), 1)["leaves"] == \
        CK.read_manifest(str(tmp_path / "port"), 1)["leaves"]
    got, _ = CK.restore_checkpoint(str(tmp_path / "ref"), 1,
                                   {"p": torch.zeros(4,
                                                     dtype=torch.bfloat16)})
    assert torch.equal(got["p"], _bf16_tree()["p"])


@pytest.mark.parametrize("like", [torch.zeros(4), torch.zeros(4, dtype=
                                                              torch.int16),
                                  torch.zeros(4, dtype=torch.float16)])
def test_bf16_file_refused_into_another_dtype(tmp_path, like):
    CK.save_checkpoint(str(tmp_path), 1, {"p": _bf16_tree()["p"]})
    with pytest.raises(ValueError, match="'p'.*bfloat16"):
        CK.restore_checkpoint(str(tmp_path), 1, {"p": like})
