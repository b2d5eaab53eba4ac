"""Fault-tolerant checkpointing: atomic, path-addressed, async.

Layout: <dir>/step_<N>/ with one .npy per leaf of a nested tree (dicts,
lists and tuples of tensors or arrays) and manifest.json (step, leaf
index with dtypes, shapes and byte sizes, `extra`).  Writes go to
step_<N>.tmp and are renamed atomically, so a killed writer never
corrupts the latest checkpoint.

A leaf's file name is its path spelled as the reference package's tree
library spells it (`['a']['b']`, `[0]`) with every run of characters
outside [A-Za-z0-9_.-] replaced by "_" and the ends stripped: {"base": x}
-> base, {"a": {"b": x}} -> a_b, [x, y] -> 0, 1.  Dict keys are visited
in sorted order and None is an empty subtree, as there.  With the same
names and the same .npy bytes, a checkpoint directory written by either
package restores in the other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(keystr, leaf) pairs in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _unflatten(like: Any, leaves: list) -> Any:
    """Rebuild `like`'s structure from leaves in flattening order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return leaves.pop(0)


def leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    """(file name, leaf) for every leaf of `tree`, in order."""
    return [(_SAFE.sub("_", path).strip("_"), leaf)
            for path, leaf in _flatten(tree)]


# a bfloat16 leaf's .npy: its uint16 bits under the descr numpy writes for
# the reference's (ml_dtypes) bfloat16 arrays; np.load reads it as |V2
_BF16_DESCR = "<V2"


def _is_bf16_bits(arr: np.ndarray) -> bool:
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            # numpy has no bfloat16: carry the bits, as the reference's
            # np.save of an ml_dtypes array writes them
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf)


def _save_npy(f, arr: np.ndarray) -> None:
    """np.save, but bfloat16 bits go under the reference's descr, so the
    file is byte for byte the one the reference writes."""
    if not _is_bf16_bits(arr):
        np.save(f, arr)
        return
    arr = np.ascontiguousarray(arr)
    np.lib.format.write_array_header_1_0(
        f, {"descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
    f.write(arr.tobytes())


def _leaf_tensor(name: str, arr: np.ndarray, like: torch.Tensor,
                 device) -> torch.Tensor:
    dev = like.device if device is None else device
    if not _is_bf16_bits(arr):
        return torch.as_tensor(arr, device=dev)
    if like.dtype != torch.bfloat16:
        raise ValueError(f"checkpoint leaf {name!r} holds bfloat16 bits "
                         f"(|V2) but restores into a {like.dtype} tensor")
    return torch.as_tensor(arr.view(np.int16), device=dev).view(
        torch.bfloat16)


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None,
                    fsync: bool = False) -> str:
    """Write one checkpoint.  `fsync=True` is the crash-consistency mode:
    every leaf file, the manifest and the parent directory entry are
    fsynced before the atomic rename publishes the step, so a checkpoint
    a WAL compaction marker points at is on storage."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in leaf_paths(tree):
        arr = _host(leaf)
        with open(os.path.join(tmp, name + ".npy"), "wb") as f:
            _save_npy(f, arr)
            if fsync:
                _fsync_file(f)
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": "bfloat16" if _is_bf16_bits(arr) else str(arr.dtype),
            "bytes": int(arr.nbytes)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        if fsync:
            _fsync_file(f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    if fsync:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)          # durably order the rename itself
        finally:
            os.close(dfd)
    return final


def read_manifest(directory: str, step: int) -> dict:
    """The step's manifest (step, leaves index, extra) without restoring
    any array."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, tree_like: Any,
                       device=None) -> tuple[Any, dict]:
    """Restore into the structure of `tree_like`.  A leaf whose `like` is
    a tensor comes back as a tensor on `device` (default: that tensor's
    device); any other leaf comes back as a numpy array.  A bfloat16
    leaf's bits (a |V2 array, either package's writing) restore only
    into a bfloat16 tensor.  Returns (tree,
    the manifest's `extra`)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for name, like in leaf_paths(tree_like):
        meta = manifest["leaves"][name]
        arr = np.load(os.path.join(path, name + ".npy"))
        if arr.nbytes != meta["bytes"]:
            raise IOError(f"integrity check failed for {name}")
        if isinstance(like, torch.Tensor):
            leaves.append(_leaf_tensor(name, arr, like, device))
        else:
            leaves.append(arr)
    return _unflatten(tree_like, leaves), manifest["extra"]


class CheckpointManager:
    """Async, bounded-retention checkpoint writer."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        self.wait()
        # snapshot on the host before the writer thread starts
        host = _unflatten(tree, [np.array(_host(leaf), copy=True)
                                 for _, leaf in _flatten(tree)])

        def work():
            save_checkpoint(self.directory, step, host, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
