"""The port stands alone: no module of it (nor chip_smoke.py, nor the
scripts in tools_torch/, nor the rank script of the process-group tests,
tests/torch_ranks.py) imports JAX or the reference package, and its entry
points run on the card unless the caller asks for the CPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_BLOCKER = r"""
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, %(src)r)
sys.path.insert(0, %(root)r)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    __import__(n)
import chip_smoke
sys.path.insert(0, %(tools)r)
import time_scann_build
import time_kernel_redesign
import time_graph_build
import time_exact_scan
import time_library_calls
import stress_gloo_ranks
sys.path.insert(0, %(tests)r)
import torch_ranks
for n in ("filtered_search_study", "rag_serving", "train_lm"):
    assert "repro_torch." + n in names, n
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    code = _BLOCKER % {"src": str(SRC), "root": str(ROOT),
                       "tools": str(ROOT / "tools_torch"),
                       "tests": str(ROOT / "tests")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


_FIRST = r"""
import importlib, pkgutil, sys
sys.path.insert(0, %(src)r)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    for k in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[k]
    importlib.import_module(n)
print(len(names))
"""


def test_every_module_imports_first():
    # no import cycle: each module of the port loads as the first one
    out = subprocess.run([sys.executable, "-c", _FIRST % {"src": str(SRC)}],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_entry_points_default_to_the_card():
    _no_card()
    import repro_torch.core as T
    from repro_torch import (filtered_search_study, interop, quickstart,
                             rag_serving, train_lm)
    from repro_torch.configs import smoke_config
    from repro_torch.data import DatasetSpec, make_dataset
    from repro_torch.core.distributed import (ShardedGraphExecutor,
                                              build_sharded_scann)
    from repro_torch.data import make_dataset_streamed
    from repro_torch.launch import serve, train
    from repro_torch.launch.specs import make_smoke_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    spec = DatasetSpec("iso", 200, 8, "l2", clusters=4)
    store, q = make_dataset(spec, num_queries=2, device="cpu")
    graph = T.build_graph(store, m=4, ef_construction=8, device="cpu")
    calls = [
        lambda: make_dataset(spec, num_queries=2),
        lambda: T.VectorStore.build(np.ones((3, 2), np.float32)),
        lambda: T.build_graph(store, m=4, ef_construction=8),
        lambda: T.build_graph_blocked(store, m=4, ef_construction=8),
        lambda: T.build_scann(store, num_leaves=4),
        lambda: T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "none")),
        lambda: T.make_executor("bruteforce", store),
        lambda: T.make_executor("sweeping_sq8", store, graph=object()),
        lambda: T.generate_families(store, 0.1),
        lambda: T.build_exclusion(store),
        lambda: T.build_graph_partitioned(store, {}),
        lambda: quickstart.main(n=200, dim=8),
        lambda: filtered_search_study.main(n=200, dim=8),
        lambda: rag_serving.main(n=256),
        lambda: train_lm.main(steps=1),
        lambda: build_model(smoke_config("granite-8b")).init(0),
        lambda: build_model(smoke_config("hubert-xlarge")).init(0),
        lambda: build_model(smoke_config("granite-8b")).init_cache(1, 4),
        lambda: ServeEngine(build_model(smoke_config("granite-8b")), {}, 8,
                            1),
        lambda: serve.main(["--arch", "granite-8b"]),
        lambda: serve.main(["--arch", "granite-8b", "--rag"]),
        lambda: make_dataset_streamed(spec, num_queries=2),
        lambda: build_sharded_scann(store, make_mesh((2,), ("data",)),
                                    "data", num_leaves=4),
        lambda: ShardedGraphExecutor(graph, store, 2),
        lambda: interop.lm_params({"w": np.ones(2, np.float32)}),
        lambda: Trainer(build_model(smoke_config("llama3.2-3b")),
                        AdamWConfig(), TrainConfig(steps=1),
                        lambda step: {}).init_or_restore(0),
        lambda: train.main(["--arch", "llama3.2-3b", "--steps", "1"]),
        lambda: train.main(["--arch", "granite-moe-1b-a400m", "--steps", "1",
                            "--mesh", "single"]),
        lambda: build_model(smoke_config("llama3.2-3b")).loss(
            build_model(smoke_config("llama3.2-3b")).init(0),
            make_smoke_batch(smoke_config("llama3.2-3b"), 1, 4, seed=0)),
        lambda: make_smoke_batch(smoke_config("llama3.2-3b"), 1, 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_entry_points_refuse_a_store_on_another_device():
    import repro_torch.core as T
    from repro_torch.data import DatasetSpec, make_dataset
    store, _ = make_dataset(DatasetSpec("iso", 100, 4, "l2", clusters=2),
                            num_queries=1, device="cpu")
    with pytest.raises(ValueError, match="device"):
        T.make_executor("bruteforce", store, device="meta")


def test_chip_smoke_fails_without_a_card(tmp_path):
    _no_card()
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT), env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path), env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_sharding_modules_are_covered():
    # the import blocker and the import-first check walk these too
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.core.collectives", "repro_torch.core.shardtypes",
            "repro_torch.core.distributed", "repro_torch.launch.mesh",
            "repro_torch.launch.serve", "repro_torch.launch.sharding"} <= names


def test_mutability_modules_are_covered_and_default_to_the_card(tmp_path):
    # the import blocker above walks these modules too
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.storage.delta", "repro_torch.storage.wal",
            "repro_torch.checkpoint", "repro_torch.checkpoint.store",
            "repro_torch.core.mutable"} <= names
    _no_card()
    from repro_torch.core import MutableIndex
    from repro_torch.storage import DeltaTier, Tombstones
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MutableIndex(np.ones((40, 4), np.float32), str(tmp_path / "wal"),
                     str(tmp_path / "ck"), with_graph=False,
                     with_scann=False)
    assert not os.path.exists(tmp_path / "wal")     # nothing was logged
    # the host state alone needs no device
    assert DeltaTier(base_n=0, capacity=4, dim=2).device_vectors is None
    assert Tombstones(64).device_words is None


def test_training_modules_are_covered():
    # the import blocker and the import-first check walk these too
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.compression", "repro_torch.train",
            "repro_torch.train.loop", "repro_torch.data.pipeline",
            "repro_torch.launch.specs", "repro_torch.launch.train"} <= names
    import repro_torch.models.api as api
    assert not hasattr(api, "TRAINING_ITEM")


_COST_RUN = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, %(src)r)
import dataclasses
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import dryrun, fvs_dryrun, op_cost
full, sm = get_config("granite-8b"), smoke_config("granite-8b")
over = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
        if getattr(sm, f.name) != getattr(full, f.name)}
rec = dryrun.lower_cell("granite-8b", "decode_32k", False, over)
fvs = fvs_dryrun.run(n=20_000, dim=32, queries=8, leaves_searched=16)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(rec["flops_per_device"] > 0, fvs["collectives"])
"""


def test_cost_modules_are_covered_and_run_without_jax():
    # the import blocker and the import-first check walk these too; the
    # dry runs also run under the blocker
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.hardware", "repro_torch.launch.op_cost",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.fvs_dryrun"} <= names
    out = subprocess.run([sys.executable, "-c",
                          _COST_RUN % {"src": str(SRC)}],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "True"
