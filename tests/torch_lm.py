"""Shared fixtures of the port's training tests: smoke configs, the
reference's weights carried across (cached a process), the reference's
and the port's (loss, grads) of a bundle, and the relative error."""
import dataclasses
import functools

import jax
import numpy as np
import torch

import repro.configs as RC
from repro.models import api as japi
from repro_torch import interop
from repro_torch.launch.specs import make_smoke_batch
from repro_torch.models import api as tapi
from repro_torch.train.loop import value_and_grad

B, T, SEED = 2, 32, 1


def smoke(arch: str, **over):
    """The reference's smoke config; gemma3-12b with 12 layers and window
    8 (two 5:1 groups whose local window is shorter than the sequence),
    zamba2-1.2b with 5 layers (a tail layer)."""
    cfg = RC.smoke_config(arch)
    if arch == "gemma3-12b":
        cfg = dataclasses.replace(cfg, n_layers=12, window=8)
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, n_layers=5)
    return dataclasses.replace(cfg, **over)


def weights(cfg):
    """(reference params, the port's copy) from PRNGKey(0): the weights do
    not depend on the compute dtype or remat."""
    return _weights(dataclasses.replace(cfg, compute_dtype="float32",
                                        remat="none"))


@functools.lru_cache(maxsize=None)
def _weights(cfg):
    jp = jax.jit(japi.build_model(cfg).init)(jax.random.PRNGKey(0))
    return jp, interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def reference(cfg, batch):
    """(loss, grads) of the reference's bundle, jitted."""
    jp, _ = weights(cfg)
    return jax.jit(jax.value_and_grad(japi.build_model(cfg).loss))(jp, batch)


def port(cfg, batch=None):
    """(loss, grads) of the port's bundle on the carried weights, on the
    smoke batch (B, T, seed SEED) unless one is given."""
    _, tp = weights(cfg)
    tcfg = interop.arch_config(cfg)
    tb = make_smoke_batch(tcfg, B, T, seed=SEED, device="cpu") \
        if batch is None else batch
    return value_and_grad(tapi.build_model(tcfg).loss, tp, tb)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(np.asarray(x, np.float32), np.float64)


def rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def paths(tree) -> list[str]:
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
