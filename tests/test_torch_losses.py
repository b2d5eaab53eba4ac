"""Every model bundle's training loss and its gradients in the port
(`models.layers.softmax_xent`, `transformer.lm_loss`, `encoder_loss`,
`rwkv_loss`, `hybrid_loss`, `vlm_loss`, `transformer._remat`) against the
reference's `jax.value_and_grad(bundle.loss)`, at smoke size on the CPU.
The reference initialises the weights; `interop.lm_params` carries them
across, and both sides take the same `make_smoke_batch` batch (byte for
byte, checked).

Tolerance (f32 compute): the loss within 1e-5 relative, each gradient
leaf within a relative L2 of 1e-4 (read: <= 2e-5, zamba2's a_log; the
two sides sum each product in another order).  bf16 compute, remat and
the cross-entropy alone: `test_torch_remat.py`.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch.specs import make_smoke_batch as ref_batch
from repro_torch import interop
from repro_torch.launch.specs import make_smoke_batch
from repro_torch.optim.adamw import tree_leaves
from torch_lm import B, SEED, T, paths, port, reference, rel, smoke, weights

torch.set_num_threads(1)

LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_bundle_loss_and_grads_match_reference(arch):
    cfg = smoke(arch)
    batch = ref_batch(cfg, B, T, "train", seed=SEED)
    tb = make_smoke_batch(interop.arch_config(cfg), B, T, seed=SEED,
                          device="cpu")
    assert sorted(tb) == sorted(batch)
    for k in batch:
        assert tb[k].numpy().tobytes() == np.asarray(batch[k]).tobytes()
    jloss, jgrads = reference(cfg, batch)
    tloss, tgrads = port(cfg, tb)
    assert torch.isfinite(tloss) and tloss.dtype == torch.float32
    assert rel(tloss, jloss) <= LOSS_REL
    _, tp = weights(cfg)
    tleaves = tree_leaves(tgrads)
    assert len(tleaves) == len(tree_leaves(tp)) == len(jax.tree.leaves(
        jgrads))
    for path, g, w in zip(paths(jgrads), tleaves, jax.tree.leaves(jgrads)):
        assert g.shape == w.shape and not g.requires_grad, path
        assert rel(g, w) <= GRAD_REL, (path, rel(g, w))
