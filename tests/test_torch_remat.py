"""The training losses at bf16 compute, remat and the cross-entropy in
the port (`models.layers.softmax_xent`, `transformer._remat`,
`vlm.vlm_loss`) against the reference on the CPU, at smoke size (the
bundles' f32 losses and gradients: `test_torch_losses.py`).

Tolerance: bf16 compute, by the ratio rule of the model files
(`test_torch_bf16_families.py`): each gradient leaf rel(port, ref bf16)
<= 2 x rel(ref bf16, ref f32) (read: <= 1.02 over 3 seeds), and the
loss, a scalar whose reference bf16-vs-f32 reading can be arbitrarily
small, within 1e-3 of the reference's bf16 loss (a mean of 64 token
losses, each at bf16's 2^-8; read <= 4.1e-4).  softmax_xent within 1e-5
relative.  Remat modes: bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.specs import make_smoke_batch as ref_batch
from repro.models import layers as jl
from repro_torch import interop
from repro_torch.launch.specs import make_smoke_batch
from repro_torch.models import api as tapi
from repro_torch.models import layers as tl
from repro_torch.optim.adamw import tree_leaves
from torch_lm import B, SEED, T, paths, port, reference, rel, smoke, weights

torch.set_num_threads(1)

LOSS_REL = 1e-5
MODEL_RATIO = 2.0
BF16_LOSS_REL = 1e-3


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b"])
def test_bf16_loss_and_grads_within_reference_rounding(arch):
    # one dense and one SSM family at bf16 compute (the published one)
    f32 = smoke(arch)
    bf = dataclasses.replace(f32, compute_dtype="bfloat16")
    batch = ref_batch(f32, B, T, "train", seed=SEED)
    jf_loss, jf_grads = reference(f32, batch)
    jb_loss, jb_grads = reference(bf, batch)
    t_loss, t_grads = port(bf)
    assert rel(t_loss, jb_loss) <= BF16_LOSS_REL
    readings = {p: (rel(g, b), rel(b, f)) for p, g, b, f in zip(
        paths(jb_grads), tree_leaves(t_grads), jax.tree.leaves(jb_grads),
        jax.tree.leaves(jf_grads))}
    bad = {p: r for p, r in readings.items() if r[0] > MODEL_RATIO * r[1]}
    assert not bad, bad


def test_softmax_xent_matches_reference_with_partial_and_empty_masks():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 5, 11) * 3).astype(np.float32)
    targets = rng.randint(0, 11, (2, 5)).astype(np.int32)
    partial = (rng.rand(2, 5) < 0.5).astype(np.float32)
    for mask in (np.ones((2, 5), np.float32), partial,
                 np.zeros((2, 5), np.float32)):
        want = jl.softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                               jnp.asarray(mask))
        x = torch.as_tensor(logits).requires_grad_(True)
        got = tl.softmax_xent(x, torch.as_tensor(targets),
                              torch.as_tensor(mask))
        assert rel(got, want) <= LOSS_REL or \
            float(want) == float(got.detach()) == 0
        gw = jax.grad(lambda z: jl.softmax_xent(z, jnp.asarray(targets),
                                                jnp.asarray(mask)))(
            jnp.asarray(logits))
        (gg,) = torch.autograd.grad(got, x)
        np.testing.assert_allclose(gg.numpy(), np.asarray(gw), rtol=1e-5,
                                   atol=1e-7)
    # an all-zero mask: a zero loss (divided by max(0, 1)), no NaN
    assert float(got.detach()) == 0.0 and float(gg.abs().sum()) == 0.0


def test_softmax_xent_bf16_logits_run_in_f32():
    rng = np.random.RandomState(1)
    logits = torch.as_tensor(rng.randn(3, 7).astype(np.float32)).to(
        torch.bfloat16)
    t = torch.as_tensor(rng.randint(0, 7, 3))
    got = tl.softmax_xent(logits, t, torch.ones(3))
    want = torch.nn.functional.cross_entropy(logits.float(), t)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6


def test_vlm_loss_leaves_the_callers_mask_untouched():
    cfg = interop.arch_config(smoke("llava-next-mistral-7b"))
    _, tp = weights(smoke("llava-next-mistral-7b"))
    batch = make_smoke_batch(cfg, B, T, seed=SEED, device="cpu")
    mask = batch["mask"].clone()
    loss = tapi.build_model(cfg).loss(tp, batch)
    assert torch.equal(batch["mask"], mask)
    # the patch prefix is out of the loss: a mask already zero there
    # gives the same loss
    cut = dict(batch, mask=mask.clone())
    cut["mask"][:, :cfg.num_patches] = 0.0
    assert float(tapi.build_model(cfg).loss(tp, cut)) == float(loss)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma3-12b",
                                  "granite-moe-1b-a400m", "hubert-xlarge",
                                  "rwkv6-3b", "zamba2-1.2b"])
def test_remat_modes_give_bit_equal_loss_and_grads(arch):
    # "dots" saves the plain matmuls, "full" only each layer's inputs:
    # the recompute runs the same operations (the MoE routing included)
    outs = {r: port(smoke(arch, remat=r)) for r in ("none", "dots", "full")}
    base_loss, base_grads = outs["none"]
    for r in ("dots", "full"):
        loss, grads = outs[r]
        assert torch.equal(loss, base_loss), r
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(grads), tree_leaves(base_grads))), r


def test_remat_dots_saves_the_plain_matmuls(monkeypatch):
    from repro_torch.models import transformer as ttfm
    seen = {}
    real = ttfm._save_dots

    def spy(ctx, op, *a, **kw):
        decision = real(ctx, op, *a, **kw)
        seen.setdefault(str(op), set()).add(str(decision))
        return decision

    monkeypatch.setattr(ttfm, "_save_dots", spy)
    port(smoke("granite-moe-1b-a400m", remat="dots"))
    assert seen["aten.mm.default"] == {"CheckpointPolicy.MUST_SAVE"}
    # batched products (attention, the experts) are recomputed
    assert seen["aten.bmm.default"] == {"CheckpointPolicy.PREFER_RECOMPUTE"}


def test_serving_paths_keep_no_graph_under_remat():
    # prefill and decode run as before with remat on: no checkpoint
    # wrapper without autograd, the same logits as with remat "none"
    cfg = interop.arch_config(smoke("llama3.2-3b", remat="full"))
    _, tp = weights(smoke("llama3.2-3b"))
    toks = make_smoke_batch(cfg, B, T, kind="prefill", seed=SEED,
                            device="cpu")
    with torch.inference_mode():
        a = tapi.build_model(cfg).prefill(tp, toks)
        b = tapi.build_model(dataclasses.replace(cfg, remat="none")
                             ).prefill(tp, toks)
    assert torch.equal(a, b) and a.grad_fn is None
