"""The port's optimizer (`repro_torch.optim`: AdamW, the cosine schedule,
int8 error-feedback compression) against the reference's on the CPU, on
seeded numpy trees with float32 and bfloat16 leaves.

Tolerance: float32 results within a relative L2 of 1e-6 of the
reference's (the two sum the global norm in another order, one ulp
apart, and XLA may fuse a product and a sum); bfloat16 results within one
bfloat16 ulp elementwise (rtol 2^-7): a float32 difference of an ulp
before the cast can move one rounding.  With bfloat16 moments, such a
moved rounding (2^-8 of a moment) reaches the next step's float32 params
through lr x update: those are held within REL_BF16_STATES = 1e-4 (read:
1.4e-6 with the clip active, where the norm's ulp enters; under 1e-7
without it).  int8 codes are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compression as RC
from repro_torch import interop
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC

torch.set_num_threads(1)

REL = 1e-6
REL_BF16_STATES = 1e-4
BF16_RTOL = 2.0 ** -7


def tree(seed: int, scale: float = 1.0) -> dict:
    r = np.random.RandomState(seed)
    return {"a": {"w": (r.randn(33, 17) * scale).astype(np.float32),
                  "b": (r.randn(7) * scale).astype(np.float32)},
            "h": (r.randn(5, 40) * scale).astype(ml_dtypes.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def assert_tree_close(got, want, rel=REL):
    """Leaves in the reference's order: f32 and integer leaves within
    `rel` (relative L2), bf16 leaves within one ulp elementwise."""
    gl = jax.tree.leaves(jax.tree.map(lambda t: t, got))
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        if np.asarray(w).dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_RTOL,
                                       atol=0)
        else:
            a, b = _np(g), _np(w)
            assert np.linalg.norm(a - b) <= rel * max(np.linalg.norm(b),
                                                      1e-30)


def _configs(state_dtype: str, clip: float):
    cfg = RA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         grad_clip=clip, state_dtype=state_dtype)
    return cfg, TA.AdamWConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("clip", [0.05, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(state_dtype, clip, donate):
    cfg, tcfg = _configs(state_dtype, clip)
    jp = jax.tree.map(jnp.asarray, tree(0))
    tp = interop.lm_params(tree(0), "cpu")
    js, ts = RA.adamw_init(jp, cfg), TA.adamw_init(tp, tcfg)
    assert_tree_close(ts, js)
    update = jax.jit(RA.adamw_update, static_argnums=3)
    rel = REL if state_dtype == "float32" else REL_BF16_STATES
    for step in range(3):
        g = tree(10 + step, 3.0)
        before = tp
        jp, js, jm = update(jp, jax.tree.map(jnp.asarray, g), js, cfg)
        tp, ts, tm = TA.adamw_update(tp, interop.lm_params(g, "cpu"), ts,
                                     tcfg, donate=donate)
        # with donate the given tensors hold the new values
        assert (tp["a"]["w"] is before["a"]["w"]) == donate
        assert_tree_close(tp, jp, rel)
        assert_tree_close(ts, js, rel)
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                REL * abs(float(jm[key]))
    gnorm = float(jm["grad_norm"])
    # the clip is active in one case and not in the other
    assert (gnorm > clip) == (clip < 1)
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32


def test_adamw_update_leaves_its_inputs_without_donate():
    _, tcfg = _configs("float32", 1.0)
    tp = interop.lm_params(tree(0), "cpu")
    keep = {k: v.clone() for k, v in tp["a"].items()}
    ts = TA.adamw_init(tp, tcfg)
    TA.adamw_update(tp, interop.lm_params(tree(1), "cpu"), ts, tcfg)
    assert all(torch.equal(tp["a"][k], keep[k]) for k in keep)
    assert int(ts["step"]) == 0 and float(ts["m"]["a"]["w"].abs().sum()) == 0


@pytest.mark.parametrize("step", [0, 1, 2, 3, 50, 99, 100, 130])
def test_cosine_schedule_matches_reference(step):
    # warm-up (0-2), the middle and the end (100), and past it
    cfg = RA.AdamWConfig(lr=3e-4, warmup_steps=3, total_steps=100)
    want = float(RA.cosine_schedule(cfg, jnp.int32(step)))
    got = TA.cosine_schedule(TA.AdamWConfig(**dataclasses.asdict(cfg)),
                             torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= REL * max(abs(want), 1e-30)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_compress_int8_matches_reference(scale):
    x = (np.random.RandomState(3).randn(4000) * scale).astype(np.float32)
    x[:3] = [0.5 * scale, -0.5 * scale, 0.0]
    q, s = RC.compress_int8(jnp.asarray(x))
    tq, ts = TC.compress_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert abs(float(ts) - float(s)) <= REL * float(s)
    np.testing.assert_allclose(TC.decompress_int8(tq, ts).numpy(),
                               np.asarray(RC.decompress_int8(q, s)),
                               rtol=REL, atol=0)


def test_compress_int8_rounds_half_to_even():
    # 2.5 and 3.5 quanta round to 2 and 4, as jnp.round does
    x = torch.tensor([127.0, 2.5, 3.5, -2.5, -0.5])
    q, s = TC.compress_int8(x)
    assert float(s) == 1.0
    assert q.tolist() == [127, 2, 4, -2, 0]
    jq, _ = RC.compress_int8(jnp.asarray(x.numpy()))
    assert np.asarray(jq).tolist() == q.tolist()


def test_ef_compress_grads_matches_reference_over_steps():
    grads = [tree(20 + i, 2.0) for i in range(3)]
    jerr = RC.init_error_buffers(jax.tree.map(jnp.asarray, grads[0]))
    terr = TC.init_error_buffers(interop.lm_params(grads[0], "cpu"))
    assert all(t.dtype == torch.float32 for t in TA.tree_leaves(terr))
    for g in grads:
        jg, jerr = RC.ef_compress_grads(jax.tree.map(jnp.asarray, g), jerr)
        tg, terr = TC.ef_compress_grads(interop.lm_params(g, "cpu"), terr)
        assert_tree_close(tg, jg)
        assert_tree_close(terr, jerr)
    # the residual is what the round trip lost
    last = interop.lm_params(grads[-1], "cpu")
    assert float(TA.tree_leaves(terr)[0].abs().max()) > 0
    assert tg["a"]["w"].dtype == last["a"]["w"].dtype


def test_optim_exports_match_reference():
    import repro.optim as R
    import repro_torch.optim as T
    assert T.__all__ == R.__all__
