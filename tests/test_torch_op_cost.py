"""The port's op-level cost counter (`repro_torch.launch.op_cost`) against
the reference's `jaxpr_cost.step_cost`, on the meta device.

FLOPs: for each family's smoke config at f32, the port's count of the
loss, of the loss and its gradient, of a prefill and of a decode step,
plus the by-design terms of `op_cost.design_terms` (the one-hot
cross-entropy, RWKV6's and Mamba2's einsums written as elementwise
products, autograd's pruning of a one-chunk SSD), equals the reference's
count exactly, at remat none, full and dots.

Bytes: the matmul class equals the reference's `dot_general` bytes once
the one-hot contraction's bytes are added (families without the
einsum terms); the residency is the same bytes, and the total is held
within 20 % by the classes `test_total_bytes` names.

Kernels: each `kernels/ops.py` entry point on meta under a counter with
`fused_kernels=True` charges exactly what `count_jaxpr` charges the
reference's `pallas_call` at the same shapes (padding included), and the
flash charge of a whole encoder prefill equals the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import distance as RD
from repro.kernels import flash_attention as RF
from repro.kernels import frontier_scan as RFS
from repro.kernels import leaf_scan as RL
from repro.kernels import topk as RT
from repro.launch import jaxpr_cost as JC
from repro.models import api as japi
from repro_torch import interop
from repro_torch.core.collectives import StackedShards
from repro_torch.kernels import ops, ref
from repro_torch.launch import op_cost as OC
from repro_torch.launch.specs import make_smoke_batch
from repro_torch.models import api as tapi
from repro_torch.train.loop import value_and_grad
from torch_lm import B, SEED, T, smoke

FAMILIES = ("granite-8b", "granite-moe-1b-a400m", "hubert-xlarge",
            "rwkv6-3b", "zamba2-1.2b", "gemma3-12b", "llava-next-mistral-7b")
KINDS = ("loss", "grad", "prefill", "decode")
_DT = {torch.int32: jnp.int32, torch.float32: jnp.float32,
       torch.bool: jnp.bool_}


def _sds(batch):
    return {k: jax.ShapeDtypeStruct(tuple(v.shape), _DT[v.dtype])
            for k, v in batch.items()}


def _meta(batch):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def bundles(arch, remat="none"):
    cfg = dataclasses.replace(smoke(arch), remat=remat)
    jb = japi.build_model(cfg)
    tb = tapi.build_model(interop.arch_config(cfg))
    jp = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    return cfg, jb, tb, jp, tb.init(0, "meta")


def _steps(arch, kind, remat="none"):
    """((reference fn, reference args), (port fn, port args))."""
    cfg, jb, tb, jp, tp = bundles(arch, remat)
    tcfg = tb.cfg
    if kind in ("loss", "grad"):
        b = make_smoke_batch(tcfg, B, T, seed=SEED, device="cpu")
        if kind == "loss":
            return (jb.loss, (jp, _sds(b))), (tb.loss, (tp, _meta(b)))
        return ((jax.value_and_grad(jb.loss), (jp, _sds(b))),
                (lambda p, x: value_and_grad(tb.loss, p, x), (tp, _meta(b))))
    if kind == "prefill":
        b = make_smoke_batch(tcfg, B, T, kind="prefill", seed=SEED,
                             device="cpu")
        return (jb.prefill, (jp, _sds(b))), (tb.prefill, (tp, _meta(b)))
    b = make_smoke_batch(tcfg, B, T, kind="decode", seed=SEED, device="cpu")
    jc = jax.eval_shape(lambda: jb.init_cache(B, T))
    tc = tb.init_cache(B, T, "meta")
    return ((lambda p, c, x: jb.decode(p, c, x, jnp.int32(T - 1)),
             (jp, jc, _sds(b))),
            (lambda p, c, x: tb.decode(p, c, x, T - 1), (tp, tc, _meta(b))))


@functools.lru_cache(maxsize=None)
def ref_jaxpr(arch, kind, remat="none"):
    (rf, ra), _ = _steps(arch, kind, remat)
    return jax.make_jaxpr(rf)(*ra)


def _ref_step_cost(closed):
    """`jaxpr_cost.step_cost` on a traced jaxpr (one trace serves the
    FLOP and the byte tests; `test_ref_step_cost_is_the_references`)."""
    c = JC.count_jaxpr(closed.jaxpr)
    io = sum(JC._aval_bytes(v.aval) for v in closed.jaxpr.invars) + \
        sum(JC._aval_bytes(v.aval) for v in closed.jaxpr.outvars)
    return JC.Cost(c.flops, c.bytes + io)


@functools.lru_cache(maxsize=None)
def counts(arch, kind, remat="none"):
    """(reference Cost, port Cost, port counter, design terms)."""
    _, (pf, pa) = _steps(arch, kind, remat)
    counter = OC.CostCounter()
    port = OC.step_cost(pf, *pa, counter=counter)
    cfg = bundles(arch, remat)[0]
    return _ref_step_cost(ref_jaxpr(arch, kind, remat)), port, counter, \
        OC.design_terms(cfg, kind, B, T)


def test_ref_step_cost_is_the_references():
    (rf, ra), _ = _steps("granite-8b", "loss")
    assert _ref_step_cost(ref_jaxpr("granite-8b", "loss")) == \
        JC.step_cost(rf, *ra)


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in FAMILIES for k in KINDS
    if not (a == "hubert-xlarge" and k == "decode")])   # no decode step
def test_flops_equal_the_reference(arch, kind):
    want, port, _, terms = counts(arch, kind)
    assert port.flops + sum(terms.values()) == want.flops, (port, want,
                                                            terms)


@pytest.mark.parametrize("remat", ("full", "dots"))
@pytest.mark.parametrize("arch", ("granite-8b", "rwkv6-3b", "zamba2-1.2b"))
def test_flops_equal_the_reference_with_remat(arch, remat):
    # the recompute is counted on both sides
    want, port, _, terms = counts(arch, "grad", remat)
    assert port.flops + sum(terms.values()) == want.flops, (port, want,
                                                            terms)
    assert port.flops > counts(arch, "grad")[1].flops


def _ref_classes(jaxpr, acc, mult=1.0):
    """The reference's bytes by primitive class, as `count_jaxpr` charges
    them, and its scan carries under "carry"."""
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            acc["matmul"] = acc.get("matmul", 0.0) + mult * JC._eqn_io_bytes(e)
        elif name == "scan":
            n = e.params["length"]
            _ref_classes(e.params["jaxpr"].jaxpr, acc, mult * n)
            nk, nc = e.params["num_consts"], e.params["num_carry"]
            carry = sum(JC._aval_bytes(a) for a in
                        e.params["jaxpr"].in_avals[nk:nk + nc])
            acc["carry"] = acc.get("carry", 0.0) + mult * 2.0 * carry * n
        elif name in JC._MEM_PRIMS:
            acc[name] = acc.get(name, 0.0) + mult * JC._eqn_io_bytes(e)
        else:
            for k in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = e.params.get(k)
                if sub is not None:
                    _ref_classes(getattr(sub, "jaxpr", sub), acc, mult)
                    break
    return acc


@functools.lru_cache(maxsize=None)
def ref_bytes(arch, kind):
    return _ref_classes(ref_jaxpr(arch, kind).jaxpr, {})


@pytest.mark.parametrize("kind", ("loss", "grad"))
@pytest.mark.parametrize("arch", ("granite-8b", "granite-moe-1b-a400m",
                                  "hubert-xlarge", "llava-next-mistral-7b"))
def test_matmul_bytes_equal_the_reference(arch, kind):
    cfg = bundles(arch)[0]
    classes = cfg.num_classes if cfg.family == "encoder" else cfg.vocab
    # the one-hot product: logits and one-hot in, (B, T) out, f32; its
    # transpose in the backward moves as much
    one_hot = 4.0 * (2 * B * T * classes + B * T) * (2 if kind == "grad"
                                                     else 1)
    got = counts(arch, kind)[2].by_class["matmul"].bytes
    assert got + one_hot == ref_bytes(arch, kind)["matmul"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_total_bytes(arch):
    """Loss and gradient.  The residency is the same bytes exactly.  The
    totals are held within 20 % once two classes are set aside: "carry"
    (the reference's scan carries, 2 x carry x length: its layer scan and
    the recurrences' token and chunk scans; the port has no scan) and
    "pad" (the reference pads the windowed attention's keys and the SSD's
    chunks with `jnp.pad`, charged; the port pads some of them and slices
    others).  What remains differs by class in: the one-hot product and
    the einsum terms of `design_terms` (matmul bytes at 0.65 and 0.75 of
    the reference's for RWKV6 and Zamba2), `reduce_sum` / `reduce_max`
    against torch's fused `mean` / `_softmax`, the embedding's gather and
    its scatter-add gradient, and the MoE's slot dispatch: 0.85-1.05 of
    the reference's over these seven families."""
    want, port, counter, _ = counts(arch, "grad")
    by = {k: c.bytes for k, c in counter.by_class.items()}
    assert set(by) <= set(OC.MEMORY) | {"matmul", "residency"}
    ref = ref_bytes(arch, "grad")
    assert by["residency"] == want.bytes - sum(ref.values())
    kept = port.bytes - by.get("pad", 0.0)
    want_kept = want.bytes - ref.get("carry", 0.0) - ref.get("pad", 0.0)
    assert 0.8 * want_kept <= kept <= 1.2 * want_kept, (by, ref)


def test_design_terms_refuse_what_is_not_derived():
    cfg = dataclasses.replace(smoke("rwkv6-3b"), rwkv_mode="chunked")
    with pytest.raises(NotImplementedError):
        OC.design_terms(cfg, "loss", B, T)
    with pytest.raises(ValueError):
        OC.design_terms(cfg, "train", B, T)


# ---------------------------------------------------------------------------
# hand kernels: the port's charge against the reference's pallas_call
# ---------------------------------------------------------------------------

def _pallas_costs(fn, *args) -> list:
    """count_jaxpr's charge of each pallas_call in fn's jaxpr (times the
    length of the scans around it)."""
    out = []

    def walk(jaxpr, mult):
        for e in jaxpr.eqns:
            name = e.primitive.name
            if name == "pallas_call":
                ins = [v.aval for v in e.invars if hasattr(v, "aval")]
                if (len(ins) == 3 and ins[0].ndim == 4 and ins[1].ndim == 3
                        and ins[1].shape == ins[2].shape):
                    bkv, t, g, hd = ins[0].shape
                    f = 4.0 * bkv * t * g * hd * ins[1].shape[1]
                else:
                    grid = tuple(e.params["grid_mapping"].grid)
                    f = JC.count_jaxpr(e.params["jaxpr"]).flops * float(
                        np.prod(grid))
                out.append(JC.Cost(f, JC._eqn_io_bytes(e)) * mult)
            elif name == "scan":
                walk(e.params["jaxpr"].jaxpr, mult * e.params["length"])
            else:
                for k in ("jaxpr", "call_jaxpr"):
                    sub = e.params.get(k)
                    if sub is not None:
                        walk(getattr(sub, "jaxpr", sub), mult)
    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1.0)
    return out


def _port_charge(name, fn, *args):
    counter = OC.CostCounter(fused_kernels=True)
    with counter:
        out = fn(*args)
    c = counter.by_class.pop(f"kernel:{name}")
    assert not counter.by_class, counter.by_class   # nothing else charged
    assert counter.kernel_calls == {name: 1}
    return c, out


def _m(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _j(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


Q, C, D, N, W, L = 5, 20, 48, 300, 10, 7


def _kernel_cases():
    """(name, reference fn and args, port fn and args, port output shapes)
    at shapes every padding touches: d 48 -> 128, C 20 -> 128 or 24,
    Q 5 -> 8, N 300 -> 384."""
    ip = functools.partial
    return {
        "distance_matrix": (
            ip(RD.distance_matrix_pallas, interpret=True),
            (_j((Q, D)), _j((N, D))),
            ops.distance_matrix, (_m((Q, D)), _m((N, D))), [(Q, N)]),
        "leaf_scan_batched": (
            ip(RL.leaf_scan_batched_pallas, interpret=True),
            (_j((Q, D)), _j((L, C, D), jnp.int8), _j((L, C), jnp.int32),
             _j((D,)), _j((D,)), _j((Q, W), jnp.uint32), _j((L, C))),
            ops.leaf_scan_batched,
            (_m((Q, D)), _m((L, C, D), torch.int8), _m((L, C), torch.int32),
             _m((D,)), _m((D,)), _m((Q, W), torch.int32), _m((L, C))),
            [(Q, L, C)]),
        "leaf_scan": (
            ip(RL.leaf_scan_pallas, interpret=True),
            (_j((D,)), _j((L, C, D), jnp.int8), _j((L, C), jnp.int32),
             _j((D,)), _j((D,)), _j((W,), jnp.uint32)),
            ops.leaf_scan,
            (_m((D,)), _m((L, C, D), torch.int8), _m((L, C), torch.int32),
             _m((D,)), _m((D,)), _m((W,), torch.int32)), [(L, C)]),
        "topk": (
            ip(RT.topk_pallas, interpret=True), (_j((N,)), 10),
            ops.topk_smallest, (_m((N,)), 10), [(10,), (10,)]),
        "frontier_scan": (
            ip(RFS.frontier_scan_pallas, interpret=True),
            (_j((Q, D)), _j((Q, C, D)), _j((Q, C)), _j((Q, C), jnp.int32),
             _j((Q, W), jnp.uint32)),
            ops.frontier_scan,
            (_m((Q, D)), _m((N, D)), _m((N,)), _m((Q, C), torch.int32),
             _m((Q, W), torch.int32)), [(Q, C), (Q, C)]),
        "frontier_scan_sq8": (
            ip(RFS.frontier_scan_sq8_pallas, interpret=True),
            (_j((Q, D)), _j((Q, C, D), jnp.int8), _j((D,)), _j((D,)),
             _j((Q, C)), _j((Q, C), jnp.int32), _j((Q, W), jnp.uint32)),
            ops.frontier_scan_sq8,
            (_m((Q, D)), _m((N, D), torch.int8), _m((D,)), _m((D,)),
             _m((N,)), _m((Q, C), torch.int32), _m((Q, W), torch.int32)),
            [(Q, C), (Q, C)]),
        "frontier_scan_excl": (
            ip(RFS.frontier_scan_excl_pallas, interpret=True),
            (_j((Q, D)), _j((Q, C, D)), _j((Q, C)), _j((Q, C), jnp.int32),
             _j((Q, W), jnp.uint32), _j((Q, C)), _j((Q, 1))),
            ops.frontier_scan_excl,
            (_m((Q, D)), _m((N, D)), _m((N,)), _m((Q, C), torch.int32),
             _m((Q, W), torch.int32), _m((3, N)), _m((Q,), torch.int32),
             _m((Q,))), [(Q, C)] * 3),
        "frontier_scan_excl_sq8": (
            ip(RFS.frontier_scan_excl_sq8_pallas, interpret=True),
            (_j((Q, D)), _j((Q, C, D), jnp.int8), _j((D,)), _j((D,)),
             _j((Q, C)), _j((Q, C), jnp.int32), _j((Q, W), jnp.uint32),
             _j((Q, C)), _j((Q, 1))),
            ops.frontier_scan_excl_sq8,
            (_m((Q, D)), _m((N, D), torch.int8), _m((D,)), _m((D,)),
             _m((N,)), _m((Q, C), torch.int32), _m((Q, W), torch.int32),
             _m((3, N)), _m((Q,), torch.int32), _m((Q,))), [(Q, C)] * 3),
        "flash_attention": (
            ip(RF.flash_attention_pallas, causal=False, interpret=True),
            (_j((2, 700, 4, 32)), _j((2, 700, 2, 32)), _j((2, 700, 2, 32))),
            ops.flash_attention_fused,
            (_m((2, 700, 4, 32)), _m((2, 700, 2, 32)), _m((2, 700, 2, 32)),
             False), [(2, 700, 4, 32)]),
    }


@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_kernel_charge_equals_the_reference_pallas_call(name):
    rfn, rargs, pfn, pargs, shapes = _kernel_cases()[name]
    static = [a for a in rargs if not isinstance(a, jax.ShapeDtypeStruct)]
    dyn = [a for a in rargs if isinstance(a, jax.ShapeDtypeStruct)]
    want = _pallas_costs(lambda *a: rfn(*a, *static), *dyn)
    assert len(want) == 1
    got, out = _port_charge(name, pfn, *pargs)
    assert (got.flops, got.bytes) == (want[0].flops, want[0].bytes)
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.device.type == "meta" for o in outs)


def test_leaf_scan_ids_charges_the_opened_tiles_of_each_query():
    # the reference vmaps its one-query kernel over the queries: the
    # pallas_call's operands are each query's opened tiles, not the table
    nl = 3
    want = _pallas_costs(
        jax.vmap(lambda q, t, r, bm: RL.leaf_scan_pallas(
            q, t, r, jnp.zeros((D,)), jnp.zeros((D,)), bm,
            interpret=True), in_axes=(0, 0, 0, 0)),
        _j((Q, D)), _j((Q, nl, C, D), jnp.int8), _j((Q, nl, C), jnp.int32),
        _j((Q, W), jnp.uint32))
    got, out = _port_charge(
        "leaf_scan", ops.leaf_scan_ids, _m((Q, D)),
        _m((Q, nl), torch.int32), _m((L, C, D), torch.int8),
        _m((L, C), torch.int32), _m((D,)), _m((D,)),
        _m((Q, W), torch.int32))
    assert (got.flops, got.bytes) == (want[0].flops, want[0].bytes)
    assert tuple(out.shape) == (Q, nl, C)


def test_flash_charge_of_an_encoder_prefill_equals_the_reference():
    cfg = dataclasses.replace(smoke("hubert-xlarge"), pallas_flash=True)
    jb = japi.build_model(cfg)
    tb = tapi.build_model(interop.arch_config(cfg))
    jp = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    for t in (32, 700):         # 700: both lengths padded to 1,024
        frames = (2, t, cfg.d_model)
        want = _pallas_costs(jb.prefill, jp, {"frames": _j(frames)})
        counter = OC.CostCounter(fused_kernels=True)
        port = OC.step_cost(tb.prefill, tb.init(0, "meta"),
                            {"frames": _m(frames)}, counter=counter)
        c = counter.by_class["kernel:flash_attention"]
        assert counter.kernel_calls == {"flash_attention": cfg.n_layers}
        assert (c.flops, c.bytes) == (sum(w.flops for w in want),
                                      sum(w.bytes for w in want))
        assert port.flops == JC.step_cost(jb.prefill, jp, {
            "frames": _j(frames)}).flops


# ---------------------------------------------------------------------------
# the counter's own rules
# ---------------------------------------------------------------------------

def test_kernel_paths_off_the_card():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 16, generator=g)
    x = torch.randn(30, 16, generator=g)
    plain = ref.distance_matrix_ref(q, x)
    # no counter: the CPU runs the plain version, meta has no kernel
    assert torch.equal(ops.distance_matrix(q, x), plain)
    with pytest.raises(ValueError, match="meta"):
        ops.distance_matrix(_m((4, 16)), _m((30, 16)))
    # fused on the CPU: charged as the kernel, the values the plain ones
    got, out = _port_charge("distance_matrix", ops.distance_matrix, q, x)
    assert torch.equal(out, plain) and got.flops == 2.0 * 8 * 128 * 128
    # not fused: the plain version's ops are charged, no kernel
    counter = OC.CostCounter(fused_kernels=False)
    with counter:
        assert torch.equal(ops.distance_matrix(q, x), plain)
    assert counter.kernel_calls == {}
    assert counter.by_class["matmul"].flops == 2.0 * 4 * 30 * 16
    # the cos frontier scan has no kernel: always its plain version
    counter = OC.CostCounter(fused_kernels=True)
    with counter:
        ops.frontier_scan(_m((4, 16)), _m((30, 16)), _m((30,)),
                          _m((4, 5), torch.int32), _m((4, 1), torch.int32),
                          "cos")
    assert counter.kernel_calls == {}
    assert OC.ACTIVE is None


def test_collectives_report_their_result_and_not_their_arithmetic():
    coll = StackedShards(4)
    x = torch.ones(4, 3, 5)
    counter = OC.CostCounter()
    with counter:
        coll.all_gather(x)
        coll.sum(x)
        coll.min(x[:, :, :2].contiguous())
        coll.max(x.to(torch.int32))
    assert counter.collectives == {"all-gather": 4 * 3 * 5 * 4.0,
                                   "all-reduce": 4.0 * (15 + 6 + 15)}
    assert counter.by_class == {}
    # no counter: nothing is recorded anywhere
    assert torch.equal(coll.sum(x), x.sum(0))


def test_step_cost_charges_residency_once_and_classes():
    a, b = _m((8, 16)), _m((16, 4))
    counter = OC.CostCounter()
    cost = OC.step_cost(lambda x, y: torch.sort((x @ y).sum(0)).values,
                        a, b, counter=counter)
    mm = 2.0 * 8 * 4 * 16
    assert cost.flops == mm
    by = {k: c.bytes for k, c in counter.by_class.items()}
    assert by["matmul"] == 4.0 * (8 * 16 + 16 * 4 + 8 * 4)
    assert by["reduce"] == 4.0 * (8 * 4 + 4)
    assert by["sort"] == 4.0 * 4 + (4.0 * 4 + 8.0 * 4)   # values, indices
    assert by["residency"] == 4.0 * (8 * 16 + 16 * 4 + 4)
    assert cost.bytes == sum(by.values())
    assert (OC.Cost(1, 2) + OC.Cost(3, 4)) * 2 == OC.Cost(8, 12)
