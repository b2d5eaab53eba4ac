"""Op-level cost accounting of a step: FLOPs and memory-bound bytes.

The counterpart of the reference's `launch/jaxpr_cost.py`.  The port has
no jaxpr: `step_cost(fn, *args)` runs `fn` under a `TorchDispatchMode`
(`CostCounter`) on whatever device the args lie on and charges every aten
op it sees, the backward's and a remat's recompute included.  On the meta
device nothing is computed or allocated (the dry runs); on the card the
step runs and is counted the same (the anchors).

Charges, as the reference's `count_jaxpr`:

* FLOPs: 2 x output elements x contracted size for each product
  (`aten.mm`, `addmm`, `bmm`, `baddbmm`, `dot`, `mv`: `_dot_flops`);
  convolutions 2 x output elements x (kernel extent x input channels a
  group) (`_conv_flops`; `convolution_backward` charges each gradient it
  computes).  Nothing else has FLOPs.
* Bytes, operands plus results, only for the memory-bound classes
  (`_MEM_PRIMS`); elementwise, view and copy ops cost 0, assumed fused.
  Class (the reference's primitives): the aten ops charged.

  - matmul (`dot_general`): mm, addmm, bmm, baddbmm, dot, mv;
  - conv (`conv_general_dilated`): convolution, convolution_backward;
  - gather (`gather`, `dynamic_slice`): gather, index, index_select,
    embedding, take;
  - scatter (`scatter`, `scatter-add`, `dynamic_update_slice`): scatter,
    scatter_add, scatter_reduce, index_put, index_add, index_copy,
    embedding_dense_backward, masked_scatter;
  - reduce (`reduce_sum` / `_max` / `_min` / `_prod`, `argmax`,
    `argmin`, `reduce_window`): sum, mean, amax, amin, max / min over a
    dim, prod, argmax, argmin, any, all, logsumexp, _softmax,
    _log_softmax and their backward;
  - sort (`sort`, `top_k`): sort, topk, kthvalue;
  - scan (`cumsum`, `cumlogsumexp`, `cummax`): cumsum, cumprod,
    logcumsumexp, cummax, cummin;
  - concat (`concatenate`): cat; pad (`pad`): constant_pad_nd; rev
    (`rev`): flip; iota (`iota`): arange;
  - rng (`rng_bit_generator`, `random_bits`): normal_, uniform_,
    bernoulli, random_, randn, rand, randint, randperm, exponential_.

* Residency: the inputs and outputs of the step once (`step_cost`).
* Hand kernels: a `kernels/ops.py` entry point called while a counter is
  open charges its call as the reference charges a `pallas_call`: the
  operands the reference passes its kernel (padded as it pads them) plus
  the outputs, once, and the kernel's arithmetic in FLOPs (flash
  attention 4 x B·KV x T x G x hd x S over the padded lengths, as
  `count_jaxpr` recognises it).  On the card the kernel launches; on meta
  with `fused_kernels=True` the entry point returns empty outputs of the
  kernel's shapes; with `fused_kernels=False` meta and the CPU run the
  plain version op by op (the reference's `use_pallas=False` path).  The
  ops inside a charged call are not charged again.
* Collectives: `core.collectives.StackedShards` / `GroupShards` report
  each `all_gather` / `sum` / `min` / `max` as the bytes of its result on
  one position, by kind ("all-gather", "all-reduce"): the reference's
  result-shape rule (`dryrun.collective_bytes`).  Their local arithmetic
  is not charged (the reference's collectives are not `_MEM_PRIMS`).

Where the count differs from the reference's by design, by op (each
term's formula is `design_terms`, which `tests/test_torch_op_cost.py`
adds to the port's count to read the reference's, exactly):

* No scan carries.  The port's layers are a Python loop and its
  recurrences Python loops over tokens or chunks: there is no `scan` whose
  carry the reference charges 2 x carry bytes x length
  (`jaxpr_cost.py:91-97`).  Bytes only.
* `one_hot_xent`: `models/layers.py:softmax_xent` takes the label's
  log-prob with a gather where the reference contracts a one-hot
  (`src/repro/models/layers.py:505-506`): 2 x tokens x classes FLOPs in
  the forward and as many in the backward.
* `rwkv_kv_outer`: RWKV6's token scan forms k (x) v as an elementwise
  product where the reference writes an einsum without a contracted dim
  (`jnp.einsum("bhc,bhd->bhcd")`, a `dot_general` the count charges):
  2 x B x H x 64 x 64 a token a layer, three times with a gradient (the
  two transposes), four with remat (the recompute).
* `mamba_einsum_pairs`: the reference's three-operand einsums of the
  chunked SSD (`bcqk,bcqkh,bckhp`, `bcqh,bcqhp,bcqn`, `bcqn,bchpn,bcqh`)
  contract their first pair as an outer product; the port multiplies
  that pair elementwise: 2 x B x nc x Q x H x (Q + 2N) a layer, three
  times with a gradient, once more for each rematerialised layer (the
  groups', not the tail's).
* `mamba_one_chunk_grads`: with one chunk (T <= Q) the port's inter-chunk
  state is the initial zeros and the chunk's summary feeds only the final
  state, so autograd computes no gradient through either; the reference
  transposes through its chunk scan all the same: 3 x 2 x B x Q x H x P x
  N a layer.  The values are the same (those cotangents are zero).
* `mamba_conv_taps`, `mamba_state_outer` (decode): the reference's
  `einsum("bkd,kd->bd")` over the 4 conv taps and its outer product
  `einsum("bhp,bn->bhpn")`; the port sums the taps' products and
  multiplies elementwise: 2 x B x d_inner x 4 and 2 x B x H x P x N a
  layer.
* RWKV6's chunked mode (a perf variant no shipped config selects) is not
  derived: `design_terms` refuses it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


# The open counter, or None: the one test a kernel entry point and a
# collective make when nothing is counted.
ACTIVE: "CostCounter | None" = None


def nbytes(x) -> float:
    """Bytes of every tensor in `x` (a tensor or any nest of them)."""
    return float(sum(t.numel() * t.element_size()
                     for t in tree_flatten(x)[0]
                     if isinstance(t, torch.Tensor)))


def _packets(*ops) -> frozenset:
    return frozenset(getattr(aten, o) for o in ops if hasattr(aten, o))


MATMUL = _packets("mm", "addmm", "bmm", "baddbmm", "dot", "mv")
CONV = _packets("convolution", "convolution_backward")
MEMORY = {
    "gather": _packets("gather", "index", "index_select", "embedding",
                       "take", "_unsafe_index"),
    "scatter": _packets("scatter", "scatter_", "scatter_add",
                        "scatter_add_", "scatter_reduce", "scatter_reduce_",
                        "index_put", "index_put_", "_index_put_impl_",
                        "index_add", "index_add_", "index_copy",
                        "index_copy_", "embedding_dense_backward",
                        "masked_scatter", "_unsafe_index_put"),
    "reduce": _packets("sum", "mean", "amax", "amin", "max", "min", "prod",
                       "argmax", "argmin", "any", "all", "logsumexp",
                       "_softmax", "_log_softmax", "_softmax_backward_data",
                       "_log_softmax_backward_data"),
    "sort": _packets("sort", "topk", "kthvalue"),
    "scan": _packets("cumsum", "cumsum_", "cumprod", "logcumsumexp",
                     "cummax", "cummin"),
    "concat": _packets("cat"),
    "pad": _packets("constant_pad_nd"),
    "rev": _packets("flip"),
    "iota": _packets("arange"),
    "rng": _packets("normal", "normal_", "uniform", "uniform_",
                    "bernoulli", "bernoulli_", "random_", "randn", "rand",
                    "randint", "randperm", "exponential_"),
}
_CLASS_OF = {op: cls for cls, ops in MEMORY.items() for op in ops}
_MAX_MIN = _packets("max", "min")


def _dot_flops(op, args, out) -> float:
    """2 x output elements x contracted size (`_dot_flops`)."""
    if op in (aten.addmm, aten.baddbmm):
        lhs = args[1]
    else:
        lhs = args[0]
    k = lhs.shape[-1] if lhs.dim() else 1
    return 2.0 * float(out.numel()) * float(k)


def _conv_flops(op, args, out) -> float:
    """2 x output elements x (kernel extent x input channels a group),
    for the forward and for each gradient a backward computes."""
    if op is aten.convolution:
        w = args[1]
        return 2.0 * float(out.numel()) * float(math.prod(w.shape[1:]))
    grad_out, _, w = args[0], args[1], args[2]
    mask = args[-1]
    per = 2.0 * float(grad_out.numel()) * float(math.prod(w.shape[1:]))
    return per * float(sum(bool(m) for m in mask[:2]))


_DECOMPOSES: dict = {}


def _decomposes(func) -> bool:
    """Whether `func` has a CompositeImplicitAutograd kernel (autograd
    decomposes such ops before a dispatch mode sees them, but not under
    `torch.inference_mode`)."""
    hit = _DECOMPOSES.get(func)
    if hit is None:
        hit = _DECOMPOSES[func] = bool(
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"))
    return hit


class CostCounter(TorchDispatchMode):
    """Charges each aten op run under it (see the module's docstring).
    `fused_kernels` says what a hand kernel's entry point does off the
    card: charge the kernel (and on meta return empty outputs of its
    shapes) or run its plain version op by op.  On the card the kernel
    launches and is charged whatever the flag."""

    def __init__(self, fused_kernels: bool = False):
        super().__init__()
        self.fused_kernels = bool(fused_kernels)
        self.by_class: dict[str, Cost] = {}
        self.collectives: dict[str, float] = {}
        self.kernel_calls: dict[str, int] = {}
        self._paused = 0
        self._outer: list = []

    # -- totals ----------------------------------------------------------
    @property
    def total(self) -> Cost:
        out = Cost()
        for c in self.by_class.values():
            out = out + c
        return out

    def charge(self, cls: str, flops: float = 0.0, nbytes_: float = 0.0):
        c = self.by_class.setdefault(cls, Cost())
        c.flops += float(flops)
        c.bytes += float(nbytes_)

    @contextlib.contextmanager
    def paused(self):
        """Ops run inside are not charged, and no counter is open for the
        entry points and collectives called there (a charged kernel's or
        collective's own work)."""
        global ACTIVE
        self._paused += 1
        saved, ACTIVE = ACTIVE, None
        try:
            yield
        finally:
            ACTIVE = saved
            self._paused -= 1

    def kernel(self, name: str, flops: float, nbytes_: float) -> None:
        self.charge(f"kernel:{name}", flops, nbytes_)
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def collective(self, kind: str, result: torch.Tensor) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0.0) \
            + nbytes(result)

    # -- the mode --------------------------------------------------------
    def __enter__(self):
        global ACTIVE
        self._outer.append(ACTIVE)
        ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._outer.pop()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if _decomposes(func):
            # a composite op (`matmul`, `einsum`, `to` under inference
            # mode) is charged by the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        op = func.overloadpacket
        if op in MATMUL:
            res = out
            self.charge("matmul", _dot_flops(op, args, res),
                        nbytes((args, kwargs)) + nbytes(out))
        elif op in CONV:
            first = out[0] if isinstance(out, (tuple, list)) else out
            flops = _conv_flops(op, args, first)
            self.charge("conv", flops, nbytes((args, kwargs)) + nbytes(out))
        else:
            cls = _CLASS_OF.get(op)
            if cls is not None and not (op in _MAX_MIN and not isinstance(
                    out, (tuple, list)) and len(args) > 1
                    and isinstance(args[1], torch.Tensor)):
                # max / min of two tensors is elementwise, not a reduction
                self.charge(cls, 0.0, nbytes((args, kwargs)) + nbytes(out))
        return out


def step_cost(fn: Callable, *args,
              counter: CostCounter | None = None) -> Cost:
    """Cost of `fn(*args)` on the args' device, the inputs' and outputs'
    residency charged once (the reference's `step_cost`).  Pass a
    `counter` to choose `fused_kernels` and to read its breakdown by
    class, its collectives and its kernel calls afterwards."""
    counter = counter or CostCounter()
    with counter:
        out = fn(*args)
    counter.charge("residency", 0.0, nbytes(args) + nbytes(out))
    return counter.total


# ---------------------------------------------------------------------------
# Where the reference's count differs by design (held by the tests)
# ---------------------------------------------------------------------------

def design_terms(cfg, kind: str, batch: int, seq: int) -> dict[str, float]:
    """FLOPs the reference's count holds and the port's does not, by op
    (the module's docstring), for one step of `kind`: "loss", "grad" (the
    loss and its gradient, as in a train step), "prefill" or "decode",
    at `batch` x `seq` tokens (the decode's cache length is irrelevant)."""
    if kind not in ("loss", "grad", "prefill", "decode"):
        raise ValueError(f"unknown step kind {kind!r}")
    grad = kind == "grad"
    remat = grad and cfg.remat != "none"
    terms: dict[str, float] = {}
    if kind in ("loss", "grad"):
        classes = cfg.num_classes if cfg.family == "encoder" else cfg.vocab
        terms["one_hot_xent"] = 2.0 * batch * seq * classes * (1 + grad)
    if cfg.family == "ssm":
        if cfg.rwkv_mode != "scan":
            raise NotImplementedError("RWKV6's chunked mode: its terms are "
                                      "not derived")
        tokens = 1 if kind == "decode" else seq
        fwd = cfg.n_layers * tokens * 2.0 * batch * (cfg.d_model // 64) \
            * 64 * 64
        terms["rwkv_kv_outer"] = fwd * ((3 + remat) if grad else 1)
    if cfg.family == "hybrid":
        d_in = 2 * cfg.d_model
        h, p, n = d_in // 64, 64, cfg.ssm_state
        if kind == "decode":
            terms["mamba_conv_taps"] = cfg.n_layers * 2.0 * batch * d_in * 4
            terms["mamba_state_outer"] = cfg.n_layers * 2.0 * batch * h \
                * p * n
        else:
            q = cfg.ssm_chunk
            nc = -(-seq // q)
            per = 2.0 * batch * nc * q * h * (q + 2 * n)
            grouped = cfg.n_layers // cfg.attn_every * cfg.attn_every
            terms["mamba_einsum_pairs"] = per * (
                cfg.n_layers * (3 if grad else 1) + (grouped if remat
                                                     else 0))
            if grad and nc == 1:
                terms["mamba_one_chunk_grads"] = cfg.n_layers * 3 * 2.0 \
                    * batch * q * h * p * n
    return terms
