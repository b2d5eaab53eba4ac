"""Time a parent commit's hand-written kernels beside this checkout's, in one
process on one card.

    mkdir -p build/parent
    git show <parent>:src/repro_torch/kernels/csrc/leaf_scan.cu \\
        > build/parent/leaf_scan.cu
    python3 tools_torch/time_kernel_redesign.py --parent build/parent \\
        --kernels leaf_scan

`--kernels` names the kernels to compare (default leaf_scan;
frontier_scan_excl,frontier_scan_excl_sq8, frontier_scan,frontier_scan_sq8,
leaf_scan_batched,topk and flash_attention,distance_matrix are the earlier
pairs); each needs its parent's source in `--parent` (`parent_sources`);
for the frontier kernels, the parent's wrapper `frontier_scan.py` beside
its source adds per-call times.
The parent's sources build with the port's nvcc flags into
`build/parent_kernels/` while this checkout's own build.  Each parent
entry point is bound by the C declaration in its own source
(`entry_signatures`), so a parent whose interface differs from this
checkout's is called as it was written (leaf_scan's first entry with its
`vec4` flag, the leaf_scan_batched entry with or
without its mask scratch, topk's one `topk_f32` call or the older
per-chunk `topk_chunk_f32` passes), and an interface the tool does not
know is refused before any call.  Then each kernel is timed parent, new,
new, parent at the main path's shapes:
- leaf_scan: the per-query scan of `scann_vmapped`, (Q, nl, L, C, d) =
  (1000, 40, 2000, 1416, 128), L2: 40 distinct leaf ids a query drawn
  uniformly from [0, L) (so about 1,965 distinct leaves, groups of about
  20 queries with little spread; `chip_smoke.py`'s kernels phase gives
  the main path's real, skewed grouping), leaves of 1 .. 2 x
  LEAF_MEAN_ROWS valid rows then -1 padding, bitmaps of selectivity
  LEAF_SEL over LEAF_N rows; the library call (dequantize + `torch.bmm`,
  64 queries at a time) and the time per call of both (CUDA events) are
  taken beside it;
- frontier_scan, frontier_scan_sq8: (Q, C, d) = (1000, 32, 128) and
  (1000, 64, 128), L2, over a 1M-row store (f32 rows, or int8 rows with
  scale and mean); the ids cycle over 8 blocks of uniform ids with about
  10 % -1 padding (8 x 16 MB of f32 rows against the 50 MB L2), bitmaps
  (Q, 31,250) words of selectivity 0.1.  Device time through the parent's
  entry point; with the parent's wrapper `frontier_scan.py` beside its
  source, also the time per call with the host's work (CUDA events)
  through the parent's wrapper and this checkout's;
- frontier_scan_excl, frontier_scan_excl_sq8: as the two above at
  (1000, 32, 128), the exclusion path's 1-hop chunk, with a (13, 1M)
  radius table, each query's row drawn from [0, 13), tau finite for 90 %
  of the queries and +inf for the rest, margin 0.3 (EXCL_*); keep exact
  against the rule on each side's own distances, and the parent-vs-new
  keep flips reported (`keep_flips`);
- flash_attention: q, k, v (2, 8192, 16, 80) bf16, non-causal, the
  hubert-xlarge encoder's prefill; parent and new agree within relative L2
  1e-2 (the new route rounds P to bf16);
- distance_matrix: (64, 2000, 128) and (64, 44, 128), L2;
- leaf_scan_batched: one ScaNN query block's union scan, (Q, U, C, d) =
  (64, 1345, 1416, 128), L2, over a 1M-row id space (W = 31,250 words)
  with leaves of 1 .. 999 valid rows (about 500) then -1 padding, and
  bitmaps of selectivity 0.1; the library call (dequantize +
  `torch.matmul`) is timed beside it;
- topk: n = 56,640, k = 40 (one query's per-query ScaNN scores, 96 %
  +inf) and n = 1M, k = 10 (one query's distances); `torch.topk` beside.
Distances agree within allclose(1e-5, 1e-4) with the same +inf pattern;
ids, pass flags and top-k values exactly.  Device milliseconds per call
from torch.profiler, as `chip_smoke.py` takes them (`call_parent` and
`call_new`: milliseconds per call with the host's work).  Prints one JSON
line with every time, the card's name and its power limit.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# q, k, v of one encoder prefill: (batch, frames, heads, head width)
FLASH_SHAPE = (2, 8192, 16, 80)
# one ScaNN query block's union scan at the SIFT1M-shaped main path
LEAF_SHAPE = (64, 1345, 1416, 128)
LEAF_N, LEAF_MEAN_ROWS, LEAF_SEL = 1_000_000, 500, 0.1
# the per-query scan of scann_vmapped at the main path: (Q, nl, L, C, d)
LEAF_IDS_SHAPE = (1000, 40, 2000, 1416, 128)
TOPK_CASES = ((56_640, 40), (1_000_000, 10))
# the graph engine's 1-hop and 2-hop (frontier_chunk2) candidate chunks at
# the SIFT1M-shaped main path; ids over FRONTIER_N rows, cycling over
# FRONTIER_BLOCKS blocks, a FRONTIER_PAD share of -1; bitmaps of
# selectivity FRONTIER_SEL
FRONTIER_SHAPES = ((1000, 32, 128), (1000, 64, 128))
FRONTIER_N, FRONTIER_BLOCKS, FRONTIER_PAD, FRONTIER_SEL = (
    1_000_000, 8, 0.1, 0.1)
# the exclusion variants: radius-table rows (the main path's ladder and
# families), the share of queries whose result queue is full (finite tau),
# and the main path's margin
EXCL_ROWS, EXCL_FULL, EXCL_MARGIN = 13, 0.9, 0.3
# each kernel's parent source under --parent
SOURCES = {"flash_attention": "flash_attention", "distance_matrix": "distance",
           "leaf_scan_batched": "leaf_scan", "topk": "topk",
           "frontier_scan": "frontier_scan",
           "frontier_scan_sq8": "frontier_scan",
           "frontier_scan_excl": "frontier_scan",
           "frontier_scan_excl_sq8": "frontier_scan", "leaf_scan": "leaf_scan"}
DEFAULT_KERNELS = "leaf_scan"
# the C entry point each frontier kernel's parent is called through, and
# the argument list the tool passes it
FRONTIER_ENTRIES = {
    "frontier_scan": ("frontier_scan_f32", "pppppppiiiiiiip"),
    "frontier_scan_sq8": ("frontier_scan_sq8", "pppppppppiiiiiiip"),
    "frontier_scan_excl": ("frontier_scan_excl_f32", "pppppppppppfiiiiiiip"),
    "frontier_scan_excl_sq8": ("frontier_scan_excl_sq8",
                               "pppppppppppppfiiiiiiip")}
# an entry point's C declaration in a kernel source
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def parse_kernels(text: str) -> list[str]:
    """The comma-separated kernel names of --kernels, in order; raises
    ValueError naming the choices for an unknown one."""
    names = [t.strip() for t in text.split(",") if t.strip()]
    unknown = [t for t in names if t not in SOURCES]
    if unknown or not names:
        raise ValueError(f"unknown kernel(s) {unknown or text!r}; choose "
                         f"from {', '.join(SOURCES)}")
    return list(dict.fromkeys(names))


def parent_sources(kernels) -> tuple[str, ...]:
    """The parent's csrc/<name>.cu sources the named kernels need."""
    return tuple(dict.fromkeys(SOURCES[k] for k in kernels))


def entry_signatures(text: str) -> dict[str, str]:
    """The argument types of each `extern "C" int` entry point of a kernel
    source, in `build.SIGNATURES`' letters ("p" pointer, "i" int, "f"
    float); raises ValueError for a parameter of another type."""
    out = {}
    for name, params in _ENTRY.findall(text):
        sig = ""
        for param in params.split(","):
            param = " ".join(param.split())
            if "*" in param:
                sig += "p"
            elif param.startswith(("int ", "float ")):
                sig += param[0]
            else:
                raise ValueError(f"{name}: cannot bind parameter {param!r}")
        out[name] = sig
    return out


def bind_parent(lib, text: str):
    """Bind each entry point the library exports by its declaration in the
    source it was built from."""
    import ctypes
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for fn, sig in entry_signatures(text).items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes = [kinds[c] for c in sig]
            f.restype = ctypes.c_int
    return lib


def parent_entry(lib, fn: str, *sigs: str):
    """The parent's entry point `fn`, refused unless it takes one of the
    argument lists `sigs` this tool knows how to call."""
    f = getattr(lib, fn, None)
    sig = None if getattr(f, "argtypes", None) is None else "".join(
        {"c_void_p": "p", "c_int": "i", "c_float": "f"}[t.__name__]
        for t in f.argtypes)
    if sig not in sigs:
        raise RuntimeError(f"the parent's {fn} is {sig or 'missing'}; this "
                           f"tool calls {' or '.join(sigs)}")
    return f


def _four(key, parent_fn, new_fn, times, ms):
    times[key] = {"parent": [], "new": []}
    for who, fn in (("parent", parent_fn), ("new", new_fn),
                    ("new", new_fn), ("parent", parent_fn)):
        times[key][who].append(ms(who, fn))
        print(f"{key} {who}: {times[key][who][-1]} ms", flush=True)


def leaf_scan_inputs(gen):
    """Inputs of one union scan at LEAF_SHAPE: leaves of 1 .. 2 x
    LEAF_MEAN_ROWS valid rows (ids from one permutation of LEAF_N) then -1
    padding; bitmaps of selectivity LEAF_SEL over LEAF_N rows."""
    import torch
    from repro_torch.kernels import ref
    qn, u, c, d = LEAF_SHAPE
    q = torch.randn(qn, d, device="cuda", generator=gen)
    tiles = torch.randint(-127, 128, (u, c, d), device="cuda", generator=gen,
                          dtype=torch.int8)
    sizes = torch.randint(1, 2 * LEAF_MEAN_ROWS, (u, 1), device="cuda",
                          generator=gen)
    ids = torch.randperm(LEAF_N, device="cuda", generator=gen).repeat(
        -(-u * c // LEAF_N))[:u * c]
    rowids = torch.where(torch.arange(c, device="cuda")[None] < sizes,
                         ids.reshape(u, c), -1).to(torch.int32).contiguous()
    scale = torch.rand(d, device="cuda", generator=gen) * 0.02 + 1e-3
    mean = torch.randn(d, device="cuda", generator=gen) * 0.1
    from repro_torch.core.types import pack_bool_bitmap
    bits = torch.rand(qn, LEAF_N, device="cuda", generator=gen) < LEAF_SEL
    bitmaps = pack_bool_bitmap(bits).contiguous()
    xd = ref.dequantize(tiles, scale, mean)
    norms = (xd * xd).sum(-1).contiguous()
    return q, tiles, rowids, scale, mean, bitmaps, norms


def leaf_ids_inputs(gen, shape=LEAF_IDS_SHAPE, n: int = LEAF_N,
                    device="cuda"):
    """Inputs of one per-query scan at `shape` = (Q, nl, L, C, d): (Q, d)
    f32 queries, (Q, nl) int32 leaf ids, nl distinct a query, uniform in
    [0, L), (L, C, d) int8 tiles whose (L, C) int32 rowids hold 1 .. 2 x
    LEAF_MEAN_ROWS valid rows (ids from one permutation of n) then -1
    padding, (d,) f32 scale and mean, (Q, ceil(n / 32)) int32 bitmaps of
    selectivity LEAF_SEL."""
    import torch
    from repro_torch.core.types import pack_bool_bitmap
    qn, nl, n_leaves, c, d = shape
    q = torch.randn(qn, d, device=device, generator=gen)
    leaf_ids = torch.rand(qn, n_leaves, device=device, generator=gen).topk(
        nl, dim=1).indices.to(torch.int32).contiguous()
    tiles = torch.randint(-127, 128, (n_leaves, c, d), device=device,
                          generator=gen, dtype=torch.int8)
    sizes = torch.randint(1, 2 * LEAF_MEAN_ROWS, (n_leaves, 1),
                          device=device, generator=gen)
    ids = torch.randperm(n, device=device, generator=gen).repeat(
        -(-n_leaves * c // n))[:n_leaves * c]
    rowids = torch.where(torch.arange(c, device=device)[None] < sizes,
                         ids.reshape(n_leaves, c), -1).to(torch.int32)
    scale = torch.rand(d, device=device, generator=gen) * 0.02 + 1e-3
    mean = torch.randn(d, device=device, generator=gen) * 0.1
    bitmaps = torch.empty((qn, -(-n // 32)), dtype=torch.int32,
                          device=device)
    for s in range(0, qn, 64):   # (64, n) random draws at a time
        bits = torch.rand(min(64, qn - s), n, device=device,
                          generator=gen) < LEAF_SEL
        bitmaps[s:s + 64] = pack_bool_bitmap(bits)
    return (q, leaf_ids, tiles, rowids.contiguous(), scale, mean, bitmaps)


def frontier_inputs(gen, qn: int, c: int, n: int, device="cuda"):
    """FRONTIER_BLOCKS (Q, C) int32 candidate blocks of uniform ids over n
    rows, a FRONTIER_PAD share of them -1, and (Q, ceil(n / 32)) int32
    bitmaps of selectivity FRONTIER_SEL."""
    import torch
    from repro_torch.core.types import pack_bool_bitmap
    blocks = []
    for _ in range(FRONTIER_BLOCKS):
        ids = torch.randint(n, (qn, c), device=device, generator=gen,
                            dtype=torch.int32)
        pad = torch.rand(qn, c, device=device, generator=gen) < FRONTIER_PAD
        blocks.append(torch.where(pad, -1, ids).to(torch.int32).contiguous())
    bits = torch.rand(qn, n, device=device, generator=gen) < FRONTIER_SEL
    return blocks, pack_bool_bitmap(bits).contiguous()


def excl_inputs(gen, qn: int, n: int, scale: float, device="cuda"):
    """The exclusion variants' (EXCL_ROWS, n) f32 table of squared radii,
    uniform in [0, 4 m^2 scale) with m = EXCL_MARGIN, (Q,) int32 table rows
    in [0, EXCL_ROWS), and (Q,) f32 tau, uniform in [scale / 4, scale) for
    an EXCL_FULL share of the queries and +inf for the rest.  With `scale`
    a typical squared distance the rule's bound m (sqrt(d) + sqrt(tau)) is
    about 2 m sqrt(scale): it keeps some radii and prunes others."""
    import torch
    table = torch.rand(EXCL_ROWS, n, device=device, generator=gen) * (
        4 * EXCL_MARGIN ** 2 * scale)
    rows = torch.randint(EXCL_ROWS, (qn,), device=device, generator=gen,
                         dtype=torch.int32)
    tau = (torch.rand(qn, device=device, generator=gen) * 0.75 + 0.25) * scale
    full = torch.rand(qn, device=device, generator=gen) < EXCL_FULL
    tau = torch.where(full, tau, torch.full_like(tau, float("inf")))
    return table.contiguous(), rows.contiguous(), tau.contiguous()


def parent_wrapper(parent_dir: str, lib):
    """The parent's wrapper module `<parent_dir>/frontier_scan.py` with its
    library lookups sent to the parent's build `lib`, or None when the
    directory holds no wrapper."""
    import importlib.util
    import types
    from repro_torch.kernels import build
    path = os.path.join(parent_dir, "frontier_scan.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("parent_frontier_scan",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shim = {k: getattr(build, k) for k in dir(build) if not k.startswith("_")}
    shim["load"] = lambda name: lib
    mod.build = types.SimpleNamespace(**shim)
    return mod


def time_frontier(sq8: bool, excl: bool, parent, device_ms, gen, stream,
                  times):
    """Parent, new, new, parent at FRONTIER_SHAPES (the exclusion variants
    at the first only); with the parent's wrapper, the time per call of
    both wrappers the same way."""
    import torch
    from repro_torch.kernels import frontier_scan as fs
    from repro_torch.kernels import ref
    from repro_torch.measure import cuda_ms
    name = ("frontier_scan_excl" if excl else "frontier_scan") + (
        "_sq8" if sq8 else "")
    d, n = FRONTIER_SHAPES[0][2], FRONTIER_N
    if sq8:
        rows = torch.randint(-127, 128, (n, d), device="cuda", generator=gen,
                             dtype=torch.int8)
        scale = torch.rand(d, device="cuda", generator=gen) * 0.02 + 1e-3
        mean = torch.randn(d, device="cuda", generator=gen) * 0.1
        norms = ref.dequantize(rows, scale, mean).square().sum(-1)
        args, extra = (rows, scale, mean, norms), (scale, mean)
    else:
        rows = torch.randn(n, d, device="cuda", generator=gen)
        norms = rows.square().sum(-1)
        args, extra = (rows, norms), ()
    new_fn = getattr(fs, f"{name}_cuda")
    plain_fn = getattr(ref, f"{name}_ref")
    entry = parent_entry(parent["frontier_scan"], *FRONTIER_ENTRIES[name])
    wrapper = parent.get("frontier_scan.py")
    old_fn = None if wrapper is None else getattr(wrapper, new_fn.__name__)
    for qn, c, _ in FRONTIER_SHAPES[:1] if excl else FRONTIER_SHAPES:
        q = torch.randn(qn, d, device="cuda", generator=gen)
        blocks, bitmaps = frontier_inputs(gen, qn, c, n)
        w = bitmaps.shape[1]
        dist = torch.empty(qn, c, device="cuda")
        ok = torch.empty(qn, c, dtype=torch.bool, device="cuda")
        keep = torch.empty(qn, c, dtype=torch.bool, device="cuda")
        kw, radii, outs, tail = {}, (), (dist, ok), ()
        if excl:
            radii = excl_inputs(gen, qn, n, _typical_distance(
                sq8, q, args, blocks[0], bitmaps))
            kw = {"margin": EXCL_MARGIN}
            outs, tail = (dist, ok, keep), (EXCL_MARGIN,)
        turn = itertools.count()

        def pick():
            return blocks[next(turn) % len(blocks)]

        def old(ids=None):
            ids = pick() if ids is None else ids
            status = entry(q.data_ptr(), rows.data_ptr(),
                           *(t.data_ptr() for t in extra), norms.data_ptr(),
                           ids.data_ptr(), bitmaps.data_ptr(),
                           *(t.data_ptr() for t in radii),
                           *(t.data_ptr() for t in outs), *tail, qn, c, d, w,
                           n, 0, 1, stream())
            if status:
                raise RuntimeError(f"parent {name}: error {status}")
            return outs

        def new(ids=None):
            return new_fn(q, *args, pick() if ids is None else ids, bitmaps,
                          *radii, **kw)

        key = f"{name} Q={qn} C={c}"
        flips = 0
        for i, ids in enumerate(blocks):
            want = [t.clone() for t in old(ids)]
            got = new(ids)
            if not torch.equal(got[1], want[1]):
                raise RuntimeError(f"{key}: parent and new pass flags differ")
            _close(f"{key} parent vs new", got[0], want[0])
            if excl:
                for who, out in (("parent", want), ("new", got)):
                    _keep_by_rule(f"{key} {who}", out, radii, ids)
                flips += int((got[2] != want[2]).sum())
            if i == 0:
                plain = plain_fn(q, *args, ids, bitmaps, *radii, **kw)
                if not torch.equal(got[1], plain[1]):
                    raise RuntimeError(f"{key}: pass flags differ from the "
                                       "plain version")
                _close(f"{key} new vs plain", got[0], plain[0])
        _four(key, old, new, times,
              lambda who, fn: device_ms(fn, iters=200))
        if excl:
            times[key]["keep_flips"] = flips
            times[key]["keep_decisions"] = len(blocks) * qn * c
            print(f"{key}: keep exact against the rule on each side's own "
                  f"distances; {flips} of {len(blocks) * qn * c} decisions "
                  "differ between parent and new", flush=True)
        if old_fn is not None:
            calls = {"parent": lambda: old_fn(q, *args, pick(), bitmaps,
                                              *radii, **kw),
                     "new": new}
            times[key]["call_parent"], times[key]["call_new"] = [], []
            for who in ("parent", "new", "new", "parent"):
                times[key][f"call_{who}"].append(cuda_ms(calls[who],
                                                         iters=200))
                print(f"{key} per call {who}: "
                      f"{times[key][f'call_{who}'][-1]} ms", flush=True)


def _typical_distance(sq8: bool, q, args, ids, bitmaps) -> float:
    """The median finite distance of one block, by the plain version."""
    from repro_torch.kernels import ref
    fn = ref.frontier_scan_sq8_ref if sq8 else ref.frontier_scan_ref
    dist = fn(q, *args, ids, bitmaps)[0]
    return float(dist[dist.isfinite()].median())


def _keep_by_rule(name, out, radii, ids):
    """keep must be the rule on the kernel's own distances; a padded id
    reads the radius of column 0, as the plain version's gather does."""
    import torch
    from repro_torch.kernels import ref
    table, rows, tau = radii
    e = ref.gather_radii(table, rows, ids)
    want = ref.excl_keep_mask(out[0], e, tau[:, None], out[1], EXCL_MARGIN)
    if not torch.equal(out[2], want):
        raise RuntimeError(f"{name}: keep differs from the rule on its own "
                           "distances")


def time_flash(parent, device_ms, gen, stream, times):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.measure import rel_l2
    b, t, h, hd = FLASH_SHAPE
    q, k, v = (torch.randn(FLASH_SHAPE, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    out = torch.empty_like(q)
    entry = parent_entry(parent["flash_attention"], "flash_attention",
                         "ppppiiiiiiiip")

    def flash_parent():
        status = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            t, h, h, hd, 0, 1, stream())
        if status:
            raise RuntimeError(f"parent flash_attention: error {status}")
        return out

    def flash_new():
        return flash_attention_cuda(q, k, v, False)

    flash_parent()
    rel, _ = rel_l2(flash_new(), out)
    if rel > 1e-2:
        raise RuntimeError(f"flash_attention: parent and new differ, "
                           f"relative L2 {rel}")
    _four("flash_attention", flash_parent, flash_new, times,
          lambda who, fn: device_ms(fn, iters=3 if who == "parent" else 20,
                                    warmup=1))


def time_distance(parent, device_ms, gen, stream, times):
    import torch
    from repro_torch.kernels.distance import distance_matrix_cuda
    entry = parent_entry(parent["distance"], "distance_matrix_f32",
                         "pppiiiip")
    for n in (2000, 44):
        qd = torch.randn(64, 128, device="cuda", generator=gen)
        xd = torch.randn(n, 128, device="cuda", generator=gen)
        od = torch.empty(64, n, device="cuda")

        def dist_parent():
            status = entry(
                qd.data_ptr(), xd.data_ptr(), od.data_ptr(), 64, n, 128, 0,
                stream())
            if status:
                raise RuntimeError(f"parent distance_matrix: error {status}")
            return od

        def dist_new():
            return distance_matrix_cuda(qd, xd, "l2")

        dist_parent()
        if not torch.allclose(dist_new(), od, rtol=1e-5, atol=1e-4):
            raise RuntimeError(f"distance_matrix N={n}: parent and new "
                               "differ")
        _four(f"distance_matrix N={n}", dist_parent, dist_new, times,
              lambda who, fn: device_ms(fn, iters=200))


def _close(name, got, want):
    import torch
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise RuntimeError(f"{name}: +inf positions differ")
    if not torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4):
        err = float((got[fin] - want[fin]).abs().max())
        raise RuntimeError(f"{name}: max abs error {err}")


def time_leaf_scan(parent, device_ms, gen, stream, times):
    """Parent, new, new, parent at LEAF_SHAPE, and the library call."""
    import torch
    from repro_torch.kernels.leaf_scan import leaf_scan_batched_cuda
    args = leaf_scan_inputs(gen)
    q, tiles, rowids, scale, mean, bitmaps, norms = args
    qn, u, c, d = LEAF_SHAPE
    w = bitmaps.shape[1]
    out = torch.empty(qn, u, c, device="cuda")
    masks = torch.empty((-(-qn // 64), 32 * w), dtype=torch.int64,
                        device="cuda")

    # an older parent's entry takes no pass-mask scratch
    entry = parent_entry(parent["leaf_scan"], "leaf_scan_batched_f32",
                         "ppppppppiiiiiip", "pppppppppiiiiiip")
    scratch = (masks.data_ptr(),) if len(entry.argtypes) == 16 else ()

    def old():
        status = entry(q.data_ptr(), tiles.data_ptr(), rowids.data_ptr(),
                       scale.data_ptr(), mean.data_ptr(), bitmaps.data_ptr(),
                       norms.data_ptr(), *scratch, out.data_ptr(), qn, u, c,
                       d, w, 0, stream())
        if status:
            raise RuntimeError(f"parent leaf_scan_batched: error {status}")
        return out

    def new():
        return leaf_scan_batched_cuda(*args, "l2")

    want = old().clone()
    _close("leaf_scan_batched parent vs new", new(), want)
    ms = lambda who, fn: device_ms(fn, iters=10, warmup=2)  # noqa: E731
    _four("leaf_scan_batched", old, new, times, ms)
    times["leaf_scan_batched"]["library"] = ms("library", lambda: torch.matmul(
        q, (tiles.to(torch.float32) * scale + mean).reshape(u * c, d).T))


def time_leaf_scan_ids(parent, device_ms, gen, stream, times):
    """Parent, new, new, parent at LEAF_IDS_SHAPE, the library call, and
    the time per call of both."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.leaf_scan import leaf_scan_cuda
    from repro_torch.measure import cuda_ms
    args = leaf_ids_inputs(gen)
    q, leaf_ids, tiles, rowids, scale, mean, bitmaps = args
    qn, nl, n_leaves, c, d = LEAF_IDS_SHAPE
    w = bitmaps.shape[1]
    out = torch.empty(qn, nl, c, device="cuda")
    # the parent's first design, one block a (query, slot), its char4
    # loads behind a vec4 flag
    entry = parent_entry(parent["leaf_scan"], "leaf_scan_f32",
                         "ppppppppiiiiiiiip")
    vec4 = int(d % 4 == 0 and tiles.data_ptr() % 4 == 0)

    def old():
        status = entry(q.data_ptr(), leaf_ids.data_ptr(), tiles.data_ptr(),
                       rowids.data_ptr(), scale.data_ptr(), mean.data_ptr(),
                       bitmaps.data_ptr(), out.data_ptr(), qn, nl, n_leaves,
                       c, d, w, 0, vec4, stream())
        if status:
            raise RuntimeError(f"parent leaf_scan: error {status}")
        return out

    def new():
        return leaf_scan_cuda(*args, "l2")

    want = old().clone()
    _close("leaf_scan parent vs new", new(), want)
    ms = lambda who, fn: device_ms(fn, iters=10, warmup=2)  # noqa: E731
    _four("leaf_scan", old, new, times, ms)
    t = times["leaf_scan"]
    t["call_parent"], t["call_new"] = [], []
    for who, fn in (("parent", old), ("new", new), ("new", new),
                    ("parent", old)):
        t[f"call_{who}"].append(cuda_ms(fn, iters=10))

    def library():
        # dequantize + torch.bmm, 64 queries at a time
        for s in range(0, qn, 64):
            x = ref.dequantize(tiles[leaf_ids[s:s + 64].long()], scale, mean)
            b = x.shape[0]
            torch.bmm(x.reshape(b, nl * c, d), q[s:s + 64, :, None])
    t["library"] = device_ms(library, iters=2, warmup=1)
    t["distinct_leaves"] = int(torch.unique(leaf_ids).numel())
    print(f"leaf_scan: per call parent {t['call_parent']} new "
          f"{t['call_new']} ms, library {t['library']} ms, "
          f"{t['distinct_leaves']} distinct leaves", flush=True)


def parent_topk(lib, values, k, stream):
    """The parent's top-k: this checkout's wrapper around the parent's
    `topk_f32`, or, for an older parent, passes of its `topk_chunk_f32`
    over the survivors until one chunk is left."""
    import torch
    from repro_torch.kernels.topk import topk_cuda
    if hasattr(lib, "topk_f32"):
        parent_entry(lib, "topk_f32", "ppppiiip")
        return topk_cuda(values, k, lib)
    entry = parent_entry(lib, "topk_chunk_f32", "ppppiiip")
    n = values.shape[0]
    chunk = min(1024, max(k, n))
    vals, idx, m = values, None, n
    while True:
        nb = -(-m // chunk)
        out_v = torch.empty(nb * k, dtype=torch.float32, device="cuda")
        out_i = torch.empty(nb * k, dtype=torch.int32, device="cuda")
        status = entry(
            vals.data_ptr(), None if idx is None else idx.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), m, chunk, k, stream())
        if status:
            raise RuntimeError(f"parent topk: error {status}")
        if nb == 1:
            return out_v, out_i
        vals, idx, m = out_v, out_i, nb * k
        chunk = max(1024, 2 * k)


def time_topk(parent, device_ms, gen, stream, times):
    import torch
    from repro_torch.kernels.topk import topk_cuda
    for n, k in TOPK_CASES:
        v = torch.randn(n, device="cuda", generator=gen).abs() * 100.0
        if n < 100_000:
            v[torch.rand(n, device="cuda", generator=gen) < 0.96] = \
                float("inf")
        pv, pi = parent_topk(parent["topk"], v, k, stream)
        nv, ni = topk_cuda(v, k)
        if not (torch.equal(pv, nv) and torch.equal(pi, ni)):
            raise RuntimeError(f"topk n={n} k={k}: parent and new differ")
        key = f"topk n={n} k={k}"
        _four(key, lambda: parent_topk(parent["topk"], v, k, stream),
              lambda: topk_cuda(v, k), times,
              lambda who, fn: device_ms(fn, iters=200))
        times[key]["library"] = device_ms(
            lambda: torch.topk(v, k, largest=False), iters=200)


# each takes (parent libraries, device_ms, generator, stream, times) and
# adds its readings to times
TIMERS = {"leaf_scan": time_leaf_scan_ids,
          "frontier_scan": lambda *a: time_frontier(False, False, *a),
          "frontier_scan_sq8": lambda *a: time_frontier(True, False, *a),
          "frontier_scan_excl": lambda *a: time_frontier(False, True, *a),
          "frontier_scan_excl_sq8": lambda *a: time_frontier(True, True,
                                                             *a),
          "flash_attention": time_flash, "distance_matrix": time_distance,
          "leaf_scan_batched": time_leaf_scan, "topk": time_topk}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "build", "parent"),
                    help="directory holding the parent's sources the "
                         "kernels need (csrc/<name>.cu)")
    ap.add_argument("--kernels", default=DEFAULT_KERNELS,
                    help="comma-separated kernels to compare, of "
                         + ", ".join(SOURCES))
    args = ap.parse_args(argv)
    try:
        kernels = parse_kernels(args.kernels)
    except ValueError as e:
        ap.error(str(e))
    parent_dir = os.path.abspath(args.parent)
    sources = parent_sources(kernels)
    missing = [s for s in sources
               if not os.path.exists(os.path.join(parent_dir, f"{s}.cu"))]
    if missing:
        ap.error(f"{parent_dir} lacks the parent's "
                 + ", ".join(f"{s}.cu" for s in missing))

    import torch
    if not torch.cuda.is_available():
        print("time_kernel_redesign: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.measure import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    parent_out = os.path.join(ROOT, "build", "parent_kernels")
    with ThreadPoolExecutor() as pool:
        builds = [pool.submit(build.build_all),
                  pool.submit(build.build_all, sources, parent_dir,
                              parent_out)]
        for b in builds:
            b.result()
    parent = {}
    for s in sources:
        with open(os.path.join(parent_dir, f"{s}.cu")) as f:
            parent[s] = bind_parent(build.load_from(parent_dir, s, parent_out),
                                    f.read())
    if "frontier_scan" in parent:
        parent["frontier_scan.py"] = parent_wrapper(parent_dir,
                                                    parent["frontier_scan"])
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    times: dict = {}
    for name in kernels:
        TIMERS[name](parent, device_ms, gen, stream, times)
        torch.cuda.empty_cache()
    print(json.dumps({"device_ms": times, "kernels": kernels,
                      "frontier_shapes": FRONTIER_SHAPES,
                      "flash_shape": FLASH_SHAPE, "leaf_shape": LEAF_SHAPE,
                      "leaf_ids_shape": LEAF_IDS_SHAPE,
                      "nvidia_smi": smi,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
