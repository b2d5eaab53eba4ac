"""What `chip_smoke.py` and the scripts in `tools_torch/` share, on the CPU:
the relative L2 error that holds a bf16 kernel against its plain version,
and where the build puts a library of another checkout's source."""
import contextlib
import shutil
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.measure import rel_l2


def test_rel_l2_reads_the_whole_and_the_worst_row():
    want = torch.tensor([[3.0, 4.0], [6.0, 8.0]])
    got = want.clone()
    got[1, 0] += 1.0                     # row 1: |d| 1 of |w| 10
    whole, worst = rel_l2(got, want)
    assert whole == pytest.approx(1.0 / 125.0 ** 0.5)
    assert worst == pytest.approx(0.1)
    assert rel_l2(want.to(torch.bfloat16), want) == (0.0, 0.0)


def test_rel_l2_sees_one_dropped_key_tile():
    # the tolerance's control, on the plain version: attention over S keys
    # without its last 64 reads about sqrt(64 / S) relative L2, far above
    # the tensor-core route's limit of 1e-2
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1024, 2, 80, generator=g) for _ in range(3))
    want = ref.flash_attention_ref(q, k, v, False)
    cut = ref.flash_attention_ref(q, k[:, :-64], v[:, :-64], False)
    whole, worst = rel_l2(cut, want)
    assert 0.1 < whole < 0.5 and worst > whole


@pytest.mark.parametrize("empty", [0, 1, 2, 3])
def test_device_ms_reads_again_after_an_empty_session_and_records_it(
        monkeypatch, empty):
    """The profiler stubbed: `empty` sessions with no device time, then one
    with 80 us over 40 calls.  Each empty session is counted under the
    timed function's name; three empty ones raise."""
    from repro_torch import measure
    sessions = iter([{}] * empty + [{"k": 80.0}])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    session = SimpleNamespace(key_averages=lambda: [])
    monkeypatch.setattr("torch.profiler.profile",
                        lambda **kw: contextlib.nullcontext(session))
    monkeypatch.setattr(measure, "device_us_by_name",
                        lambda prof: next(sessions))
    monkeypatch.setattr(measure, "EMPTY_SESSIONS", {})

    def timed():
        pass

    if empty < measure.PROFILER_SESSIONS:
        assert measure.device_ms(timed) == pytest.approx(80.0 / 40 / 1e3)
    else:
        with pytest.raises(RuntimeError, match="no device time in 3"):
            measure.device_ms(timed)
    name = timed.__qualname__
    assert measure.EMPTY_SESSIONS == ({name: empty} if empty else {})


def test_a_source_from_another_directory_builds_into_its_own(tmp_path):
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    shutil.copy(build.CSRC / "distance.cu", src / "distance.cu")
    same = build._lib_path("distance", src, out)
    assert same.parent == out
    assert same.name == build._lib_path("distance").name
    (src / "distance.cu").write_text("// another version\n")
    assert build._lib_path("distance", src, out).name != same.name


def _timing_tool():
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools_torch"
            / "time_kernel_redesign.py")
    spec = importlib.util.spec_from_file_location("time_kernel_redesign",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("text,want", [
    ("leaf_scan_batched,topk", ["leaf_scan_batched", "topk"]),
    (" topk , leaf_scan_batched,topk", ["topk", "leaf_scan_batched"]),
    ("flash_attention,distance_matrix", ["flash_attention",
                                         "distance_matrix"]),
    ("frontier_scan,frontier_scan_sq8", ["frontier_scan",
                                         "frontier_scan_sq8"]),
    ("frontier_scan_excl,frontier_scan_excl_sq8",
     ["frontier_scan_excl", "frontier_scan_excl_sq8"]),
    ("leaf_scan", ["leaf_scan"]),
    ("leaf_scan_batched, leaf_scan", ["leaf_scan_batched", "leaf_scan"]),
])
def test_timing_tool_reads_its_kernel_names(text, want):
    tool = _timing_tool()
    assert tool.parse_kernels(text) == want
    assert tool.parse_kernels(tool.DEFAULT_KERNELS) == ["leaf_scan"]


def test_timing_tool_names_the_parent_sources_each_kernel_needs():
    tool = _timing_tool()
    assert tool.parent_sources(["leaf_scan_batched", "topk"]) == (
        "leaf_scan", "topk")
    assert tool.parent_sources(["flash_attention", "distance_matrix"]) == (
        "flash_attention", "distance")
    assert tool.parent_sources(["leaf_scan", "leaf_scan_batched"]) == (
        "leaf_scan",)
    assert "leaf_scan" in tool.TIMERS
    # every source is one the build knows
    assert set(tool.SOURCES.values()) <= set(build.SIGNATURES)


@pytest.mark.parametrize("kernels", [
    ["frontier_scan", "frontier_scan_sq8"], ["frontier_scan_sq8"],
    ["frontier_scan_excl", "frontier_scan_excl_sq8"],
    ["frontier_scan_excl_sq8", "frontier_scan"]])
def test_timing_tool_times_both_frontier_scans_from_one_parent_source(
        kernels):
    tool = _timing_tool()
    assert tool.parent_sources(kernels) == ("frontier_scan",)
    assert set(kernels) <= set(tool.TIMERS)


@pytest.mark.parametrize("kernel", ["frontier_scan", "frontier_scan_sq8",
                                    "frontier_scan_excl",
                                    "frontier_scan_excl_sq8"])
def test_timing_tool_calls_each_frontier_parent_as_the_source_declares(
        kernel):
    """The entry point and argument list the tool calls a frontier
    parent through are the ones the checkout's source declares and the
    build binds."""
    tool = _timing_tool()
    entry, sig = tool.FRONTIER_ENTRIES[kernel]
    text = (build.CSRC / "frontier_scan.cu").read_text()
    assert tool.entry_signatures(text)[entry] == sig
    assert build.SIGNATURES["frontier_scan"][entry] == sig


@pytest.mark.parametrize("qn,n", [(50, 1000), (7, 4000)])
def test_timing_tool_exclusion_inputs(qn, n):
    """A contiguous (EXCL_ROWS, n) f32 radius table, (Q,) int32 rows in
    [0, EXCL_ROWS) and (Q,) f32 tau, +inf for about 1 - EXCL_FULL of the
    queries: what the exclusion wrappers take, and a rule that keeps some
    candidates and prunes others at EXCL_MARGIN."""
    from repro_torch.kernels import ops
    tool = _timing_tool()
    g = torch.Generator().manual_seed(1)
    blocks, bitmaps = tool.frontier_inputs(g, qn, 32, n, device="cpu")
    q = torch.randn(qn, 16, generator=g)
    rows = torch.randn(n, 16, generator=g)
    norms = rows.square().sum(-1)
    scale = float(ops.frontier_scan(q, rows, norms, blocks[0], bitmaps)[0]
                  .nan_to_num(posinf=0.0).max())
    table, rrow, tau = tool.excl_inputs(g, 2000, n, scale, device="cpu")
    assert table.dtype == torch.float32 and table.shape == (tool.EXCL_ROWS,
                                                            n)
    assert rrow.dtype == torch.int32 and rrow.shape == (2000,)
    assert tau.dtype == torch.float32 and tau.shape == (2000,)
    assert all(t.is_contiguous() for t in (table, rrow, tau))
    assert int(rrow.min()) == 0 and int(rrow.max()) == tool.EXCL_ROWS - 1
    assert 0.0 <= float(table.min()) and float(table.max()) < (
        4 * tool.EXCL_MARGIN ** 2 * scale)
    inf = float(torch.isinf(tau).float().mean())
    assert abs(inf - (1 - tool.EXCL_FULL)) < 0.03
    fin = tau[tau.isfinite()]
    assert scale / 4 <= float(fin.min()) and float(fin.max()) < scale
    table, rrow, tau = tool.excl_inputs(g, qn, n, scale, device="cpu")
    _, ok, keep = ops.frontier_scan_excl(q, rows, norms, blocks[0], bitmaps,
                                         table, rrow, tau,
                                         margin=tool.EXCL_MARGIN)
    assert bool((keep & ~ok).any()) and not bool(keep.all())


@pytest.mark.parametrize("qn,c,n", [(50, 32, 1000), (7, 64, 4000)])
def test_timing_tool_frontier_inputs(qn, c, n):
    """The id blocks cycle over FRONTIER_BLOCKS blocks of ids in [-1, n),
    about FRONTIER_PAD of them -1, beside (Q, ceil(n / 32)) bitmaps of
    selectivity about FRONTIER_SEL."""
    from repro_torch.core.types import unpack_bitmap
    tool = _timing_tool()
    g = torch.Generator().manual_seed(0)
    blocks, bitmaps = tool.frontier_inputs(g, qn, c, n, device="cpu")
    assert len(blocks) == tool.FRONTIER_BLOCKS
    ids = torch.stack(blocks)
    assert ids.dtype == torch.int32 and ids.shape == (len(blocks), qn, c)
    assert all(b.is_contiguous() for b in blocks)
    assert int(ids.min()) == -1 and int(ids.max()) < n
    pad = float((ids == -1).float().mean())
    assert abs(pad - tool.FRONTIER_PAD) < 0.03
    assert not torch.equal(blocks[0], blocks[1])
    assert bitmaps.dtype == torch.int32 and bitmaps.shape == (qn, -(-n // 32))
    sel = float(unpack_bitmap(bitmaps, n).float().mean())
    assert abs(sel - tool.FRONTIER_SEL) < 0.02


def test_timing_tool_sends_the_parent_wrapper_to_the_parent_library(
        tmp_path):
    tool = _timing_tool()
    assert tool.parent_wrapper(str(tmp_path), object()) is None
    src = build.CSRC.parent / "frontier_scan.py"
    shutil.copy(src, tmp_path / "frontier_scan.py")
    lib = object()
    mod = tool.parent_wrapper(str(tmp_path), lib)
    assert mod.build.load("frontier_scan") is lib
    assert mod.build.require is build.require
    assert callable(mod.frontier_scan_cuda)
    assert callable(mod.frontier_scan_sq8_cuda)


@pytest.mark.parametrize("text", ["leaf_scan_batched,bogus", "", "topk2"])
def test_timing_tool_refuses_an_unknown_kernel(text, capsys):
    tool = _timing_tool()
    with pytest.raises(ValueError, match="choose from flash_attention"):
        tool.parse_kernels(text)
    with pytest.raises(SystemExit):
        tool.main(["--kernels", text])
    assert "unknown kernel" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_timing_tool_reads_each_entry_point_from_its_source(name):
    """A parent is bound by its own declarations: read from this
    checkout's sources they are exactly what the build binds."""
    tool = _timing_tool()
    text = (build.CSRC / f"{name}.cu").read_text()
    assert tool.entry_signatures(text) == build.SIGNATURES[name]


def test_timing_tool_binds_an_older_interface_or_refuses_it():
    import ctypes
    import types
    tool = _timing_tool()
    # the leaf_scan_batched entry without its pass-mask scratch, and the
    # per-chunk top-k entry an older topk.cu exported
    older = """
extern "C" int leaf_scan_batched_f32(const void* queries, const void* tiles,
                                     const void* rowids, const void* scale,
                                     const void* mean, const void* bitmaps,
                                     const void* norms, void* out, int Q,
                                     int U, int C, int d, int W, int metric,
                                     void* stream) {
extern "C" int topk_chunk_f32(const void* vals, const void* idx,
                              void* out_v, void* out_i, int n, int chunk,
                              int k, void* stream) {
"""
    assert tool.entry_signatures(older) == {
        "leaf_scan_batched_f32": "ppppppppiiiiiip",
        "topk_chunk_f32": "ppppiiip"}
    # the per-query leaf scan's first design, with its vec4 flag
    first = """
extern "C" int leaf_scan_f32(const void* queries, const void* leaf_ids,
                             const void* tiles, const void* rowids,
                             const void* scale, const void* mean,
                             const void* bitmaps, void* out, int Q, int nl,
                             int L, int C, int d, int W, int metric, int vec4,
                             void* stream) {
"""
    assert tool.entry_signatures(first) == {
        "leaf_scan_f32": "ppppppppiiiiiiiip"}
    with pytest.raises(ValueError, match="cannot bind parameter"):
        tool.entry_signatures('extern "C" int f(double x, void* s) {')
    f = types.SimpleNamespace(argtypes=[ctypes.c_void_p, ctypes.c_int])
    lib = types.SimpleNamespace(f=f)
    assert tool.parent_entry(lib, "f", "ppi", "pi") is f
    with pytest.raises(RuntimeError, match="parent's f is pi"):
        tool.parent_entry(lib, "f", "ppi")
    with pytest.raises(RuntimeError, match="parent's g is missing"):
        tool.parent_entry(lib, "g", "pi")


@pytest.mark.parametrize("shape,n", [((7, 5, 12, 37, 16), 3000),
                                     ((64, 3, 4, 100, 40), 200)])
def test_timing_tool_leaf_ids_inputs(shape, n):
    """What leaf_scan_cuda takes at LEAF_IDS_SHAPE, small: contiguous
    (Q, d) f32 queries, (Q, nl) int32 leaf ids distinct within a query in
    [0, L), (L, C, d) int8 tiles, (L, C) int32 rowids of 1 .. 2 x
    LEAF_MEAN_ROWS valid rows (capped at C) then -1, (d,) f32 scale and
    mean, (Q, ceil(n / 32)) int32 bitmaps of selectivity about LEAF_SEL;
    the plain version scores them."""
    from repro_torch.core.types import unpack_bitmap
    from repro_torch.kernels import ops, ref
    tool = _timing_tool()
    assert tool.LEAF_IDS_SHAPE == (1000, 40, 2000, 1416, 128)
    qn, nl, n_leaves, c, d = shape
    g = torch.Generator().manual_seed(2)
    args = tool.leaf_ids_inputs(g, shape, n, device="cpu")
    q, leaf_ids, tiles, rowids, scale, mean, bitmaps = args
    want = {"queries": (q, torch.float32, (qn, d)),
            "leaf_ids": (leaf_ids, torch.int32, (qn, nl)),
            "tiles": (tiles, torch.int8, (n_leaves, c, d)),
            "rowids": (rowids, torch.int32, (n_leaves, c)),
            "scale": (scale, torch.float32, (d,)),
            "mean": (mean, torch.float32, (d,)),
            "bitmaps": (bitmaps, torch.int32, (qn, -(-n // 32)))}
    for name, (t, dtype, sh) in want.items():
        assert t.dtype == dtype and t.shape == sh, name
        assert t.is_contiguous(), name
    assert int(leaf_ids.min()) >= 0 and int(leaf_ids.max()) < n_leaves
    assert all(len(set(row.tolist())) == nl for row in leaf_ids)
    valid = rowids >= 0
    sizes = valid.sum(1)
    assert int(sizes.min()) >= 1
    assert int(sizes.max()) <= min(c, 2 * tool.LEAF_MEAN_ROWS - 1)
    # leaves filled from the head: valid rows, then -1 to C
    assert torch.equal(valid, torch.arange(c)[None] < sizes[:, None])
    assert int(rowids.max()) < n
    sel = float(unpack_bitmap(bitmaps, n).float().mean())
    assert abs(sel - tool.LEAF_SEL) < 0.02
    got = ops.leaf_scan_ids(*args)
    assert got.shape == (qn, nl, c)
    assert torch.equal(got, ref.leaf_scan_ids_ref(*args))
    assert bool(torch.isinf(got[~valid[leaf_ids.long()]]).all())
