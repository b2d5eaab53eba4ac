"""The hand-written CUDA kernels against their plain versions, and the
search path on the card against the CPU.  These need an NVIDIA card with
nvcc; without one each test skips.  On the card, without JAX:
`PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda.py`."""
import dataclasses

import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import ops, ref
from repro_torch.measure import rel_l2

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert torch.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qn", [1, 64, 100])
@pytest.mark.parametrize("n", [44, 2000, 2001])
def test_distance_matrix_kernel_at_search_shapes(cuda, metric, qn, n):
    # the branch (44) and leaf (2000) centroid levels, a ragged N; one
    # query, one query block, a block and a half; both block layouts
    g = torch.Generator(device=cuda).manual_seed(qn * n)
    q = torch.randn(qn, 128, device=cuda, generator=g)
    x = torch.randn(n, 128, device=cuda, generator=g)
    ops.reset_launches()
    got = ops.distance_matrix(q, x, metric)
    assert ops.launches()["distance_matrix"] == 1
    _close(got, ref.distance_matrix_ref(q, x, metric))
    assert torch.equal(ops.distance_matrix(q, x, metric), got)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_kernels_match_plain_versions(cuda, metric):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(70, 100, device=cuda, generator=g)
    x = torch.randn(300, 100, device=cuda, generator=g)
    _close(ops.distance_matrix(q, x, metric),
           ref.distance_matrix_ref(q, x, metric))
    rows = torch.randn(5000, 100, device=cuda, generator=g)
    norms = (rows * rows).sum(-1)
    ids = torch.randint(-1, 5000, (70, 33), device=cuda, generator=g,
                        dtype=torch.int32)
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (70, 157), device=cuda,
                       generator=g, dtype=torch.int32)
    dk, pk = ops.frontier_scan(q, rows, norms, ids, bm, metric)
    dp, pp = ref.frontier_scan_ref(q, rows, norms, ids, bm, metric)
    assert torch.equal(pk, pp)
    _close(dk, dp)
    tiles = torch.randint(-127, 128, (7, 37, 100), device=cuda, generator=g,
                          dtype=torch.int8)
    rowids = torch.randint(-1, 5000, (7, 37), device=cuda, generator=g,
                           dtype=torch.int32)
    scale = torch.rand(100, device=cuda, generator=g) * 0.02
    mean = torch.randn(100, device=cuda, generator=g) * 0.1
    xd = tiles.float() * scale + mean
    rn = (xd * xd).sum(-1)
    _close(ops.leaf_scan_batched(q, tiles, rowids, scale, mean, bm, rn,
                                 metric),
           ref.leaf_scan_batched_ref(q, tiles, rowids, scale, mean, bm, rn,
                                     metric))


def test_search_on_card_matches_cpu(cuda):
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("g", 3000, 64, "l2", clusters=16),
                            num_queries=16, device=cuda)
    graph = T.build_graph(store, m=8, ef_construction=32, device=cuda)
    scann = T.build_scann(store, num_leaves=40, device=cuda)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "med_pos"),
                            device=cuda)
    cpu = [T.to_device(o, "cpu") for o in (store, graph, scann)]
    p = T.SearchParams(k=10, ef_search=32, beam_width=64,
                       num_leaves_to_search=8, scann_query_block=5)
    for m in ("sweeping", "acorn", "navix", "iterative_scan", "scann",
              "bruteforce"):
        ops.reset_launches()
        a = T.make_executor(m, store, graph=graph, index=scann,
                            device=cuda).search(q, bm, p)
        assert m == "bruteforce" or sum(ops.launches().values()) > 0
        b = T.make_executor(m, cpu[0], graph=cpu[1], index=cpu[2],
                            device="cpu").search(q.cpu(), bm.cpu(), p)
        overlap = (a.ids.cpu()[:, :, None] == b.ids[:, None, :]).any(-1)
        assert overlap.float().mean() >= 0.99
        for f in dataclasses.fields(T.SearchStats):
            x = getattr(a.stats, f.name).cpu().double().mean()
            y = getattr(b.stats, f.name).double().mean()
            assert abs(x - y) <= 0.01 * max(abs(float(y)), 1.0), f.name


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_slice_two_kernels_match_plain_versions(cuda, metric):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(70, 100, device=cuda, generator=g) * 0.3
    qrows = torch.randint(-127, 128, (5000, 100), device=cuda, generator=g,
                          dtype=torch.int8)
    scale = torch.rand(100, device=cuda, generator=g) * 0.02 + 1e-3
    mean = torch.randn(100, device=cuda, generator=g) * 0.1
    x = ref.dequantize(qrows, scale, mean)
    qn = (x * x).sum(-1)
    ids = torch.randint(-1, 5000, (70, 33), device=cuda, generator=g,
                        dtype=torch.int32)
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (70, 157), device=cuda,
                       generator=g, dtype=torch.int32)
    dk, pk = ops.frontier_scan_sq8(q, qrows, scale, mean, qn, ids, bm, metric)
    dp, pp = ref.frontier_scan_sq8_ref(q, qrows, scale, mean, qn, ids, bm,
                                       metric)
    assert torch.equal(pk, pp)
    _close(dk, dp)
    if metric != "l2":
        return
    # radii up to ~20 against distances of ~7-10 in root space: the keep
    # rule prunes some candidates and keeps others
    table = torch.rand(3, 5000, device=cuda, generator=g) * 400.0
    row = torch.randint(0, 3, (70,), device=cuda, generator=g,
                        dtype=torch.int32)
    tau = torch.rand(70, device=cuda, generator=g) * 20.0
    tau[0] = float("inf")
    rows = torch.randn(5000, 100, device=cuda, generator=g)
    norms = (rows * rows).sum(-1)
    for got, want in (
            (ops.frontier_scan_excl(q, rows, norms, ids, bm, table, row, tau,
                                    margin=0.3),
             ref.frontier_scan_excl_ref(q, rows, norms, ids, bm, table, row,
                                        tau, margin=0.3)),
            (ops.frontier_scan_excl_sq8(q, qrows, scale, mean, qn, ids, bm,
                                        table, row, tau, margin=0.3),
             ref.frontier_scan_excl_sq8_ref(q, qrows, scale, mean, qn, ids,
                                            bm, table, row, tau,
                                            margin=0.3))):
        assert torch.equal(got[1], want[1])
        _close(got[0], want[0])
        # keep is exact against the rule on the kernel's own distances
        e = ref.gather_radii(table, row, ids)
        own = ref.excl_keep_mask(got[0], e, tau[:, None], got[1], 0.3)
        assert torch.equal(got[2], own)
        assert not bool(got[2].all())


def test_slice_two_search_on_card_matches_cpu(cuda):
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("g2", 3000, 64, "l2", clusters=16),
                            num_queries=16, device=cuda)
    store = T.quantize_store(store)
    # the shadow quantized on the card is byte-identical to the CPU's
    cpu_shadow = T.quantize_store(T.to_device(
        dataclasses.replace(store, q_vectors=None), "cpu"))
    for f in ("q_vectors", "q_scale", "q_mean"):
        assert torch.equal(getattr(store, f).cpu(), getattr(cpu_shadow, f)), f
    graph = T.build_graph(store, m=8, ef_construction=32, device=cuda)
    scann = T.build_scann(store, num_leaves=40, device=cuda)
    fams = T.generate_families(store, 0.05, num_families=4, device=cuda)
    bm, _ = T.assign_family_bitmaps(fams, 16, seed=1)
    excl = T.build_exclusion(store, families=fams, device=cuda)
    parts = T.build_graph_partitioned(store, fams, m=8, ef_construction=32,
                                      device=cuda)
    cpu_parts = parts.to("cpu")
    cpu_excl = T.to_device(excl, "cpu")
    cpu = [T.to_device(o, "cpu") for o in (store, graph, scann)]
    p = T.SearchParams(k=10, ef_search=32, beam_width=64,
                       num_leaves_to_search=8, exclusion_margin=0.3)
    for m in ("sweeping_sq8", "acorn_sq8", "navix_sq8", "iterative_scan_sq8",
              "sweeping_excl", "sweeping_excl_sq8", "partitioned",
              "partitioned_sq8", "adaptive"):
        a = T.make_executor(m, store, graph=graph, index=scann,
                            exclusion=excl, partitions=parts,
                            device=cuda).search(q, bm, p)
        b = T.make_executor(m, cpu[0], graph=cpu[1], index=cpu[2],
                            exclusion=cpu_excl, partitions=cpu_parts,
                            device="cpu").search(q.cpu(), bm.cpu(), p)
        assert a.plan.strategy == b.plan.strategy
        overlap = (a.ids.cpu()[:, :, None] == b.ids[:, None, :]).any(-1)
        assert overlap.float().mean() >= 0.99, m
        for f in dataclasses.fields(T.SearchStats):
            x = getattr(a.stats, f.name).cpu().double().mean()
            y = getattr(b.stats, f.name).double().mean()
            assert abs(x - y) <= 0.01 * max(abs(float(y)), 1.0), (m, f.name)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("d", [128, 37])
def test_leaf_scan_kernel_matches_plain_version(cuda, metric, d):
    """Ragged sizes: d not a multiple of 4 (no char4 loads), C not a
    multiple of 32, leaves repeated across queries."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(9, d, device=cuda, generator=g)
    tiles = torch.randint(-127, 128, (11, 45, d), device=cuda, generator=g,
                          dtype=torch.int8)
    rowids = torch.randint(-1, 5000, (11, 45), device=cuda, generator=g,
                           dtype=torch.int32)
    scale = torch.rand(d, device=cuda, generator=g) * 0.02 + 1e-3
    mean = torch.randn(d, device=cuda, generator=g) * 0.1
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (9, 157), device=cuda,
                       generator=g, dtype=torch.int32)
    leaf_ids = torch.randint(0, 11, (9, 6), device=cuda, generator=g,
                             dtype=torch.int32)
    ops.reset_launches()
    got = ops.leaf_scan_ids(q, leaf_ids, tiles, rowids, scale, mean, bm,
                            metric)
    assert ops.launches()["leaf_scan"] == 1
    _close(got, ref.leaf_scan_ids_ref(q, leaf_ids, tiles, rowids, scale,
                                      mean, bm, metric))
    one = ops.leaf_scan(q[0], tiles[:3], rowids[:3], scale, mean, bm[0],
                        metric)
    _close(one, ref.leaf_scan_ref(q[0], tiles[:3], rowids[:3], scale, mean,
                                  bm[0], metric))


def _leaf_ids_inputs(cuda, qn, nl, n_leaves, c, d, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(qn, d, device=cuda, generator=g)
    tiles = torch.randint(-127, 128, (n_leaves, c, d), device=cuda,
                          generator=g, dtype=torch.int8)
    rowids = torch.randint(-1, 5000, (n_leaves, c), device=cuda, generator=g,
                           dtype=torch.int32)
    scale = torch.rand(d, device=cuda, generator=g) * 0.02 + 1e-3
    mean = torch.randn(d, device=cuda, generator=g) * 0.1
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (qn, 157), device=cuda,
                       generator=g, dtype=torch.int32)
    leaf_ids = torch.randint(0, n_leaves, (qn, nl), device=cuda, generator=g,
                             dtype=torch.int32)
    return [q, leaf_ids, tiles, rowids, scale, mean, bm]


def _leaf_ids_want(args, metric):
    """The plain version, with the rows of a leaf id outside [0, L) +inf
    (the plain version gathers by id and cannot take one)."""
    q, leaf_ids, tiles = args[:3]
    bad = (leaf_ids < 0) | (leaf_ids >= tiles.shape[0])
    safe = torch.where(bad, 0, leaf_ids).to(torch.int32)
    want = ref.leaf_scan_ids_ref(q, safe, *args[2:], metric)
    return want.masked_fill(bad[:, :, None], float("inf"))


def _leaf_ids_check(args, metric):
    ops.reset_launches()
    got = ops.leaf_scan_ids(*args, metric)
    assert ops.launches()["leaf_scan"] == 1
    _close(got, _leaf_ids_want(args, metric))
    return got


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [37, 128])
@pytest.mark.parametrize("case", ["every_query", "repeated", "invalid_ids",
                                  "holes", "padding_tile"])
def test_leaf_scan_kernel_grouped_by_leaf(cuda, case, d, metric):
    """The grouping's edge cases: a leaf opened by every query (100, more
    than a 32-query chunk), one leaf twice in a query's slots, leaf ids of
    -1 and >= L (+inf rows), rowids with -1 in the middle of a tile, a
    tile of padding only; C = 600 (three 256-row runs, the last ragged)."""
    args = _leaf_ids_inputs(cuda, 100, 6, 20, 600, d)
    q, leaf_ids, tiles, rowids = args[:4]
    if case == "every_query":
        leaf_ids[:, 2] = 7
        leaf_ids[:40, 4] = 3
    elif case == "repeated":
        leaf_ids[:, 1] = leaf_ids[:, 0]
        leaf_ids[5, :] = 11
    elif case == "invalid_ids":
        leaf_ids[::3, 0] = -1
        leaf_ids[1::4, 3] = 20
        leaf_ids[7, :] = 2 ** 31 - 1
    elif case == "holes":
        sizes = torch.arange(20, device=cuda)[:, None] * 30
        live = torch.arange(600, device=cuda)[None] < sizes
        hole = (torch.arange(600, device=cuda) // 50) % 2 == 1
        args[3] = torch.where(live & ~hole[None], rowids.clamp(min=0),
                              -1).to(torch.int32)
        assert bool((args[3][19, 300:450] >= 0).any())
    else:
        args[3][4] = -1
        args[3][9, 256:512] = -1
        leaf_ids[:, 0] = 4
    got = _leaf_ids_check(args, metric)
    if case == "invalid_ids":
        assert bool(torch.isinf(got[::3, 0]).all())
        assert bool(torch.isinf(got[7]).all())
    if case == "padding_tile":
        assert bool(torch.isinf(got[:, 0]).all())


def test_leaf_scan_kernel_takes_any_number_of_queries(cuda):
    """Q = 70,000 at nl = 1: persistent blocks have no grid.y limit."""
    _leaf_ids_check(_leaf_ids_inputs(cuda, 70_000, 1, 50, 40, 128), "l2")


@pytest.mark.parametrize("d", [37, 128])
def test_leaf_scan_kernel_is_bit_equal_under_a_permutation(cuda, d):
    """Each score's arithmetic is fixed by (query, slot, row) alone: the
    same bits for the queries in any order and from run to run, though
    the grouping's atomic scatter orders each leaf's queries anew."""
    args = _leaf_ids_inputs(cuda, 300, 8, 12, 700, d)
    got = _leaf_ids_check(args, "l2")
    assert torch.equal(ops.leaf_scan_ids(*args), got)
    perm = torch.randperm(300, device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(1))
    shuffled = list(args)
    for i in (0, 1, 6):
        shuffled[i] = args[i][perm].contiguous()
    back = torch.empty_like(got)
    back[perm] = ops.leaf_scan_ids(*shuffled)
    assert torch.equal(back, got)


@pytest.mark.parametrize("qn,nl,c", [(0, 4, 45), (5, 0, 45), (5, 4, 0)])
def test_leaf_scan_kernel_launches_nothing_for_an_empty_batch(cuda, qn, nl,
                                                              c):
    args = _leaf_ids_inputs(cuda, qn, nl, 6, c, 32)
    ops.reset_launches()
    got = ops.leaf_scan_ids(*args)
    assert got.shape == (qn, nl, c)
    assert ops.launches()["leaf_scan"] == 0


@pytest.mark.parametrize("n,k", [(1, 1), (7, 12), (1000, 10), (1025, 40),
                                 (3001, 40), (56_640, 40), (1_000_000, 10),
                                 (5000, 1500)])
def test_topk_kernel_matches_plain_version(cuda, n, k):
    """n not a multiple of 1,024, k > n, k above the first pass's chunk,
    runs of ties and +-inf: values and indices exact."""
    g = torch.Generator(device=cuda).manual_seed(n + k)
    v = torch.randn(n, device=cuda, generator=g)
    v[::7] = float("inf")
    v[3 % n::11] = -float("inf")
    v[10:60] = 0.25
    ops.reset_launches()
    gv, gi = ops.topk_smallest(v, k)
    assert ops.launches()["topk"] >= 1
    wv, wi = ref.topk_partial_ref(v, k)
    assert torch.equal(gv, wv) and torch.equal(gi, wi)


def _leaf_batched_inputs(cuda, qn, u, c, d, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(qn, d, device=cuda, generator=g)
    tiles = torch.randint(-127, 128, (u, c, d), device=cuda, generator=g,
                          dtype=torch.int8)
    rowids = torch.randint(-1, 5000, (u, c), device=cuda, generator=g,
                           dtype=torch.int32)
    scale = torch.rand(d, device=cuda, generator=g) * 0.02 + 1e-3
    mean = torch.randn(d, device=cuda, generator=g) * 0.1
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (qn, 157), device=cuda,
                       generator=g, dtype=torch.int32)
    xd = ref.dequantize(tiles, scale, mean)
    return q, tiles, rowids, scale, mean, bm, (xd * xd).sum(-1)


def _leaf_batched_close(args, metric):
    ops.reset_launches()
    got = ops.leaf_scan_batched(*args, metric)
    assert ops.launches()["leaf_scan_batched"] == 1
    _close(got, ref.leaf_scan_batched_ref(*args, metric))
    return got


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [100, 128])
@pytest.mark.parametrize("c", [37, 1416])
@pytest.mark.parametrize("u", [1, 3])
@pytest.mark.parametrize("qn", [1, 63, 65, 130])
def test_leaf_scan_batched_kernel_at_ragged_shapes(cuda, qn, u, c, d,
                                                   metric):
    """Query tiles of 64 cut at 1, 63, 65 and 130; U * C rows not a
    multiple of the 256-row item or of 4 (scalar stores); d not a multiple
    of 16 (rows staged without cp.async)."""
    _leaf_batched_close(_leaf_batched_inputs(cuda, qn, u, c, d), metric)


@pytest.mark.parametrize("d", [200, 384])
def test_leaf_scan_batched_kernel_over_several_k_slices(cuda, d):
    _leaf_batched_close(_leaf_batched_inputs(cuda, 70, 3, 300, d), "l2")


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qn,u,c,d", [(64, 200, 1416, 128),
                                      (130, 60, 1416, 100),
                                      (70, 40, 300, 384), (1, 300, 256, 128)])
def test_leaf_scan_batched_kernel_skips_padded_items(cuda, qn, u, c, d,
                                                     metric):
    """Leaves filled from the head and padded with -1 to C, some empty, as
    the index builds them: 256-row items of padding only (which get +inf
    without a product) lie between live ones, more items than blocks."""
    args = list(_leaf_batched_inputs(cuda, qn, u, c, d, seed=u))
    g = torch.Generator(device=cuda).manual_seed(c)
    sizes = torch.randint(0, c + 1, (u, 1), device=cuda, generator=g)
    sizes[::7] = 0
    args[2] = torch.where(torch.arange(c, device=cuda)[None] < sizes,
                          args[2].clamp(min=0), -1).to(torch.int32)
    flat = args[2].reshape(-1)
    items = torch.nn.functional.pad(flat, (0, -flat.numel() % 256),
                                    value=-1).reshape(-1, 256)
    live = (items >= 0).any(1)
    assert 0 < int(live.sum()) < live.numel()
    _leaf_batched_close(args, metric)


@pytest.mark.parametrize("case", ["all_filtered", "all_padded"])
def test_leaf_scan_batched_kernel_all_inf(cuda, case):
    args = list(_leaf_batched_inputs(cuda, 65, 3, 37, 128))
    if case == "all_filtered":
        args[5] = torch.zeros_like(args[5])
    else:
        args[2] = torch.full_like(args[2], -1)
    got = _leaf_batched_close(args, "l2")
    assert bool(torch.isinf(got).all())


def _topk_exact(v, k):
    ops.reset_launches()
    gv, gi = ops.topk_smallest(v, k)
    assert ops.launches()["topk"] == 1
    wv, wi = ref.topk_partial_ref(v, k)
    assert torch.equal(gi, wi)
    assert torch.equal(gv, wv)
    # -0.0 comes out as -0.0: the values are read back by index
    assert torch.equal(torch.signbit(gv), torch.signbit(wv))


@pytest.mark.parametrize("case", ["signed_zeros", "runs_across_chunks",
                                  "infinities", "k_above_n", "max_k",
                                  "two_to_the_20_plus_3"])
def test_topk_kernel_edge_cases(cuda, case):
    from repro_torch.kernels.topk import MAX_K
    g = torch.Generator(device=cuda).manual_seed(7)
    n, k = 56_640, 40
    if case == "two_to_the_20_plus_3":
        n, k = 2 ** 20 + 3, 10
    v = torch.randn(n, device=cuda, generator=g)
    if case == "signed_zeros":
        # -0.0 beside +0.0, both below every positive value: ties by index
        v = v.abs() + 1.0
        v[100:140:2] = -0.0
        v[101:141:2] = 0.0
        v[7] = 0.0
    elif case == "runs_across_chunks":
        # equal values straddling every chunk boundary the wrapper may pick
        v = v.abs() + 1.0
        for edge in (2048, 4096, 8192, 16384):
            v[edge - 30:edge + 30] = 0.5
    elif case == "infinities":
        v[::3] = float("inf")
        v[5::97] = -float("inf")
    elif case == "k_above_n":
        n, k = 3000, 4000
        v = v[:n].contiguous()
        v[::5] = float("inf")
    elif case == "max_k":
        k = MAX_K
        v[::4] = float("inf")
        v[1000:3000] = 0.25
    _topk_exact(v, k)


@pytest.mark.parametrize("n,k", [(56_640, 40), (1_000_000, 10), (3000, 40)])
def test_topk_kernel_takes_at_most_two_launches(cuda, n, k):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    v = torch.randn(n, device=cuda)
    ops.topk_smallest(v, k)                 # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.topk_smallest(v, k)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "topk" in e.key)
    assert 1 <= kernels <= 2


def test_cos_graph_search_on_card_matches_cpu(cuda):
    """The frontier scans have no cos kernel: a cos store's graph search
    runs their plain versions on the card, as the reference runs its
    oracle, and counts no kernel launch."""
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("gc", 3000, 64, "cos", clusters=16),
                            num_queries=16, device=cuda)
    store = T.quantize_store(store)
    graph = T.build_graph(store, m=8, ef_construction=32, device=cuda)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "med_pos"),
                            device=cuda)
    cpu = [T.to_device(o, "cpu") for o in (store, graph)]
    p = T.SearchParams(k=10, ef_search=32, beam_width=64)
    for m in ("sweeping", "acorn", "navix", "iterative_scan",
              "sweeping_sq8"):
        ops.reset_launches()
        a = T.make_executor(m, store, graph=graph, device=cuda).search(
            q, bm, p)
        assert sum(ops.launches().values()) == 0, (m, ops.launches())
        b = T.make_executor(m, cpu[0], graph=cpu[1], device="cpu").search(
            q.cpu(), bm.cpu(), p)
        overlap = (a.ids.cpu()[:, :, None] == b.ids[:, None, :]).any(-1)
        assert overlap.float().mean() >= 0.99, m
        for f in dataclasses.fields(T.SearchStats):
            x = getattr(a.stats, f.name).cpu().double().mean()
            y = getattr(b.stats, f.name).double().mean()
            assert abs(x - y) <= 0.01 * max(abs(float(y)), 1.0), (m, f.name)


def test_legacy_engines_on_card_match_cpu(cuda):
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("g3", 3000, 64, "l2", clusters=16),
                            num_queries=16, device=cuda)
    store = T.quantize_store(store)
    graph = T.build_graph(store, m=8, ef_construction=32, device=cuda)
    scann = T.build_scann(store, num_leaves=40, device=cuda)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "med_pos"),
                            device=cuda)
    cpu = [T.to_device(o, "cpu") for o in (store, graph, scann)]
    p = T.SearchParams(k=10, ef_search=32, beam_width=64,
                       num_leaves_to_search=8, graph_exec_mode="vmapped")
    for m in ("sweeping", "acorn", "navix_sq8", "iterative_scan",
              "scann_vmapped"):
        ops.reset_launches()
        a = T.make_executor(m, store, graph=graph, index=scann,
                            device=cuda).search(q, bm, p)
        if m == "scann_vmapped":
            assert ops.launches()["leaf_scan"] == 1
        b = T.make_executor(m, cpu[0], graph=cpu[1], index=cpu[2],
                            device="cpu").search(q.cpu(), bm.cpu(), p)
        overlap = (a.ids.cpu()[:, :, None] == b.ids[:, None, :]).any(-1)
        assert overlap.float().mean() >= 0.99, m
        for f in dataclasses.fields(T.SearchStats):
            x = getattr(a.stats, f.name).cpu().double().mean()
            y = getattr(b.stats, f.name).double().mean()
            assert abs(x - y) <= 0.01 * max(abs(float(y)), 1.0), (m, f.name)


def test_scann_build_on_card_is_deterministic(cuda):
    # the k-means centroid sums are a fixed-order segment sum on the card:
    # two builds of one store give the same index byte for byte
    from repro_torch.data import DatasetSpec, make_dataset
    store, _ = make_dataset(DatasetSpec("det", 50_000, 64, "l2",
                                        clusters=32), num_queries=1,
                            device=cuda)
    a = T.build_scann(store, num_leaves=256, device=cuda)
    b = T.build_scann(store, num_leaves=256, device=cuda)
    for f in ("leaf_rowids", "leaf_centroids", "leaf_tiles",
              "branch_centroids", "branch_leaves"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# flash attention, kernel vs plain.  The FP32 FMA route (f32 at every
# width, bf16 at the widths the tensor-core kernel does not take): f32 sums
# in another order (a few ulp of outputs ~1), bf16 outputs one bf16 ulp
# (2^-7 relative) apart.
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-5)}
# The tensor-core route rounds each probability to bf16 before P.V: a
# relative error of at most 2^-8, about 1.6e-3 rms.  The output, a weighted
# average over the keys, then moves by about that much relative (rms over
# outputs), and rounding kernel and plain outputs to bf16 (ulp ~5.6e-3
# relative) turns that into one-ulp flips, about 2.7e-3 relative L2 in all
# (measured: 1.8e-3 to 2.5e-3, H100, hd 64 to 128).  The limit, 1e-2, is four
# times that; a kernel that drops one 64-key tile of S keys is off by about
# sqrt(64 / S) (0.09 at S = 8192, more below), one that drops the 1/sqrt(hd)
# scale by O(1).  Each (position, head) row on its own: 5e-2, which a row
# computed wrongly (O(1)) or without a key tile cannot meet, while one-ulp
# flips in a row of hd outputs read about 1e-2 at worst.
FLASH_WGMMA_REL_L2, FLASH_WGMMA_ROW_REL_L2 = 1e-2, 5e-2


def _flash_close(got, want, route):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    if route == "wgmma":
        rel, row = rel_l2(got, want)
        assert rel <= FLASH_WGMMA_REL_L2 and row <= FLASH_WGMMA_ROW_REL_L2, \
            (rel, row)
    else:
        rtol, atol = FLASH_TOL[got.dtype]
        assert torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=atol)


def _flash_inputs(device, dtype, seed, b, t, s, h, kv, hd):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, device=device, generator=g).to(dtype)
                 for shape in ((b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,h,kv,hd,causal", [
    (2, 300, 300, 4, 4, 80, False),       # the encoder's head dim
    (2, 300, 300, 4, 4, 80, True),
    (1, 97, 203, 8, 2, 64, True),         # GQA G=4, T, S not block sizes
    (1, 203, 97, 8, 2, 32, False),
    (1, 70, 70, 12, 1, 128, True),        # MQA G=12
    (1, 33, 40, 2, 1, 256, False),        # the widest head
    (1, 50, 50, 4, 2, 96, True),          # hd padded to 128
])
def test_flash_attention_kernel_matches_plain_version(cuda, dtype, b, t, s,
                                                      h, kv, hd, causal):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     route)
    q, k, v = _flash_inputs(cuda, dtype, t * s + hd, b, t, s, h, kv, hd)
    ops.reset_launches()
    got = ops.flash_attention_fused(q, k, v, causal)
    assert ops.launches()["flash_attention"] == 1
    kind = route(dtype, hd)
    assert ops.routes()[f"flash_attention.{kind}"] == 1
    want = ref.flash_attention_ref(q, k, v, causal)
    _flash_close(got, want, kind)
    # a second launch repeats the first bit for bit
    assert torch.equal(flash_attention_cuda(q, k, v, causal), got)


@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,t,s", [
    (2, 300, 300),        # B = 2, T and S not multiples of the tiles
    (1, 97, 203),         # S != T
    (1, 203, 97),
    (1, 40, 20),          # S under one 64-key tile
])
def test_flash_attention_tensor_core_route(cuda, hd, g, causal, b, t, s):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    h = 4 * g
    q, k, v = _flash_inputs(cuda, torch.bfloat16, t * s + hd + h, b, t, s, h,
                            4, hd)
    ops.reset_launches()
    got = flash_attention_cuda(q, k, v, causal)
    assert ops.routes() == {"flash_attention.wgmma": 1,
                            "flash_attention.fma": 0}
    _flash_close(got, ref.flash_attention_ref(q, k, v, causal), "wgmma")
    assert torch.equal(flash_attention_cuda(q, k, v, causal), got)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_tolerance_refuses_broken_kernels(cuda, causal):
    # the tensor-core route's limit must refuse a kernel that misses the
    # last 128 keys and one that drops the 1/sqrt(hd) scale
    import math
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(cuda, torch.bfloat16, 1024 * 1024 + 88, 2, 1024,
                            1024, 8, 8, 80)
    want = ref.flash_attention_ref(q, k, v, causal)
    cut = flash_attention_cuda(q, k[:, :-128].contiguous(),
                               v[:, :-128].contiguous(), causal)
    unscaled = flash_attention_cuda((q * math.sqrt(80)).contiguous(), k, v,
                                    causal)
    for broken in (cut, unscaled):
        rel, row = rel_l2(broken, want)
        assert rel > FLASH_WGMMA_REL_L2 or row > FLASH_WGMMA_ROW_REL_L2
    _flash_close(flash_attention_cuda(q, k, v, causal), want, "wgmma")


def test_flash_attention_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.zeros(1, 4, 6, 8, device=cuda)
    k = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        flash_attention_cuda(q, k, k)
    big = torch.zeros(1, 4, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q.half(), k.half(), k.half())
    # the tensor-core route copies 16 bytes at a time
    flat = torch.zeros(1 + 4 * 2 * 80, device=cuda, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 4, 2, 80)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_cuda(odd, odd, odd)


def test_flash_attention_empty_batch_launches_nothing(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    for b, t in ((0, 4), (1, 0)):
        q = torch.zeros(b, t, 4, 8, device=cuda)
        k = torch.zeros(b, 5, 4, 8, device=cuda)
        ops.reset_launches()
        assert flash_attention_cuda(q, k, k).shape == (b, t, 4, 8)
        assert ops.launches()["flash_attention"] == 0


def test_models_on_card_match_cpu(cuda):
    # smoke configs in f32: the hubert prefill through the kernel against
    # the plain version on the CPU, and greedy serving tokens equal
    from repro_torch import configs as C
    from repro_torch.models import build_model, params_to
    from repro_torch.serving import ServeEngine
    cfg = dataclasses.replace(C.smoke_config("hubert-xlarge"),
                              pallas_flash=True)
    bundle = build_model(cfg)
    params = bundle.init(0, "cpu")
    on_card = params_to(params, cuda)
    frames = torch.randn(2, 77, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    with torch.inference_mode():
        got = bundle.prefill(on_card, {"frames": frames.to(cuda)})
        want = bundle.prefill(params, {"frames": frames})
    assert ops.launches()["flash_attention"] == cfg.n_layers
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for arch in ("granite-8b", "gemma3-12b"):
        cfg = C.smoke_config(arch)
        if arch == "gemma3-12b":
            cfg = dataclasses.replace(cfg, n_layers=12)
        bundle = build_model(cfg)
        params = bundle.init(0, "cpu")
        on_card = params_to(params, cuda)
        prompts = torch.randint(0, cfg.vocab, (2, 9),
                                generator=torch.Generator().manual_seed(2))
        ops.reset_launches()
        a = ServeEngine(bundle, on_card, 17, 2).generate(prompts.numpy(), 8)
        b = ServeEngine(bundle, params, 17, 2, device="cpu").generate(
            prompts.numpy(), 8)
        assert ops.launches()["flash_attention"] == 0
        assert (a == b).all(), arch


# ---------------------------------------------------------------------------
# the four frontier scans: one resident wave of (query, 32-candidate) warp
# items, at the port's dataset widths
# ---------------------------------------------------------------------------

_FRONTIER_N = 3000


def _frontier_store(cuda, d, seed):
    """(f32 rows, norms, int8 rows, scale, mean, dequantized norms) of a
    _FRONTIER_N-row store, from numpy."""
    import numpy as np
    rs = np.random.RandomState(seed)
    rows = torch.from_numpy(rs.randn(_FRONTIER_N, d).astype("float32"))
    qrows = torch.from_numpy(rs.randint(-127, 128, (_FRONTIER_N, d))
                             .astype("int8"))
    scale = torch.from_numpy((rs.rand(d) * 0.02 + 1e-3).astype("float32"))
    mean = torch.from_numpy((rs.randn(d) * 0.1).astype("float32"))
    rows, qrows, scale, mean = (t.to(cuda) for t in (rows, qrows, scale,
                                                     mean))
    qnorms = ref.dequantize(qrows, scale, mean).square().sum(-1)
    return rows, rows.square().sum(-1), qrows, scale, mean, qnorms


def _frontier_ids(cuda, qn, c, seed):
    """(Q, C) ids in [-1, n) with every third query all -1 and a few ids
    >= n, the same ids with those as -1 (what the plain version takes),
    and (Q, ceil(n / 32)) bitmaps."""
    import numpy as np
    rs = np.random.RandomState(seed)
    ids = rs.randint(-1, _FRONTIER_N, (qn, c)).astype("int32")
    ids[::3] = -1
    big = rs.rand(qn, c) < 0.05
    ids[big] = rs.choice([_FRONTIER_N, _FRONTIER_N + 31, 2 ** 31 - 1],
                         int(big.sum()))
    w = -(-_FRONTIER_N // 32)
    bm = rs.randint(-2 ** 31, 2 ** 31 - 1, (qn, w)).astype("int32")
    ids, bm = torch.from_numpy(ids).to(cuda), torch.from_numpy(bm).to(cuda)
    return ids, torch.where(ids >= _FRONTIER_N, -1, ids), bm


def _frontier_check(got, want):
    (dk, pk), (dp, pp) = got[:2], want[:2]
    assert torch.equal(pk, pp)
    _close(dk, dp)


# the exclusion variants' margins: 0 keeps only what passes or has a zero
# radius (and no padding: 0 * inf is NaN), 0.3 is the main path's, 1 keeps
# nearly everything
_MARGINS = (0.0, 0.3, 1.0)


def _excl_radii(cuda, qn, d, seed):
    """A (3, n) table of squared radii up to d (the squared distances'
    scale), a few of them 0, (Q,) table rows and (Q,) tau, a fifth of it
    +inf (a result queue not yet full), from numpy."""
    import numpy as np
    rs = np.random.RandomState(seed)
    table = (rs.rand(3, _FRONTIER_N) * d).astype("float32")
    table[:, :50] = 0.0
    row = rs.randint(0, 3, qn).astype("int32")
    tau = (rs.rand(qn) * d).astype("float32")
    tau[rs.rand(qn) < 0.2] = np.inf
    return tuple(torch.from_numpy(t).to(cuda) for t in (table, row, tau))


def _excl_check(got, want, radii, plain_ids, margin):
    """dist and pass against the plain version; keep exactly the rule on
    the kernel's own distances; padding and ids >= n never kept at a
    margin <= 0."""
    _frontier_check(got, want)
    table, row, tau = radii
    e = ref.gather_radii(table, row, plain_ids)
    assert torch.equal(got[2], ref.excl_keep_mask(got[0], e, tau[:, None],
                                                  got[1], margin))
    if margin <= 0:
        assert not bool(got[2][plain_ids < 0].any())


def _excl_calls(q, store, bm, radii, metric, margin):
    """{kernel name: (kernel's call, plain version's call)} of both
    exclusion variants; the plain version takes ids >= n as -1."""
    from repro_torch.kernels.frontier_scan import (
        frontier_scan_excl_cuda, frontier_scan_excl_sq8_cuda)
    rows, norms, qrows, scale, mean, qnorms = store
    kw = dict(metric=metric, margin=margin)
    return {
        "frontier_scan_excl": (
            lambda i: frontier_scan_excl_cuda(q, rows, norms, i, bm, *radii,
                                              **kw),
            lambda i: ref.frontier_scan_excl_ref(q, rows, norms, i, bm,
                                                 *radii, **kw)),
        "frontier_scan_excl_sq8": (
            lambda i: frontier_scan_excl_sq8_cuda(
                q, qrows, scale, mean, qnorms, i, bm, *radii, **kw),
            lambda i: ref.frontier_scan_excl_sq8_ref(
                q, qrows, scale, mean, qnorms, i, bm, *radii, **kw))}


@pytest.mark.parametrize("qn", [1, 70, 1000])
@pytest.mark.parametrize("c", [1, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("d", [100, 128, 200, 768, 1536])
def test_frontier_scan_kernels_at_dataset_widths(cuda, d, c, qn):
    """All four kernels against their plain versions, both metrics:
    padding, queries of padding only, ids >= n (+inf, pass 0); the
    exclusion pair at every margin of _MARGINS over a several-row radius
    table; one launch a call."""
    from repro_torch.kernels.frontier_scan import (frontier_scan_cuda,
                                                   frontier_scan_sq8_cuda)
    store = _frontier_store(cuda, d, d)
    rows, norms, qrows, scale, mean, qnorms = store
    ids, plain_ids, bm = _frontier_ids(cuda, qn, c, qn * c + d)
    radii = _excl_radii(cuda, qn, d, qn + c)
    g = torch.Generator(device=cuda).manual_seed(qn + c + d)
    q = torch.randn(qn, d, device=cuda, generator=g) * 0.3
    for metric in ("l2", "ip"):
        for margin in _MARGINS:
            calls = _excl_calls(q, store, bm, radii, metric, margin)
            for name, (kern, plain) in calls.items():
                ops.reset_launches()
                got = kern(ids)
                assert ops.launches()[name] == 1
                _excl_check(got, plain(plain_ids), radii, plain_ids, margin)
        ops.reset_launches()
        got = frontier_scan_cuda(q, rows, norms, ids, bm, metric)
        assert ops.launches()["frontier_scan"] == 1
        _frontier_check(got, ref.frontier_scan_ref(q, rows, norms, plain_ids,
                                                   bm, metric))
        got = frontier_scan_sq8_cuda(q, qrows, scale, mean, qnorms, ids, bm,
                                     metric)
        assert ops.launches()["frontier_scan_sq8"] == 1
        _frontier_check(got, ref.frontier_scan_sq8_ref(
            q, qrows, scale, mean, qnorms, plain_ids, bm, metric))
        assert bool(torch.isinf(got[0][::3]).all())


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [128, 200])
def test_frontier_scan_kernels_on_unaligned_views(cuda, metric, d):
    """Rows (and queries) one element off their allocation's alignment take
    the scalar route; so do SQ8 widths that are not a multiple of 16."""
    from repro_torch.kernels.frontier_scan import (frontier_scan_cuda,
                                                   frontier_scan_sq8_cuda)
    store = _frontier_store(cuda, d, 7)
    rows, norms, qrows, scale, mean, qnorms = store
    ids, plain_ids, bm = _frontier_ids(cuda, 70, 33, 8)
    radii = _excl_radii(cuda, 70, d, 10)
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(70, d, device=cuda, generator=g) * 0.3
    rows_off = torch.empty(rows.numel() + 1, device=cuda)[1:].view_as(rows)
    rows_off.copy_(rows)
    qrows_off = torch.empty(qrows.numel() + 1, dtype=torch.int8,
                            device=cuda)[1:].view_as(qrows)
    qrows_off.copy_(qrows)
    q_off = torch.empty(q.numel() + 1, device=cuda)[1:].view_as(q)
    q_off.copy_(q)
    assert rows_off.data_ptr() % 16 and qrows_off.data_ptr() % 4
    for qq in (q, q_off):
        _frontier_check(
            frontier_scan_cuda(qq, rows_off, norms, ids, bm, metric),
            ref.frontier_scan_ref(q, rows, norms, plain_ids, bm, metric))
        _frontier_check(
            frontier_scan_cuda(qq, rows, norms, ids, bm, metric),
            ref.frontier_scan_ref(q, rows, norms, plain_ids, bm, metric))
        for t in (qrows, qrows_off):
            _frontier_check(
                frontier_scan_sq8_cuda(qq, t, scale, mean, qnorms, ids, bm,
                                       metric),
                ref.frontier_scan_sq8_ref(q, qrows, scale, mean, qnorms,
                                          plain_ids, bm, metric))
        plain = _excl_calls(q, store, bm, radii, metric, 0.3)
        for rows_t, qrows_t in ((rows, qrows), (rows_off, qrows_off)):
            views = (rows_t, norms, qrows_t, scale, mean, qnorms)
            for name, (kern, _) in _excl_calls(qq, views, bm, radii, metric,
                                               0.3).items():
                _excl_check(kern(ids), plain[name][1](plain_ids), radii,
                            plain_ids, 0.3)


def test_frontier_scan_kernels_refuse_what_they_cannot_take(cuda):
    from repro_torch.kernels.frontier_scan import (
        frontier_scan_cuda, frontier_scan_excl_cuda,
        frontier_scan_excl_sq8_cuda)
    store = _frontier_store(cuda, 128, 1)
    rows, norms, qrows, scale, mean, qnorms = store
    ids, _, bm = _frontier_ids(cuda, 4, 32, 2)
    table, row, tau = _excl_radii(cuda, 4, 128, 3)
    q = torch.randn(4, 128, device=cuda)
    with pytest.raises(ValueError, match="bitmaps"):
        frontier_scan_cuda(q, rows, norms, ids, bm[:, :-1].contiguous())
    with pytest.raises(ValueError, match="ids"):
        frontier_scan_cuda(q, rows, norms, ids.long(), bm)
    with pytest.raises(ValueError, match="bitmaps"):
        frontier_scan_excl_cuda(q, rows, norms, ids, bm[:, :-1].contiguous(),
                                table, row, tau)
    with pytest.raises(ValueError, match="radius_row"):
        frontier_scan_excl_cuda(q, rows, norms, ids, bm, table, row.long(),
                                tau)
    with pytest.raises(ValueError, match="radius table"):
        frontier_scan_excl_sq8_cuda(q, qrows, scale, mean, qnorms, ids, bm,
                                    table[:, :-1], row, tau)
    with pytest.raises(ValueError, match="tau"):
        frontier_scan_excl_sq8_cuda(q, qrows, scale, mean, qnorms, ids, bm,
                                    table, row, tau[:3])
    ops.reset_launches()
    for qn, c in ((0, 32), (4, 0)):
        dist, ok = frontier_scan_cuda(q[:qn], rows, norms,
                                      ids[:qn, :c].contiguous(), bm[:qn])
        assert dist.shape == (qn, c) and ok.shape == (qn, c)
        for kern, _ in _excl_calls(q[:qn], store, bm[:qn],
                                   (table, row[:qn], tau[:qn]), "l2",
                                   0.3).values():
            out = kern(ids[:qn, :c].contiguous())
            assert [tuple(t.shape) for t in out] == [(qn, c)] * 3
    assert ops.launches() == {k: 0 for k in ops.KERNELS}


def test_frontier_scan_exclusion_kernels_take_any_number_of_queries(cuda):
    """70,000 queries of one candidate each: one launch a variant (the
    earlier kernel's grid refused more than 65,535)."""
    qn = 70_000
    store = _frontier_store(cuda, 128, 5)
    ids, plain_ids, bm = _frontier_ids(cuda, qn, 1, 6)
    radii = _excl_radii(cuda, qn, 128, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(qn, 128, device=cuda, generator=g) * 0.3
    for name, (kern, plain) in _excl_calls(q, store, bm, radii, "l2",
                                           0.3).items():
        ops.reset_launches()
        got = kern(ids)
        assert ops.launches()[name] == 1
        _excl_check(got, plain(plain_ids), radii, plain_ids, 0.3)


# sha256 of the (dist, pass, keep) bytes both exclusion kernels write on
# _excl_fixed_inputs, read on the card once they ran the item loop of the
# plain scans (the distances' summation order is that loop's): a guard that
# a change to the shared source leaves them as they are
EXCL_DIGESTS = {
    "frontier_scan_excl":
        "1613a7f911ff9be5f90bb4fcbf52e6b2cb3bd827781e5730b9ea59e1e175d50f",
    "frontier_scan_excl_sq8":
        "67b9a0b8a42bc7f61e020880bc4a7dc533888c445e0421be23bca1e33a497d25"}


def _excl_fixed_inputs(cuda):
    import numpy as np
    rows, norms, qrows, scale, mean, qnorms = _frontier_store(cuda, 100, 11)
    ids, plain_ids, bm = _frontier_ids(cuda, 70, 33, 12)
    rs = np.random.RandomState(13)
    q = torch.from_numpy((rs.randn(70, 100) * 0.3).astype("float32"))
    table = torch.from_numpy((rs.rand(3, _FRONTIER_N) * 400.0)
                             .astype("float32"))
    row = torch.from_numpy(rs.randint(0, 3, 70).astype("int32"))
    tau = torch.from_numpy((rs.rand(70) * 20.0).astype("float32"))
    q, table, row, tau = (t.to(cuda) for t in (q, table, row, tau))
    return (q, rows, norms, qrows, scale, mean, qnorms, plain_ids, bm, table,
            row, tau)


def test_frontier_scan_exclusion_kernels_are_unchanged(cuda):
    import hashlib
    from repro_torch.kernels.frontier_scan import (
        frontier_scan_excl_cuda, frontier_scan_excl_sq8_cuda)
    (q, rows, norms, qrows, scale, mean, qnorms, ids, bm, table, row,
     tau) = _excl_fixed_inputs(cuda)
    outs = {
        "frontier_scan_excl": frontier_scan_excl_cuda(
            q, rows, norms, ids, bm, table, row, tau, margin=0.3),
        "frontier_scan_excl_sq8": frontier_scan_excl_sq8_cuda(
            q, qrows, scale, mean, qnorms, ids, bm, table, row, tau,
            margin=0.3)}
    digests = {}
    for name, out in outs.items():
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
    assert digests == EXCL_DIGESTS, digests


def _serving_inputs(cuda, quant="none"):
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("g", 3000, 64, "l2", clusters=16),
                            num_queries=24, device=cuda)
    if quant == "sq8":
        store = T.quantize_store(store)
    graph = T.build_graph(store, m=8, ef_construction=32, device=cuda)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "med_pos"),
                            device=cuda)
    return store, q, graph, bm


@pytest.mark.parametrize("quant", ["none", "sq8"])
@pytest.mark.parametrize("strategy", ["sweeping", "acorn", "navix",
                                      "iterative_scan"])
def test_stepped_pool_on_card_matches_one_shot(cuda, strategy, quant):
    """The stepped driver on CUDA tensors, hop chunks 1, 3, 8, equals the
    card's one-shot search bit for bit and goes through the frontier
    kernel."""
    from repro_torch.core import graph_search as G
    store, q, graph, bm = _serving_inputs(cuda, quant)
    p = T.SearchParams(k=10, ef_search=32, beam_width=64, max_hops=200,
                       strategy=strategy, graph_quant=quant)
    want = T.search_batch(graph, store, q, bm, p)
    ops.reset_launches()
    state = G.frontier_init(graph, store, q, bm, p)
    chunks, i = (1, 3, 8), 0
    while not bool(state.done.all()):
        state = G.step_supersteps(graph, store, state, p, chunks[i % 3])
        i += 1
    got = G.frontier_finalize(graph, store, state, p)
    kernel = "frontier_scan_sq8" if quant == "sq8" else "frontier_scan"
    assert ops.launches()[kernel] > 0
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    for f in dataclasses.fields(T.SearchStats):
        assert torch.equal(getattr(got[2], f.name),
                           getattr(want[2], f.name)), f.name


def test_continuous_server_on_card_matches_serve_queue(cuda):
    from repro_torch.serving import (ContinuousServer,
                                     RetrievalAugmentedServer, Request,
                                     results_in_order)
    store, q, graph, bm = _serving_inputs(cuda)
    p = T.SearchParams(k=10, ef_search=32, beam_width=64, max_hops=200)
    ex = T.GraphExecutor(graph, store, strategy="sweeping")
    srv = RetrievalAugmentedServer(
        None, None, ex, p, doc_tokens=torch.zeros(store.n, 4).int().numpy(),
        chunk_len=4, embed_fn=lambda pr, tok: q[tok[:, 0]])
    n = q.shape[0]
    res, _ = srv.serve_queue(torch.arange(n)[:, None].numpy(), bm,
                             batch_size=8, policy="fifo")
    ops.reset_launches()
    recs, info = ContinuousServer(ex, p, width=8, hop_chunk=8).serve(
        [Request(rid=i, query=q[i], bitmap=bm[i]) for i in range(n)])
    assert ops.launches()["frontier_scan"] > 0
    ids, dists = results_in_order(recs, n, p.k)
    assert (ids == res.ids).all() and (dists == res.dists).all()
    assert info["step_ticks"] > 0 and 0 < info["slot_utilization"] <= 1


def test_ladder_scann_lite_rung_launches_its_kernels(cuda):
    """Requests that exhaust the primary's budget descend to scann_lite,
    which runs through distance_matrix and leaf_scan_batched."""
    from repro_torch.serving import LadderRung, RetrievalAugmentedServer
    store, q, graph, bm = _serving_inputs(cuda)
    scann = T.build_scann(store, num_leaves=40, device=cuda)
    p = T.SearchParams(k=10, ef_search=32, beam_width=64,
                       num_leaves_to_search=8)
    ex = T.GraphExecutor(graph, store, strategy="sweeping")
    ladder = [LadderRung("primary", ex,
                         lambda r: dataclasses.replace(r, hop_budget=1)),
              LadderRung("scann_lite", T.ScannExecutor(scann, store),
                         lambda r: dataclasses.replace(
                             r, num_leaves_to_search=4))]
    srv = RetrievalAugmentedServer(
        None, None, ex, p, doc_tokens=torch.zeros(store.n, 4).int().numpy(),
        chunk_len=4, embed_fn=lambda pr, tok: q[tok[:, 0]])
    ops.reset_launches()
    res, info = srv.serve_queue(torch.arange(q.shape[0])[:, None].numpy(),
                                bm, batch_size=8, policy="fifo",
                                ladder=ladder)
    launches = ops.launches()
    assert (info["rung"] == "scann_lite").all()
    assert launches["leaf_scan_batched"] > 0
    assert launches["distance_matrix"] > 0
    assert (res.ids >= 0).all()


# ---------------------------------------------------------------------------
# live mutability on the card (MutableIndex, the delta scan, recovery)
# ---------------------------------------------------------------------------

def _mutable_ops(seed: int, n: int, dim: int = 128):
    import numpy as np
    rng = np.random.RandomState(seed)
    base = rng.randn(n, dim).astype(np.float32)
    queries = rng.randn(64 + 7, dim).astype(np.float32)   # a ragged chunk
    ops = []
    for i in range(6):
        ops.append(("insert", rng.randn(300, dim).astype(np.float32)))
        hi = n + 300 * (i + 1)
        ops.append(("delete", rng.randint(0, hi, 50).astype(np.int64)))
    return base, queries, ops


def _mutable(base, tmp_path, tag, device, **kw):
    kw = dict(dict(delta_capacity=2048, with_graph=False, with_scann=False,
                   num_leaves=64, graph_m=16, ef_construction=32), **kw)
    return T.MutableIndex(base, str(tmp_path / f"{tag}.wal"),
                          str(tmp_path / f"{tag}_ck"), device=device, **kw)


def _apply_op(ix, op):
    if op[0] == "insert":
        ix.insert(op[1])
    else:
        ix.delete(op[1])


def test_exact_distances_bits_do_not_depend_on_the_scan(cuda):
    # the same row's distance, scanned at other positions and in scans of
    # other sizes, and the same query at another position of its chunk
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(70_000, 128, device=cuda, generator=g)
    q = torch.randn(64, 128, device=cuda, generator=g)
    norms = (x * x).sum(-1)
    full = T.exact_distances(x, norms, "l2", q)
    for lo, hi in ((0, 8192), (12_345, 20_000), (65_000, 70_000),
                   (3, 4)):
        part = T.exact_distances(x[lo:hi].contiguous(),
                                 (x[lo:hi] * x[lo:hi]).sum(-1), "l2", q)
        assert torch.equal(part, full[:, lo:hi]), (lo, hi)
    one = T.exact_distances(x, norms, "l2", q[5:6])
    assert torch.equal(one[0], full[5])


def test_mutable_merged_equals_card_oracle(cuda, tmp_path):
    base, queries, ops = _mutable_ops(1, 20_000)
    ix = _mutable(base, tmp_path, "m", cuda)
    q = torch.as_tensor(queries, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    p = T.SearchParams(k=10, strategy="bruteforce")
    for op in ops:
        _apply_op(ix, op)
        bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (q.shape[0], ix.words()),
                           device=cuda, generator=g, dtype=torch.int32)
        res = ix.search(q, bm, p)
        store, live = T.rebuild_oracle_store(ix)
        od, oi = T.filtered_knn(store, q, ix.live_bitmaps(bm)[0]
                                & live[None], 10)
        assert torch.equal(oi.to(torch.int32), res.ids)
        assert torch.equal(od, res.dists)
    ix.close()


def test_mutable_card_against_cpu(cuda, tmp_path):
    base, queries, ops = _mutable_ops(3, 20_000)
    ixs = [_mutable(base, tmp_path, d, d) for d in ("cpu", "cuda")]
    p = T.SearchParams(k=10, strategy="bruteforce")
    bm = torch.full((queries.shape[0], ixs[0].words()), -1,
                    dtype=torch.int32)
    for op in ops:
        for ix in ixs:
            _apply_op(ix, op)
        got = [ix.search(torch.as_tensor(queries), bm, p) for ix in ixs]
        assert torch.equal(got[0].ids, got[1].ids.cpu())
        _close(got[1].dists.cpu(), got[0].dists)
    for ix in ixs:
        ix.close()


def test_exact_graph_build_is_deterministic_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    store = T.VectorStore.build(torch.randn(20_000, 128, device=cuda,
                                            generator=g), device=cuda)
    a, b = (T.build_graph(store, m=16, ef_construction=32, seed=0,
                          device=cuda) for _ in range(2))
    assert torch.equal(a.neighbors, b.neighbors)
    assert torch.equal(a.node_level, b.node_level)
    assert a.entry_point == b.entry_point


def test_mutable_recovery_on_the_card_is_bit_equal(cuda, tmp_path):
    base, queries, ops = _mutable_ops(6, 20_000)
    kw = dict(with_graph=True, with_scann=True)
    ix = _mutable(base, tmp_path, "r", cuda, **kw)
    q = torch.as_tensor(queries, device=cuda)
    bm = torch.full((q.shape[0], ix.words()), -1, dtype=torch.int32,
                    device=cuda)
    p = T.SearchParams(k=10, ef_search=64, beam_width=64, max_hops=400,
                       num_leaves_to_search=8)

    def snap(index):
        out = {}
        for m in ("bruteforce", "sweeping", "sweeping_sq8", "scann"):
            r = index.search(q, bm, dataclasses.replace(p, strategy=m),
                             method=m)
            out[m] = (r.ids, r.dists)
        return out

    for op in ops[:4]:
        _apply_op(ix, op)
    ix.checkpoint()
    for op in ops[4:]:
        _apply_op(ix, op)
    want = snap(ix)
    cut = ix.wal.crash_copy(str(tmp_path / "crash.wal"))
    r = T.MutableIndex.recover(base, cut, ix.ckpt_dir, device=cuda,
                               **dict(delta_capacity=2048, num_leaves=64,
                                      graph_m=16, ef_construction=32, **kw))
    got = snap(r)
    for m in want:
        assert torch.equal(want[m][0], got[m][0]), m
        assert torch.equal(want[m][1], got[m][1]), m
    ix.close()
    r.close()


# ---------------------------------------------------------------------------
# Mesh sharding (the one-card stacked emulation): per-shard reads of the
# frontier kernels, the lockstep executor, the sharded ScaNN executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "sq8"])
@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("S", [2, 3, 8])
def test_frontier_scan_per_shard_reads_are_bit_equal(cuda, S, c, quant):
    """A shard's launch on its own block at local ids (-1 where it does
    not own the row, in place) gives the unsharded launch's bits on the
    rows it owns and +inf elsewhere; the ids are uniform over the rows, so
    the shard boundaries cut through every 32-candidate item.  The
    collective `min` of the sharded scoring is the unsharded one, pass
    mask included."""
    from repro_torch.core import graph_search as G
    from repro_torch.core.distributed import shard_graph_tiers
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("shard", 20_000, 128, "l2",
                                        clusters=32), num_queries=1000,
                            seed=S, device=cuda)
    store = T.quantize_store(store)
    g = torch.Generator(device=cuda).manual_seed(S * c)
    ids = torch.randint(-1, store.n, (1000, c), device=cuda, generator=g)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.3, "none"),
                            device=cuda)
    want = G._frontier_scores(q, store, ids, bm, quant)
    rps = -(-store.n // S)
    for s in range(S):
        lo, hi = s * rps, min((s + 1) * rps, store.n)
        own = (ids >= lo) & (ids < hi)
        lids = torch.where(own, ids - lo, -1).to(torch.int32)
        if quant == "sq8":
            got, _ = ops.frontier_scan_sq8(
                q, store.q_vectors[lo:hi], store.q_scale, store.q_mean,
                store.q_norms_sq[lo:hi], lids, bm)
        else:
            got, _ = ops.frontier_scan(q, store.vectors[lo:hi],
                                       store.norms_sq[lo:hi], lids, bm)
        assert torch.equal(got[own].view(torch.int32),
                           want[0][own].view(torch.int32))
        assert bool(torch.isinf(got[~own]).all())
    graph = T.HNSWGraph(torch.full((1, store.n, 4), -1, dtype=torch.int32,
                                   device=cuda),
                        torch.zeros(store.n, dtype=torch.int32,
                                    device=cuda), 0)
    _, sv = shard_graph_tiers(graph, store, S)
    ops.reset_launches()
    d, p = G._frontier_scores(q, sv, ids, bm, quant)
    name = "frontier_scan_sq8" if quant == "sq8" else "frontier_scan"
    assert ops.launches()[name] == S
    assert torch.equal(d.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(p, want[1])


def test_lockstep_sharded_executor_on_card_equals_graph_executor(cuda):
    """S in {1, 2, 4, 8} on a 20,000 x 128 store: ids, dists and the seven
    counters equal the card's GraphExecutor, with S times its
    frontier_scan launches; sweeping_sq8 at S = 4 too."""
    from repro_torch.core.distributed import ShardedGraphExecutor
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("lock", 20_000, 128, "l2",
                                        clusters=64), num_queries=200,
                            seed=0, device=cuda)
    store = T.quantize_store(store)
    graph = T.build_graph_blocked(store, m=16, ef_construction=32, seed=0,
                                  device=cuda)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "med_pos"),
                            device=cuda)
    p = T.SearchParams(k=10, ef_search=64, beam_width=256, max_hops=512)

    def same(a, b):
        assert torch.equal(a.ids, b.ids)
        assert torch.equal(a.dists.view(torch.int32),
                           b.dists.view(torch.int32))
        for f in dataclasses.fields(T.SearchStats):
            assert torch.equal(getattr(a.stats, f.name),
                               getattr(b.stats, f.name)), f.name

    for quant, shards in (("none", (1, 2, 4, 8)), ("sq8", (4,))):
        ops.reset_launches()
        base = T.GraphExecutor(graph, store, graph_quant=quant).search(
            q, bm, p)
        name = "frontier_scan_sq8" if quant == "sq8" else "frontier_scan"
        one = ops.launches()[name]
        assert one > 0
        for S in shards:
            ops.reset_launches()
            res = ShardedGraphExecutor(graph, store, S, graph_quant=quant,
                                       device=cuda).search(q, bm, p)
            assert ops.launches()[name] == S * one
            same(res, base)


def test_sharded_scann_on_card_matches_cpu(cuda):
    """DistributedScannExecutor at S = 4 on one card (stacked) against the
    same index on the CPU: recall within 0.01, counters equal, the
    leaf_scan kernel called once a search."""
    from repro_torch.core.distributed import (DistributedScannExecutor,
                                              build_sharded_scann,
                                              shard_index)
    from repro_torch.data import DatasetSpec, make_dataset
    from repro_torch.launch.mesh import make_mesh
    store, q = make_dataset(DatasetSpec("dscann", 20_000, 128, "l2",
                                        clusters=64), num_queries=200,
                            seed=0, device=cuda)
    mesh = make_mesh((4,), ("data",))
    sh = build_sharded_scann(store, mesh, "data", num_leaves=200, levels=1,
                             device=cuda)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "med_pos"),
                            device=cuda)
    p = T.SearchParams(k=10, num_leaves_to_search=20, reorder_factor=4)
    ops.reset_launches()
    a = DistributedScannExecutor(sh).search(q, bm, p)
    assert ops.launches()["leaf_scan"] == 1
    cpu = shard_index(T.to_device(sh.index, "cpu"),
                      T.to_device(store, "cpu"), mesh, "data")
    b = DistributedScannExecutor(cpu).search(q.cpu(), bm.cpu(), p)
    overlap = (a.ids.cpu()[:, :, None] == b.ids[:, None, :]).any(-1)
    assert overlap.float().mean() >= 0.99
    for f in dataclasses.fields(T.SearchStats):
        x = getattr(a.stats, f.name).cpu().double().mean()
        y = getattr(b.stats, f.name).double().mean()
        assert abs(x - y) <= 0.01 * max(abs(float(y)), 1.0), f.name


@pytest.mark.parametrize("E", [2, 4])
def test_drift_sharded_executor_on_card_matches_cpu(cuda, E):
    """Drift (beam exchange every E supersteps) at S = 4 on the card
    against the CPU, whose drift equals the reference's bit for bit
    (tests/test_torch_sharding.py), on a 20,000 x 128 store with its graph
    built on the card and copied: recall@10 within 0.01 and every
    counter's mean within 1 %, the parity tolerances of chip_smoke.py;
    frontier_scan launched on the card."""
    from repro_torch.core.distributed import ShardedGraphExecutor
    from repro_torch.data import DatasetSpec, make_dataset
    store, q = make_dataset(DatasetSpec("drift", 20_000, 128, "l2",
                                        clusters=64), num_queries=200,
                            seed=0, device=cuda)
    graph = T.build_graph_blocked(store, m=16, ef_construction=32, seed=0,
                                  device=cuda)
    bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.1, "med_pos"),
                            device=cuda)
    cpu_store = T.to_device(store, "cpu")
    _, truth = T.filtered_knn(cpu_store, q.cpu(), bm.cpu(), 10)
    p = T.SearchParams(k=10, ef_search=64, beam_width=256, max_hops=512,
                       beam_exchange_interval=E)
    ops.reset_launches()
    a = ShardedGraphExecutor(graph, store, 4, device=cuda).search(q, bm, p)
    assert ops.launches()["frontier_scan"] > 0
    b = ShardedGraphExecutor(T.to_device(graph, "cpu"), cpu_store, 4,
                             device="cpu").search(q.cpu(), bm.cpu(), p)
    ra = float(T.recall_at_k(a.ids.cpu(), truth, 10).mean())
    rb = float(T.recall_at_k(b.ids, truth, 10).mean())
    assert abs(ra - rb) <= 0.01, (ra, rb)
    for f in dataclasses.fields(T.SearchStats):
        x = getattr(a.stats, f.name).cpu().double().mean()
        y = getattr(b.stats, f.name).double().mean()
        assert abs(x - y) <= 0.01 * max(abs(float(y)), 1e-9), f.name
