"""The port's live mutability (`repro_torch.storage.delta`,
`repro_torch.core.mutable`, `DeltaExecutor`, the delta cost terms and
`ContinuousServer(index=, ingest=)`) against the reference, on the CPU:
the twin of tests/test_mutability.py, each case fed the same numpy inputs
on both sides.

* `DeltaTier` / `Tombstones` states byte-equal after the same calls; the
  tombstones' device words equal their host words.
* Interleavings (scripted, a seeded grid, a hypothesis property): at every
  step the port's merged search equals the port's own oracle
  (`rebuild_oracle_store` + `filtered_knn`), ids equal and dists bit-equal,
  and equals the reference's merged search: exactly on integer data
  (`torch_parity.exact_vectors`), ids equal and dists within (1e-5, 1e-4)
  on randn.
* Compaction (oracle-identical after it, ScaNN postings pruned, recall
  against a cold build), the buffer pool's dirty pages, the four cost
  functions, and serving with live ingestion: records, `delta_count` and
  info keys equal the reference's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

import repro.core as R
import repro.core.costmodel as RC
import repro.serving.continuous as RS
import repro.storage.bufferpool as RB
import repro.storage.delta as RD
import repro_torch.core as T
import repro_torch.core.costmodel as TC
import repro_torch.serving.continuous as TS
import repro_torch.storage.bufferpool as TB
import repro_torch.storage.delta as TD
from repro.core.mutable import MutableIndex as RMutable
from repro_torch import interop
from repro_torch.core.mutable import MutableIndex as TMutable
from torch_parity import exact_vectors, torch_params

torch.set_num_threads(1)

K = 5
DIM = 16


def _params(**kw):
    base = dict(k=K, strategy="bruteforce")
    base.update(kw)
    return R.SearchParams(**base)


def _pair(tmp_path, base, tag="a", **kw):
    """The same MutableIndex on both sides, each with its own WAL and
    checkpoint directory."""
    kw.setdefault("with_graph", False)
    kw.setdefault("with_scann", False)
    kw.setdefault("delta_capacity", 32)
    ref = RMutable(base, str(tmp_path / f"rwal_{tag}"),
                   str(tmp_path / f"rck_{tag}"), **kw)
    port = TMutable(base, str(tmp_path / f"wal_{tag}"),
                    str(tmp_path / f"ck_{tag}"), device="cpu", **kw)
    return ref, port


def _port_oracle(index, bitmaps, queries, k=K):
    store, live = T.rebuild_oracle_store(index)
    bm = T.words_from_uint32(np.asarray(bitmaps, np.uint32), "cpu")
    w = live.shape[0]
    if bm.shape[-1] < w:
        bm = torch.nn.functional.pad(bm, (0, w - bm.shape[-1]))
    return T.filtered_knn(store, torch.as_tensor(queries), bm & live[None],
                          k)


def _assert_bits(ids_a, d_a, ids_b, d_b, ctx):
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b),
                                  err_msg=f"ids {ctx}")
    np.testing.assert_array_equal(
        np.asarray(d_a, np.float32).view(np.int32),
        np.asarray(d_b, np.float32).view(np.int32), err_msg=f"dists {ctx}")


def _check_step(ref, port, queries, bitmaps, exact, ctx, method="bruteforce",
                p=None, oracle=True):
    """Port merged == port oracle bit for bit (bruteforce; not on an index
    carried across, whose row norms are the reference's), and == the
    reference's merged search."""
    p = p or _params()
    tp = torch_params(p)
    got = port.search(torch.as_tensor(queries), bitmaps, tp, method=method)
    if method == "bruteforce" and oracle:
        od, oi = _port_oracle(port, bitmaps, queries, p.k)
        _assert_bits(oi.to(torch.int32), od, got.ids, got.dists,
                     f"port oracle {ctx}")
    want = ref.search(jnp.asarray(queries), jnp.asarray(bitmaps), p,
                      method=method)
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy(),
                                  err_msg=f"ids vs reference {ctx}")
    if exact:
        _assert_bits(want.ids, want.dists, got.ids, got.dists,
                     f"reference {ctx}")
    else:
        np.testing.assert_allclose(got.dists.numpy(),
                                   np.asarray(want.dists), rtol=1e-5,
                                   atol=1e-4, err_msg=ctx)
    return got


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_merge_topk_equals_reference_and_joint_topk():
    rng = np.random.RandomState(0)
    da = rng.rand(3, 7).astype(np.float32)
    db = rng.rand(3, 4).astype(np.float32)
    da[1, 2] = db[1, 0]                            # a tie across the sides
    ia = rng.permutation(7)[None].repeat(3, 0).astype(np.int32)
    ib = (100 + rng.permutation(4))[None].repeat(3, 0).astype(np.int32)
    md, mi = T.merge_topk(torch.as_tensor(da), torch.as_tensor(ia),
                          torch.as_tensor(db), torch.as_tensor(ib), 5)
    rd, ri = R.merge_topk(jnp.asarray(da), jnp.asarray(ia), jnp.asarray(db),
                          jnp.asarray(ib), 5)
    _assert_bits(ri, rd, mi, md, "merge_topk")
    jd, pos = T.topk_smallest(torch.as_tensor(np.concatenate([da, db], -1)),
                              5)
    ji = np.take_along_axis(np.concatenate([ia, ib], -1), pos.numpy(), -1)
    np.testing.assert_array_equal(mi.numpy(), ji)


def test_merge_topk_inf_padding_yields_minus_one():
    inf = float("inf")
    md, mi = T.merge_topk(torch.tensor([[0.5, inf]]),
                          torch.tensor([[3, 9]], dtype=torch.int32),
                          torch.full((1, 2), inf),
                          torch.tensor([[7, 8]], dtype=torch.int32), 3)
    np.testing.assert_array_equal(mi.numpy()[0], [3, -1, -1])
    assert torch.isinf(md[0, 1:]).all()


def test_bitmap_andnot_composition():
    bm = np.asarray([[0xFFFFFFFF, 0xFFFFFFFF, 0x0000FFFF]], np.uint32)
    minus = np.asarray([0x1, 0x80000000], np.uint32)
    tb = T.words_from_uint32(bm, "cpu")
    got = T.words_to_uint32(T.bitmap_andnot(
        tb, T.words_from_uint32(minus, "cpu")))
    want = np.asarray(R.bitmap_andnot(jnp.asarray(bm), jnp.asarray(minus)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0xFFFFFFFE and got[0, 1] == 0x7FFFFFFF
    assert got[0, 2] == 0x0000FFFF                 # beyond minus: untouched
    assert T.words_to_uint32(tb)[0, 0] == 0xFFFFFFFF      # not mutated


# ---------------------------------------------------------------------------
# delta tier / tombstones mechanics
# ---------------------------------------------------------------------------

def _tier_state(t):
    return (t.base_n, t.capacity, t.dim, t.count, t.version,
            t.inserted_bytes, t.vectors.tobytes())


def test_delta_tier_state_equals_reference():
    rng = np.random.RandomState(1)
    tiers = (RD.DeltaTier(base_n=100, capacity=8, dim=4),
             TD.DeltaTier(base_n=100, capacity=8, dim=4, device="cpu"))
    batches = [rng.randn(3, 4).astype(np.float32),
               rng.randn(5, 4).astype(np.float32)]
    for rows in batches:
        ids = [t.append(rows) for t in tiers]
        np.testing.assert_array_equal(ids[0], ids[1])
        assert _tier_state(tiers[0]) == _tier_state(tiers[1])
    np.testing.assert_array_equal(tiers[1].device_vectors.numpy(),
                                  tiers[1].vectors)
    assert tiers[1].fill == 1.0
    with pytest.raises(TD.DeltaFull):
        tiers[1].append(rng.randn(1, 4).astype(np.float32))
    for t in tiers:
        t.reset(base_n=108)
    assert _tier_state(tiers[0]) == _tier_state(tiers[1])
    assert not tiers[1].device_vectors.any()
    np.testing.assert_array_equal(tiers[1].local_of(np.array([110])), [2])


def test_tombstones_state_and_live_mask_equal_reference():
    ref, port = RD.Tombstones(70), TD.Tombstones(70, device="cpu")
    for ids in (np.array([3, 33, 64]), np.array([3]), np.array([69, 0])):
        assert ref.mark(ids) == port.mark(ids)
        assert ref.words.tobytes() == port.words.tobytes()
        assert ref.count == port.count and ref.version == port.version
        np.testing.assert_array_equal(
            T.words_to_uint32(port.device_words), port.words)
    probe = np.array([3, 4, 64, 69])
    np.testing.assert_array_equal(port.is_dead(probe), ref.is_dead(probe))
    np.testing.assert_array_equal(port.dead_ids(), ref.dead_ids())
    bm = np.full((2, 3), 0xFFFFFFFF, np.uint32)
    bm[1, 0] = 0x0F0F0F0F
    before = bm.copy()
    np.testing.assert_array_equal(port.live_mask(bm), ref.live_mask(bm))
    np.testing.assert_array_equal(bm, before)      # input untouched
    on_device = T.bitmap_andnot(T.words_from_uint32(bm, "cpu"),
                                port.device_words)
    np.testing.assert_array_equal(T.words_to_uint32(on_device),
                                  ref.live_mask(bm))
    with pytest.raises(ValueError):
        port.mark(np.array([70]))
    restored = TD.Tombstones(70, words=ref.words)
    assert restored.words.tobytes() == ref.words.tobytes()


# ---------------------------------------------------------------------------
# oracle equivalence
# ---------------------------------------------------------------------------

def _selective(rng, nq, w, sel):
    bits = rng.rand(nq, w * 32) < sel
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def _run_ops(ref, port, ops, queries, rng, exact=False, sel=0.6):
    """Apply (kind, payload) ops to both sides; after each, check under an
    all-pass and a random selective bitmap."""
    w = port.words()
    assert w == ref.words()
    for step, (kind, payload) in enumerate(ops):
        if kind == "insert":
            np.testing.assert_array_equal(ref.insert(payload),
                                          port.insert(payload))
        else:
            assert ref.delete(payload) == port.delete(payload)
        full = np.full((queries.shape[0], w), 0xFFFFFFFF, np.uint32)
        for name, bm in (("full", full),
                         ("selective", _selective(rng, queries.shape[0], w,
                                                  sel))):
            _check_step(ref, port, queries, bm, exact, f"step {step} {name}")
    assert port.live_count == ref.live_count
    assert port.applied_lsn == ref.applied_lsn


@pytest.mark.parametrize("data", ["randn", "integer"])
def test_scripted_interleaving_matches_oracle_and_reference(tmp_path, data):
    rng = np.random.RandomState(3)
    if data == "integer":
        base, queries = exact_vectors(120, DIM, 4, seed=3)
        rows = lambda m: rng.randint(-127, 128, (m, DIM)).astype(np.float32)
    else:
        base = rng.randn(120, DIM).astype(np.float32)
        queries = rng.randn(4, DIM).astype(np.float32)
        rows = lambda m: rng.randn(m, DIM).astype(np.float32)
    ref, port = _pair(tmp_path, base)
    ops = [
        ("insert", rows(6)),
        ("delete", np.array([0, 5, 121], np.int64)),    # base + delta ids
        ("insert", rows(10)),
        ("delete", np.array([121, 130], np.int64)),     # re-delete + delta
        ("insert", rows(1)),
        ("delete", np.arange(20, 40, dtype=np.int64)),  # dense base kill
    ]
    _run_ops(ref, port, ops, queries, rng, exact=data == "integer")
    assert port.live_count == 120 + 17 - 24
    ref.close()
    port.close()


def _random_ops(rng, base_n, nops, p_insert, max_rows, max_del, integer):
    ops = []
    for _ in range(nops):
        if rng.rand() < p_insert:
            m = rng.randint(1, max_rows)
            ops.append(("insert", rng.randint(-127, 128, (m, DIM))
                        .astype(np.float32) if integer
                        else rng.randn(m, DIM).astype(np.float32)))
        else:
            hi = base_n + sum(o[1].shape[0] for o in ops
                              if o[0] == "insert")
            ops.append(("delete", rng.randint(
                0, hi, size=rng.randint(1, max_del)).astype(np.int64)))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_interleaving_grid_matches_oracle(tmp_path, seed):
    rng = np.random.RandomState(seed)
    integer = seed == 2
    if integer:
        base, queries = exact_vectors(80, DIM, 3, seed=seed)
    else:
        base = rng.randn(80, DIM).astype(np.float32)
        queries = rng.randn(3, DIM).astype(np.float32)
    ref, port = _pair(tmp_path, base, tag=f"g{seed}", delta_capacity=64)
    ops = _random_ops(rng, 80, 8, 0.6, 6, 4, integer)
    _run_ops(ref, port, ops, queries, rng, exact=integer, sel=0.5)
    ref.close()
    port.close()


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_interleaving_property_matches_oracle(tmp_path):
    """Any insert / delete / search interleaving: the port's merged search
    equals its oracle bit for bit and the reference's on integer data
    exactly, at every step."""

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 2 ** 16), nops=st.integers(1, 8),
           sel=st.floats(0.1, 1.0))
    def prop(seed, nops, sel):
        rng = np.random.RandomState(seed)
        base, queries = exact_vectors(60, DIM, 2, seed=seed)
        ref, port = _pair(tmp_path, base, tag=f"h{seed}_{nops}",
                          delta_capacity=64)
        ops = _random_ops(rng, 60, nops, 0.55, 5, 4, True)
        _run_ops(ref, port, ops, queries, rng, exact=True, sel=sel)
        ref.close()
        port.close()

    prop()


def test_delta_rows_surface_and_tombstones_kill_everywhere(tmp_path):
    """A planted delta row ranks first and its tombstone removes it under
    every base method: on the port's own index, and on the reference's
    index carried across, where every answer equals the reference's."""
    rng = np.random.RandomState(5)
    base = rng.randn(150, DIM).astype(np.float32)
    kw = dict(with_graph=True, with_scann=True, num_leaves=8, graph_m=8,
              ef_construction=32)
    ref, port = _pair(tmp_path, base, **kw)
    carried = interop.mutable_index(ref, str(tmp_path / "wal_c"),
                                    str(tmp_path / "ck_c"), "cpu")
    row = rng.randn(1, DIM).astype(np.float32)
    for ix in (ref, port, carried):
        (rid,) = ix.insert(row)
        assert rid == 150
    q = row + 0.001 * rng.randn(1, DIM).astype(np.float32)
    bm = np.full((1, port.words()), 0xFFFFFFFF, np.uint32)
    p = _params(ef_search=48, beam_width=48, max_hops=200,
                num_leaves_to_search=8)
    methods = ("bruteforce", "scann", "sweeping", "sweeping_sq8")
    for dead in (False, True):
        if dead:
            for ix in (ref, port, carried):
                ix.delete(np.array([150], np.int64))
        for method in methods:
            pm = dataclasses.replace(p, strategy=method)
            got = port.search(torch.as_tensor(q), bm, torch_params(pm),
                              method=method)
            if dead:
                assert 150 not in got.ids.numpy(), method
            else:
                assert int(got.ids[0, 0]) == 150, method
            if method == "bruteforce":
                od, oi = _port_oracle(port, bm, q)
                _assert_bits(oi.to(torch.int32), od, got.ids, got.dists,
                             f"port oracle dead={dead}")
            _check_step(ref, carried, q, bm, False, f"{method} dead={dead}",
                        method=method, p=pm, oracle=False)
    for ix in (ref, port, carried):
        ix.close()


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def test_compaction_folds_delta_and_stays_oracle_identical(tmp_path):
    base, queries = exact_vectors(100, DIM, 4, seed=7)
    rng = np.random.RandomState(7)
    ref, port = _pair(tmp_path, base, delta_capacity=16)
    ins = rng.randint(-127, 128, (12, DIM)).astype(np.float32)
    for ix in (ref, port):
        ix.insert(ins)
        ix.delete(np.array([2, 104], np.int64))
        ix.compact()
    assert port.base_n == ref.base_n == 112 and port.delta.count == 0
    assert port.compactions == ref.compactions == 1
    full = np.full((4, port.words()), 0xFFFFFFFF, np.uint32)
    got = _check_step(ref, port, queries, full, True, "post-compaction")
    assert 2 not in got.ids.numpy() and 104 not in got.ids.numpy()
    more = rng.randint(-127, 128, (3, DIM)).astype(np.float32)
    for ix in (ref, port):
        ix.insert(more)
    _check_step(ref, port, queries, full, True, "insert after compaction")
    ref.close()
    port.close()


def test_compaction_auto_triggers_and_prunes_scann_postings(tmp_path):
    rng = np.random.RandomState(9)
    base = rng.randn(90, DIM).astype(np.float32)
    ref, port = _pair(tmp_path, base, delta_capacity=8, with_scann=True,
                      num_leaves=4)
    a = rng.randn(6, DIM).astype(np.float32)
    b = rng.randn(6, DIM).astype(np.float32)
    for ix in (ref, port):
        ix.insert(a)
        ix.delete(np.array([10, 92], np.int64))
        ix.insert(b)                         # overflow -> compact first
    assert port.compactions == ref.compactions == 1
    assert port.base_n == ref.base_n == 96
    rowids = port.scann.leaf_rowids.numpy()
    assert 10 not in rowids and 92 not in rowids       # postings pruned
    assert (rowids >= 0).sum() == 96 - 2
    assert port.tombstones.is_dead(np.array([10, 92])).all()
    assert port.tombstones.words.tobytes() == ref.tombstones.words.tobytes()
    ref.close()
    port.close()


def test_compaction_recall_within_cold_rebuild(tmp_path):
    """The port's compacted index against a cold port index over the same
    union: recall@10 against its oracle within 0.02."""
    rng = np.random.RandomState(11)
    base = rng.randn(400, DIM).astype(np.float32)
    extra = rng.randn(48, DIM).astype(np.float32)
    kw = dict(delta_capacity=48, with_graph=True, with_scann=True,
              num_leaves=8, graph_m=8, ef_construction=32, device="cpu")
    idx = TMutable(base, str(tmp_path / "wal_rc"), str(tmp_path / "ck_rc"),
                   **kw)
    idx.insert(extra)
    idx.compact()
    cold = TMutable(np.concatenate([base, extra]), str(tmp_path / "wal_c"),
                    str(tmp_path / "ck_c"), **kw)
    queries = rng.randn(8, DIM).astype(np.float32)
    bm = np.full((8, idx.words()), 0xFFFFFFFF, np.uint32)
    p = torch_params(_params(k=10, strategy="scann",
                             num_leaves_to_search=4))
    gt = _port_oracle(idx, bm, queries, k=10)[1]
    recalls = {}
    for name, ix in (("compacted", idx), ("cold", cold)):
        got = ix.search(torch.as_tensor(queries), bm, p, method="scann").ids
        recalls[name] = float(T.recall_at_k(got, gt, 10).mean())
    assert recalls["compacted"] >= recalls["cold"] - 0.02, recalls
    idx.close()
    cold.close()


# ---------------------------------------------------------------------------
# buffer pool: dirty pages / invalidate / reset
# ---------------------------------------------------------------------------

def _pool_script(mod, script):
    out = []
    for cap, segments, steps in script:
        pool = mod.BufferPool(cap, segments=segments)
        for op, arg, kw in steps:
            r = getattr(pool, op)(*arg, **kw)
            st_ = pool.state()
            out.append((op, r if isinstance(r, (int, type(None)))
                        else dataclasses.astuple(r), st_.dirty,
                        dict(st_.dirty_by_segment), st_.used,
                        dataclasses.astuple(pool.counters)))
    return out


@pytest.mark.parametrize("case", ["flush", "dirty_eviction", "invalidate"])
def test_bufferpool_dirty_pages_equal_reference(case):
    a = np.array
    script = {
        "flush": [(4, {"delta": (0, 10)}, [
            ("access", (a([0, 1]),), dict(dirty=True)),
            ("flush", (), {}), ("access", (a([1, 2]),), dict(dirty=True)),
            ("flush", (0, 2), {})])],
        "dirty_eviction": [(2, {"delta": (0, 100)}, [
            ("access", (a([0, 1]),), dict(dirty=True)),
            ("access", (a([2, 3]),), {})])],
        "invalidate": [(8, {"scann": (0, 4), "delta": (4, 8)}, [
            ("access", (a([0, 1, 5]),), dict(dirty=True)),
            ("invalidate", (0, 4), {}), ("reset", (), {})])],
    }[case]
    got, want = _pool_script(TB, script), _pool_script(RB, script)
    assert got == want
    if case == "flush":
        assert got[1][1] == 2 and got[1][2] == 0 and got[1][4] == 2
    elif case == "dirty_eviction":
        assert got[-1][2] == 0
    else:
        assert got[1][1] == 2 and got[1][2] == 1
        assert got[-1][2] == 0 and got[-1][4] == 0


# ---------------------------------------------------------------------------
# costmodel: delta scan + write amplification
# ---------------------------------------------------------------------------

def test_costmodel_delta_scan_terms_equal_reference():
    for n in (0, 1, 64, 256, 1024):
        for sel in (0.0, 0.25, 0.5, 1.0, 1.5):
            for dim in (DIM, 128):
                assert TC.delta_scan_counters(n, dim, sel) == \
                    RC.delta_scan_counters(n, dim, sel)
                assert TC.delta_scan_cycles(n, dim, sel) == \
                    RC.delta_scan_cycles(n, dim, sel)
    c = TC.delta_scan_counters(256, DIM, 0.5)
    assert c["filter_checks"] == 256 and 0 < c["distance_comps"] <= 256
    assert 0 < TC.delta_scan_cycles(64, DIM, 0.5) \
        < TC.delta_scan_cycles(1024, DIM, 0.5)


def test_costmodel_write_amplification_equals_reference():
    for args in ((0, 0), (0, 3), (1024, 2, 2048), (4096, 0, 8192),
                 (1, 1, 1)):
        assert TC.write_amplification(*args) == RC.write_amplification(*args)
    assert TC.write_amplification(0, 0) == 1.0
    assert TC.write_amplification(0, 3) == np.inf
    assert TC.PAGE_BYTES_WA == RC.PAGE_BYTES_WA


def test_costmodel_should_compact_equals_reference():
    grid = [(96, 100, 10_000, DIM, 0.5), (4, 1024, 1_000_000, DIM, 0.5),
            (0, 10, 10, DIM, 1.0), (8191, 8192, 1_000_000, 128, 0.1)]
    for args in grid:
        for qpe in (1.0, 1024.0, 1e9):
            assert TC.should_compact(*args, queries_per_epoch=qpe) == \
                RC.should_compact(*args, queries_per_epoch=qpe), (args, qpe)
    assert TC.should_compact(96, 100, 10_000, DIM, 0.5)
    assert not TC.should_compact(4, 1024, 1_000_000, DIM, 0.5)
    assert TC.should_compact(512, 10_000, 2_000, DIM, 1.0,
                             queries_per_epoch=1e9)


# ---------------------------------------------------------------------------
# continuous serving with live ingest
# ---------------------------------------------------------------------------

def _graph_params():
    return R.SearchParams(k=K, ef_search=32, beam_width=32, max_hops=150,
                          strategy="sweeping", graph_exec_mode="frontier")


def _serving_pair(tmp_path, base, tag):
    ref = RMutable(base, str(tmp_path / f"rwal_{tag}"),
                   str(tmp_path / f"rck_{tag}"), delta_capacity=64,
                   with_graph=True, with_scann=False, num_leaves=8,
                   graph_m=8, ef_construction=32)
    port = interop.mutable_index(ref, str(tmp_path / f"wal_{tag}"),
                                 str(tmp_path / f"ck_{tag}"), "cpu")
    return ref, port


def _serve_both(ref, port, queries, bms, arrivals, events, width):
    p = _graph_params()
    out = []
    for side, mod, ix in (("ref", RS, ref), ("port", TS, port)):
        if side == "ref":
            ex = R.GraphExecutor(ix.graph, ix.store, strategy="sweeping")
            reqs = [mod.Request(rid=i, query=queries[i], bitmap=bms[i],
                                arrival=int(arrivals[i]))
                    for i in range(len(queries))]
            pp = p
        else:
            ex = T.GraphExecutor(ix.graph, ix.store, strategy="sweeping")
            reqs = [mod.Request(rid=i, query=torch.as_tensor(queries[i]),
                                bitmap=T.words_from_uint32(bms[i], "cpu"),
                                arrival=int(arrivals[i]))
                    for i in range(len(queries))]
            pp = torch_params(p)
        evs = [mod.IngestEvent(**dataclasses.asdict(e)) for e in events]
        srv = mod.ContinuousServer(ex, pp, width=width, hop_chunk=8,
                                   index=ix, ingest=evs)
        out.append(srv.serve(reqs, mode="continuous"))
    return out


def _assert_records_equal(rrecs, rinfo, trecs, tinfo):
    assert set(tinfo) == set(rinfo)
    for key in ("ingest_inserts", "ingest_deletes", "ingest_rows", "ticks",
                "step_ticks", "slot_utilization", "compiles"):
        assert tinfo[key] == rinfo[key], key
    assert set(trecs) == set(rrecs)
    for rid in rrecs:
        r, t = rrecs[rid], trecs[rid]
        np.testing.assert_array_equal(np.asarray(r["ids"]), t["ids"])
        np.testing.assert_allclose(t["dists"], np.asarray(r["dists"]),
                                   rtol=1e-5, atol=1e-4)
        for key in ("delta_count", "admit_tick", "retire_tick",
                    "latency_ticks", "rung", "retried"):
            assert r[key] == t[key], (rid, key)
        for f in ("distance_comps", "filter_checks", "hops"):
            assert int(np.asarray(getattr(r["stats"], f))[0]) == \
                int(getattr(t["stats"], f)[0]), (rid, f)


def test_serving_ingest_visible_after_tick(tmp_path):
    """Mutations at tick 0: every later request's merged answer equals
    MutableIndex.search on the post-mutation state (bit for bit in the
    port), and the port's records and info equal the reference's."""
    rng = np.random.RandomState(13)
    base = rng.randn(250, DIM).astype(np.float32)
    ref, port = _serving_pair(tmp_path, base, "srv")
    nq = 4
    queries = rng.randn(nq, DIM).astype(np.float32)
    ins = rng.randn(8, DIM).astype(np.float32)
    queries[0] = ins[0] + 0.01 * rng.randn(DIM).astype(np.float32)
    bms = np.full((nq, port.words()), 0xFFFFFFFF, np.uint32)
    events = [RS.IngestEvent(tick=0, kind="insert", rows=ins),
              RS.IngestEvent(tick=0, kind="delete",
                             ids=np.array([7, 251], np.int64))]
    (rrecs, rinfo), (trecs, tinfo) = _serve_both(
        ref, port, queries, bms, np.ones(nq), events, width=2)
    assert tinfo["ingest_inserts"] == 1 and tinfo["ingest_deletes"] == 1
    assert tinfo["ingest_rows"] == 8
    _assert_records_equal(rrecs, rinfo, trecs, tinfo)
    ids, dists = TS.results_in_order(trecs, nq, K)
    want = port.search(torch.as_tensor(queries), bms,
                       torch_params(_graph_params()), method="sweeping")
    _assert_bits(want.ids, want.dists, ids, dists, "serve vs search")
    assert int(ids[0, 0]) == 250           # planted delta row ranks first
    assert 251 not in ids                  # tombstoned delta row gone
    assert all(r["delta_count"] == 8 for r in trecs.values())
    ref.close()
    port.close()


def test_serving_snapshot_isolation_mid_flight(tmp_path):
    """A request in flight when an insert lands does not see it; one
    admitted afterwards does; as in the reference."""
    rng = np.random.RandomState(17)
    base = rng.randn(250, DIM).astype(np.float32)
    ref, port = _serving_pair(tmp_path, base, "iso")
    q = rng.randn(2, DIM).astype(np.float32)
    ins = rng.randn(4, DIM).astype(np.float32)
    bms = np.full((2, port.words()), 0xFFFFFFFF, np.uint32)
    (rrecs, rinfo), (trecs, tinfo) = _serve_both(
        ref, port, q, bms, np.array([0, 60]),
        [RS.IngestEvent(tick=2, kind="insert", rows=ins)], width=1)
    assert trecs[0]["delta_count"] == 0    # admitted before the insert
    assert trecs[1]["delta_count"] == 4    # admitted after
    _assert_records_equal(rrecs, rinfo, trecs, tinfo)
    ref.close()
    port.close()
