"""The port's WAL and crash recovery (`repro_torch.storage.wal`,
`MutableIndex.recover`) on the CPU: the twin of
tests/test_wal_recovery.py, plus the WAL bytes and the checkpoint
directories against the reference's.

* The WAL unit layer: CRC32C's known vector, record round trips, torn-tail
  truncation at every cut, mid-log damage, reopen and rollback; the log a
  MutableIndex writes is byte-equal to the reference's for the same
  operations.
* The crash matrix: ingestion killed at every record boundary and inside
  every record; the recovered index searches bit-identically to the
  uncrashed one at that durable prefix (bruteforce, sweeping, scann), at
  the reference test's sizes.  Checkpoint-bounded replay, compaction's
  crash points, write-fault survival.
* Cross-recovery on integer data: the port recovers from the reference's
  WAL and checkpoint directory, and the reference from the port's, with
  equal searches.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.mutable import MutableIndex as RMutable
from repro.storage import wal as RW
from repro_torch.core import SearchParams
from repro_torch.core.mutable import MutableIndex
from repro_torch.storage import wal as W
from repro_torch.storage.faults import FaultPlan
from torch_parity import exact_vectors, torch_params

torch.set_num_threads(1)

pytestmark = pytest.mark.crash

DIM = 12
METHODS = ("bruteforce", "sweeping", "scann")


def _params(method):
    return SearchParams(k=5, strategy=method, ef_search=32, beam_width=32,
                        max_hops=150, num_leaves_to_search=4)


def _snap(idx, queries, bitmaps, methods=METHODS):
    out = {}
    for m in methods:
        res = idx.search(torch.as_tensor(queries), bitmaps, _params(m),
                         method=m)
        out[m] = (res.ids.numpy().copy(), res.dists.numpy().copy())
    return out


def _assert_snap_equal(ref, got, ctx):
    for m in ref:
        np.testing.assert_array_equal(ref[m][0], got[m][0],
                                      err_msg=f"{m} ids diverged: {ctx}")
        np.testing.assert_array_equal(ref[m][1].view(np.int32),
                                      got[m][1].view(np.int32),
                                      err_msg=f"{m} dists diverged: {ctx}")


def _index_kwargs():
    return dict(delta_capacity=32, with_graph=True, with_scann=True,
                num_leaves=4, graph_m=8, ef_construction=32, seed=0,
                device="cpu")


# ---------------------------------------------------------------------------
# WAL unit layer
# ---------------------------------------------------------------------------

def test_crc32c_known_vector():
    # RFC 3720 / iSCSI check value for "123456789"
    assert W.crc32c(b"123456789") == 0xE3069283
    assert W.crc32c(b"") == 0
    data = bytes(range(256)) * 3
    assert W.crc32c(data) == RW.crc32c(data)
    assert W.crc32c(data[7:], W.crc32c(data[:7])) == W.crc32c(data)


def test_record_roundtrip(tmp_path):
    path = str(tmp_path / "wal")
    w = W.WriteAheadLog(path)
    rng = np.random.RandomState(0)
    vecs = rng.randn(3, DIM).astype(np.float32)
    ids = np.array([4, 9], np.int64)
    w.append(W.REC_INSERT, W.encode_insert(100, vecs))
    w.append(W.REC_DELETE, W.encode_delete(ids))
    w.append(W.REC_CHECKPOINT, W.encode_meta({"step": 1}))
    w.sync()
    recs = w.replay()
    assert [r.lsn for r in recs] == [1, 2, 3]
    start, got = W.decode_insert(recs[0].payload)
    assert start == 100
    np.testing.assert_array_equal(got, vecs)
    np.testing.assert_array_equal(W.decode_delete(recs[1].payload), ids)
    assert W.decode_meta(recs[2].payload) == {"step": 1}
    w.close()
    # the reference reads the port's log record for record
    want = list(RW.iter_records(path))
    assert [(r.lsn, r.kind, r.payload, r.offset, r.length) for r in want] \
        == [(r.lsn, r.kind, r.payload, r.offset, r.length) for r in recs]


def test_torn_tail_truncates_at_every_cut(tmp_path):
    path = str(tmp_path / "wal")
    w = W.WriteAheadLog(path)
    for i in range(3):
        w.append(W.REC_DELETE,
                 W.encode_delete(np.arange(i + 1, dtype=np.int64)))
    w.sync()
    recs = w.replay()
    w.close()
    full = open(path, "rb").read()
    bounds = [0] + [r.end for r in recs]
    for cut in range(len(full) + 1):
        t = str(tmp_path / "cut")
        with open(t, "wb") as f:
            f.write(full[:cut])
        got = list(W.iter_records(t))
        expect = sum(1 for b in bounds[1:] if b <= cut)
        assert len(got) == expect, f"cut at {cut}"
        assert [r.lsn for r in got] == list(range(1, expect + 1))


def test_mid_log_damage_raises_corruption(tmp_path):
    path = str(tmp_path / "wal")
    w = W.WriteAheadLog(path)
    for i in range(3):
        w.append(W.REC_DELETE, W.encode_delete(np.array([i], np.int64)))
    w.sync()
    w.close()
    data = bytearray(open(path, "rb").read())
    data[W.HEADER_BYTES + 2] ^= 0xFF          # payload bit-flip, record 1
    bad = str(tmp_path / "bad")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(W.WalCorruption):
        list(W.iter_records(bad))
    first_end = next(iter(W.iter_records(path))).end
    open(bad, "wb").write(bytes(data[:first_end]))
    assert list(W.iter_records(bad)) == []    # the same damage, torn


def test_reopen_truncates_torn_tail_and_continues(tmp_path):
    path = str(tmp_path / "wal")
    w = W.WriteAheadLog(path)
    w.append(W.REC_DELETE, W.encode_delete(np.array([1], np.int64)))
    rec2 = w.append(W.REC_DELETE, W.encode_delete(np.array([2], np.int64)))
    w.sync()
    w.close()
    with open(path, "r+b") as f:
        f.truncate(rec2.end - 3)
    w2 = W.WriteAheadLog(path)
    assert w2.next_lsn == 2 and w2.offset == rec2.offset
    w2.append(W.REC_DELETE, W.encode_delete(np.array([3], np.int64)))
    w2.sync()
    recs = w2.replay()
    assert [r.lsn for r in recs] == [1, 2]
    np.testing.assert_array_equal(W.decode_delete(recs[1].payload), [3])
    w2.close()


def test_rollback_to_durable(tmp_path):
    path = str(tmp_path / "wal")
    w = W.WriteAheadLog(path)
    w.append(W.REC_DELETE, W.encode_delete(np.array([1], np.int64)))
    w.sync()
    w.append(W.REC_DELETE, W.encode_delete(np.array([2], np.int64)))
    w.rollback_to_durable()
    assert w.offset == w.durable_offset and w.next_lsn == 2
    w.append(W.REC_DELETE, W.encode_delete(np.array([3], np.int64)))
    w.sync()
    recs = w.replay()
    assert [r.lsn for r in recs] == [1, 2]
    np.testing.assert_array_equal(W.decode_delete(recs[1].payload), [3])
    w.close()


def test_crash_copy_and_discard_torn(tmp_path):
    path = str(tmp_path / "wal")
    w = W.WriteAheadLog(path, faults=_AlwaysTorn())
    with pytest.raises(W.WalTornWrite):
        w.append(W.REC_DELETE, W.encode_delete(np.array([1], np.int64)))
    assert os.path.getsize(path) > 0          # the fragment reached disk
    w.discard_torn()
    assert os.path.getsize(path) == 0
    w.faults = None
    w.append(W.REC_DELETE, W.encode_delete(np.array([2], np.int64)))
    copy = w.crash_copy(str(tmp_path / "c0"))  # nothing synced yet
    assert os.path.getsize(copy) == 0
    w.sync()
    copy = w.crash_copy(str(tmp_path / "c1"))
    assert [r.lsn for r in W.iter_records(copy)] == [1]
    w.close()


class _AlwaysTorn:
    def on_wal_append(self, nbytes):
        return nbytes // 2

    def on_fsync(self):
        return False


def _ops(rng, integer=False):
    def rows(m):
        if integer:
            return rng.randint(-127, 128, (m, DIM)).astype(np.float32)
        return rng.randn(m, DIM).astype(np.float32)
    return [
        ("insert", rows(4)),
        ("delete", np.array([3, 151], np.int64)),
        ("insert", rows(2)),
        ("insert", rows(5)),
        ("delete", np.array([155, 40], np.int64)),
        ("insert", rows(1)),
    ]


def _apply(idx, op):
    if op[0] == "insert":
        idx.insert(op[1])
    else:
        idx.delete(op[1])


def test_wal_bytes_equal_reference(tmp_path):
    """The same operations (inserts, deletes, a checkpoint, a compaction)
    write the same log, byte for byte, and the same checkpoint files."""
    rng = np.random.RandomState(1)
    base = rng.randn(150, DIM).astype(np.float32)
    kw = dict(delta_capacity=16, with_graph=False, with_scann=False)
    ref = RMutable(base, str(tmp_path / "rwal"), str(tmp_path / "rck"), **kw)
    port = MutableIndex(base, str(tmp_path / "wal"), str(tmp_path / "ck"),
                        device="cpu", **kw)
    for i, op in enumerate(_ops(rng)):
        for ix in (ref, port):
            _apply(ix, op)
            if i == 2:
                ix.checkpoint()
    for ix in (ref, port):
        ix.compact()
        ix.insert(np.ones((2, DIM), np.float32))
        ix.close()
    assert open(tmp_path / "wal", "rb").read() == \
        open(tmp_path / "rwal", "rb").read()
    for step in ("step_00000001", "step_00000002"):
        names = sorted(os.listdir(tmp_path / "rck" / step))
        assert sorted(os.listdir(tmp_path / "ck" / step)) == names
        for name in names:
            assert open(tmp_path / "ck" / step / name, "rb").read() == \
                open(tmp_path / "rck" / step / name, "rb").read(), name


# ---------------------------------------------------------------------------
# the crash matrix
# ---------------------------------------------------------------------------

def test_crash_matrix_every_record_boundary(tmp_path):
    """Kill ingestion at every WAL record boundary and inside every record;
    the recovered index's searches are bit-identical to the uncrashed one
    at that durable prefix, for all three executor families."""
    rng = np.random.RandomState(2)
    base = rng.randn(150, DIM).astype(np.float32)
    queries = rng.randn(3, DIM).astype(np.float32)
    wal_path = str(tmp_path / "wal")
    idx = MutableIndex(base, wal_path, str(tmp_path / "ck"),
                       **_index_kwargs())
    bm = np.full((3, idx.words()), 0xFFFFFFFF, np.uint32)
    snaps = {0: _snap(idx, queries, bm)}
    for op in _ops(rng):
        _apply(idx, op)
        snaps[idx.applied_lsn] = _snap(idx, queries, bm)
    recs = idx.wal.replay()
    points = [(0, 0)]
    prev_lsn = 0
    for r in recs:
        points.append((r.offset + r.length // 2, prev_lsn))   # torn tail
        points.append((r.end, r.lsn))
        prev_lsn = r.lsn
    for i, (cut, durable_lsn) in enumerate(points):
        crashed = str(tmp_path / f"crash_{i}")
        idx.wal.crash_copy(crashed, at_bytes=cut)
        r_idx = MutableIndex.recover(base, crashed, str(tmp_path / f"ck_{i}"),
                                     **_index_kwargs())
        assert r_idx.applied_lsn == durable_lsn, f"point {i} (cut {cut})"
        _assert_snap_equal(snaps[durable_lsn], _snap(r_idx, queries, bm),
                           f"crash point {i} (cut {cut}, lsn {durable_lsn})")
        r_idx.close()
    idx.close()


def test_checkpoint_bounds_replay(tmp_path):
    rng = np.random.RandomState(4)
    base = rng.randn(150, DIM).astype(np.float32)
    queries = rng.randn(3, DIM).astype(np.float32)
    wal_path, ck = str(tmp_path / "wal"), str(tmp_path / "ck")
    idx = MutableIndex(base, wal_path, ck, **_index_kwargs())
    bm = np.full((3, idx.words()), 0xFFFFFFFF, np.uint32)
    ops = _ops(rng)
    for op in ops[:3]:
        _apply(idx, op)
    step = idx.checkpoint()
    ckpt_lsn = idx.applied_lsn
    for op in ops[3:]:
        _apply(idx, op)
    ref = _snap(idx, queries, bm)
    r_idx = MutableIndex.recover(base, wal_path, ck, **_index_kwargs())
    assert r_idx._ckpt_step == step
    assert r_idx.applied_lsn == idx.applied_lsn > ckpt_lsn
    _assert_snap_equal(ref, _snap(r_idx, queries, bm), "post-checkpoint")
    idx.close()
    r_idx.close()


def test_compaction_crash_recovery(tmp_path):
    """Crashing before compaction began, after its checkpoint but before
    its marker, and after the marker all recover bit-identically."""
    rng = np.random.RandomState(6)
    base = rng.randn(120, DIM).astype(np.float32)
    queries = rng.randn(3, DIM).astype(np.float32)
    wal_path, ck = str(tmp_path / "wal"), str(tmp_path / "ck")
    idx = MutableIndex(base, wal_path, ck, **_index_kwargs())
    bm = np.full((3, idx.words()), 0xFFFFFFFF, np.uint32)
    idx.insert(rng.randn(10, DIM).astype(np.float32))
    idx.delete(np.array([5, 125], np.int64))
    pre_snap = _snap(idx, queries, bm)
    pre_lsn, pre_offset = idx.applied_lsn, idx.wal.offset
    ck_pre = str(tmp_path / "ck_pre")
    shutil.copytree(ck, ck_pre) if os.path.isdir(ck) else os.makedirs(ck_pre)
    idx.compact()
    post_snap = _snap(idx, queries, bm)
    marker = idx.wal.replay()[-1]
    assert marker.kind == W.REC_COMPACT
    wal_a = idx.wal.crash_copy(str(tmp_path / "wal_a"), at_bytes=pre_offset)
    r_a = MutableIndex.recover(base, wal_a, ck_pre, **_index_kwargs())
    assert r_a.applied_lsn == pre_lsn and r_a.compactions == 0
    _assert_snap_equal(pre_snap, _snap(r_a, queries, bm), "pre-compaction")
    for cut, name in ((marker.offset, "before the marker"),
                      (marker.offset + marker.length // 2,
                       "inside the marker"),
                      (None, "after the marker")):
        wal_b = idx.wal.crash_copy(str(tmp_path / "wal_b"), at_bytes=cut)
        r_b = MutableIndex.recover(base, wal_b, ck, **_index_kwargs())
        assert r_b.compactions == 1 and r_b.base_n == idx.base_n
        _assert_snap_equal(post_snap, _snap(r_b, queries, bm), name)
        r_b.close()
    idx.close()
    r_a.close()


def test_write_fault_survival(tmp_path):
    """Injected torn appends and failed fsyncs: every faulted mutation
    never happened; the index matches a clean shadow before and after
    recovery, and the faults fire where the reference's do."""
    plan = FaultPlan(seed=3, wal_torn_prob=0.35, fsync_fail_prob=0.25)
    rng = np.random.RandomState(8)
    base = rng.randn(100, DIM).astype(np.float32)
    queries = rng.randn(3, DIM).astype(np.float32)
    kwargs = dict(delta_capacity=64, with_graph=False, with_scann=False,
                  device="cpu")
    idx = MutableIndex(base, str(tmp_path / "wal"), str(tmp_path / "ck"),
                       faults=plan, **kwargs)
    shadow = MutableIndex(base, str(tmp_path / "wal_s"),
                          str(tmp_path / "ck_s"), **kwargs)
    import repro.storage.faults as RF
    rkw = {k: v for k, v in kwargs.items() if k != "device"}
    ref = RMutable(base, str(tmp_path / "rwal"), str(tmp_path / "rck"),
                   faults=RF.FaultPlan(seed=3, wal_torn_prob=0.35,
                                       fsync_fail_prob=0.25), **rkw)
    faulted = []
    for i in range(20):
        if rng.rand() < 0.7:
            op = ("insert", rng.randn(rng.randint(1, 4),
                                      DIM).astype(np.float32))
        else:
            op = ("delete", rng.randint(0, 100 + idx.delta.count,
                                        size=2).astype(np.int64))
        outcome = []
        for ix in (idx, ref):
            try:
                _apply(ix, op)
                outcome.append(None)
            except (W.WalTornWrite, W.WalSyncError, RW.WalTornWrite,
                    RW.WalSyncError) as e:
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1], i
        if outcome[0] is not None:
            faulted.append(i)
            continue
        _apply(shadow, op)
    assert 0 < len(faulted) < 20
    assert open(tmp_path / "wal", "rb").read() == \
        open(tmp_path / "rwal", "rb").read()
    bm = np.full((3, idx.words()), 0xFFFFFFFF, np.uint32)
    p = SearchParams(k=5, strategy="bruteforce")
    want = shadow.search(torch.as_tensor(queries), bm, p)
    live = idx.search(torch.as_tensor(queries), bm, p)
    np.testing.assert_array_equal(want.ids.numpy(), live.ids.numpy())
    idx.close()
    ref.close()
    r_idx = MutableIndex.recover(base, str(tmp_path / "wal"),
                                 str(tmp_path / "ck"), **kwargs)
    got = r_idx.search(torch.as_tensor(queries), bm, p)
    np.testing.assert_array_equal(want.ids.numpy(), got.ids.numpy())
    np.testing.assert_array_equal(want.dists.numpy().view(np.int32),
                                  got.dists.numpy().view(np.int32))
    shadow.close()
    r_idx.close()


# ---------------------------------------------------------------------------
# cross-recovery between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_recovery_between_packages(tmp_path, writer):
    """One package ingests (a checkpoint, a compaction and a tail of
    records past it); the other recovers from its WAL and checkpoint
    directory and searches as the writer does, exactly (integer data)."""
    base, queries = exact_vectors(150, DIM, 3, seed=5)
    rng = np.random.RandomState(5)
    kw = dict(delta_capacity=16, with_graph=False, with_scann=False)
    wal_path, ck = str(tmp_path / "wal"), str(tmp_path / "ck")
    if writer == "reference":
        w = RMutable(base, wal_path, ck, **kw)
    else:
        w = MutableIndex(base, wal_path, ck, device="cpu", **kw)
    ops = _ops(rng, integer=True)
    for i, op in enumerate(ops):
        _apply(w, op)
        if i == 1:
            w.checkpoint()
        if i == 3:
            w.compact()
    bm = np.full((3, w.words()), 0xFFFFFFFF, np.uint32)
    p = SearchParams(k=5, strategy="bruteforce")
    rp = R.SearchParams(k=5, strategy="bruteforce")
    if writer == "reference":
        want = w.search(jnp.asarray(queries), jnp.asarray(bm), rp)
        got = MutableIndex.recover(base, wal_path, ck, device="cpu", **kw)
        res = got.search(torch.as_tensor(queries), bm, p)
        ids, dists = res.ids.numpy(), res.dists.numpy()
    else:
        want = w.search(torch.as_tensor(queries), bm, p)
        got = RMutable.recover(base, wal_path, ck, **kw)
        res = got.search(jnp.asarray(queries), jnp.asarray(bm), rp)
        ids, dists = np.asarray(res.ids), np.asarray(res.dists)
    assert got.applied_lsn == w.applied_lsn
    assert got.compactions == w.compactions == 1
    assert got.tombstones.words.tobytes() == w.tombstones.words.tobytes()
    assert got.delta.vectors.tobytes() == w.delta.vectors.tobytes()
    np.testing.assert_array_equal(np.asarray(want.ids), ids)
    np.testing.assert_array_equal(
        np.asarray(want.dists, np.float32).view(np.int32),
        dists.view(np.int32))
    w.close()
    got.close()
