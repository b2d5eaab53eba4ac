"""Crash-consistent live ingestion over the immutable index tiers.

`MutableIndex` keeps the build-time artifacts (HNSW graph, ScaNN leaves,
SQ8 shadow) immutable and routes live mutation through three coupled
mechanisms:

  insert  -> WAL record, fsync, then append to the delta tier
             (storage/delta.py), an unindexed capacity-padded segment
             scanned exactly by `executor.DeltaExecutor`;
  delete  -> WAL record, fsync, then a tombstone bit, composed into every
             query's filter bitmap (`types.bitmap_andnot`), so the row
             vanishes from every strategy without touching an index;
  search  -> any base executor's top-k over [0, base_n) merged with the
             delta scan's top-k by `types.merge_topk`; bit-equal to an
             exact scan over the union (`rebuild_oracle_store`);
  compact -> fold the delta into a rebuilt base (new ScaNN leaves, new
             graph, an SQ8 quantizer calibrated on the grown base), save a
             full checkpoint, then log a COMPACT marker.

Durability protocol: a mutation reaches memory only after its record is
fsynced; `recover()` restores the latest checkpoint and replays the WAL
records past its applied_lsn, so a crash at any byte of the log recovers
an index that searches bit-identically to one that saw the same durable
prefix uncrashed.

The index lives on one device (`device`, the card unless the caller asks
for the CPU): the store, the shadow, the graph and ScaNN are built there,
the delta rows and the tombstone words are mirrored there, and a search
composes the tombstones and clips the base bitmap there.  The WAL, the
checkpoints and the delta tier's durable state are host-side numpy and
byte-equal to the reference package's.

Id space: base rows keep ids [0, base_n), delta rows get base_n + local,
compaction grows the base underneath the same ids, deletes never reclaim
ids (dead rows ride through compaction masked and are pruned from the
rebuilt ScaNN leaf postings).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (latest_step, read_manifest,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.core.executor import DeltaExecutor, make_executor
from repro_torch.core.hnsw import build_graph
from repro_torch.core.scann import build_scann
from repro_torch.core.types import (SearchParams, SearchResult, VectorStore,
                                    bitmap_andnot, bitset_words, merge_topk,
                                    pack_bool_bitmap, probe_batch,
                                    quantize_store, resolve_device,
                                    words_from_uint32)
from repro_torch.storage import wal as W
from repro_torch.storage.delta import DeltaTier, Tombstones
from repro_torch.storage.engine import StorageEngine, make_storage_engine
from repro_torch.storage.faults import FaultInjector, FaultPlan


@dataclasses.dataclass
class MergedResult:
    """A base executor's answer fused with the delta tier's exact scan:
    the merged (Q, k) dists / ids, both legs' SearchStats summed, and each
    leg's full SearchResult."""

    dists: Any
    ids: Any
    stats: Any
    strategy: str
    base: SearchResult
    delta: SearchResult


def _clip_bitmap(words: torch.Tensor, n: int) -> torch.Tensor:
    """A copy of packed (..., W) int32 words with every bit >= n zeroed: the
    base executors' view of a capacity-wide bitmap holds no delta bit."""
    out = words.clone()
    nw = bitset_words(n)
    out[..., nw:] = 0
    rem = n & 31
    if rem:
        out[..., nw - 1] &= (1 << rem) - 1
    return out


@contextlib.contextmanager
def _clock(seconds: dict, key: str, device: torch.device):
    """Add the wall seconds of the block, the device's queue drained at both
    ends, to seconds[key]."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


def _as_words(bitmaps, device) -> torch.Tensor:
    """Filter bitmaps as the port's int32 words on `device` (numpy uint32
    words are reinterpreted)."""
    if isinstance(bitmaps, torch.Tensor):
        return bitmaps.to(device)
    return words_from_uint32(np.asarray(bitmaps), device=device)


class MutableIndex:
    """WAL-backed mutable vector index: immutable base tiers + the delta
    tier + tombstones, with checkpointed compaction and crash recovery.

    `capacity` bounds the total id space ever allocated (base + every
    insert across every compaction): filter bitmaps are sized to it once.
    Write-path faults (FaultPlan.wal_torn_prob / fsync_fail_prob) surface
    as WalTornWrite / WalSyncError with the in-memory state not advanced
    (the failed batch was never written)."""

    def __init__(self, base_vectors, wal_path: str, ckpt_dir: str, *,
                 metric: str = "l2", capacity: Optional[int] = None,
                 delta_capacity: int = 256, num_leaves: int = 16,
                 graph_m: int = 12, ef_construction: int = 48, seed: int = 0,
                 with_graph: bool = True, with_scann: bool = True,
                 with_storage: bool = False,
                 storage_capacity_frac: float = 0.5, wal_pages: int = 64,
                 faults: Optional[FaultPlan] = None, device="cuda",
                 _defer_build: bool = False):
        self.device = resolve_device(device)
        base_n = int(base_vectors.shape[0])
        self.metric = metric
        self.delta_capacity = int(delta_capacity)
        self.capacity = int(capacity if capacity is not None
                            else base_n + 4 * self.delta_capacity)
        self.num_leaves = num_leaves
        self.graph_m = graph_m
        self.ef_construction = ef_construction
        self.seed = seed
        self.with_graph = with_graph
        self.with_scann = with_scann
        self.with_storage = with_storage
        self.storage_capacity_frac = storage_capacity_frac
        self.wal_pages_budget = wal_pages
        self.faults = faults
        self.wal_path = wal_path
        self.ckpt_dir = ckpt_dir

        self._injector = (FaultInjector(faults)
                          if faults is not None and faults.active else None)
        self.applied_lsn = 0
        self._ckpt_step = 0
        self.compactions = 0
        # cumulative logical bytes the user asked to write (the write-
        # amplification denominator)
        self.user_bytes = 0

        if not _defer_build:
            self._build_base(self._on_device(base_vectors))
            self.delta = DeltaTier(base_n=self.base_n,
                                   capacity=self.delta_capacity,
                                   dim=self.store.dim, device=self.device)
            self.tombstones = Tombstones(self.capacity, device=self.device)
            self._open_wal()

    # -- construction internals ---------------------------------------------
    def _on_device(self, vectors) -> torch.Tensor:
        if isinstance(vectors, torch.Tensor):
            return vectors.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(vectors, np.float32),
                               device=self.device)

    def _build_base(self, vectors: torch.Tensor) -> None:
        """(Re)build every base tier from `vectors` on the index's device:
        at construction, after compaction and in recovery.  Deterministic
        given (vectors, seed), so recovery rebuilds the crashed process's
        artifacts."""
        dev = self.device
        # the seconds of the last build, by tier
        self.build_seconds: dict[str, float] = {}
        with _clock(self.build_seconds, "sq8", dev):
            self.store = quantize_store(VectorStore.build(
                vectors, self.metric, device=dev))
        with _clock(self.build_seconds, "scann", dev):
            self.scann = (build_scann(self.store, self.num_leaves,
                                      seed=self.seed, device=dev)
                          if self.with_scann else None)
        with _clock(self.build_seconds, "graph", dev):
            self.graph = (build_graph(self.store, m=self.graph_m,
                                      ef_construction=self.ef_construction,
                                      seed=self.seed, device=dev)
                          if self.with_graph else None)
        self._executors: dict[str, Any] = {}
        self.engine: Optional[StorageEngine] = None
        if self.with_storage:
            self.engine = make_storage_engine(
                self.store, self.scann, self.graph,
                capacity_frac=self.storage_capacity_frac,
                delta_capacity=self.delta_capacity,
                wal_pages=self.wal_pages_budget)
            if self._injector is not None:
                self.engine.pool.faults = self._injector

    def _open_wal(self) -> None:
        hook = None
        if self.engine is not None:
            def hook(offset, nbytes, kind):
                if kind == "append":
                    self.engine.account_wal_append(offset, nbytes)
                else:
                    self.engine.account_wal_sync()
        self.wal = W.WriteAheadLog(self.wal_path, faults=self._injector,
                                   page_hook=hook)

    @property
    def base_n(self) -> int:
        return int(self.store.n)

    @property
    def live_count(self) -> int:
        return self.base_n + self.delta.count - self.tombstones.count

    def words(self) -> int:
        """Filter-bitmap word count callers must size to (fixed for
        life)."""
        return bitset_words(self.capacity)

    # -- the durability choke point -----------------------------------------
    def _log(self, kind: int, payload: bytes) -> W.WalRecord:
        """Append + fsync one record; memory changes only after this
        returns.  An injected write fault leaves the log clean (the torn
        fragment discarded, the unsynced tail rolled back) and re-raises:
        the mutation never happened."""
        try:
            rec = self.wal.append(kind, payload)
        except W.WalTornWrite:
            self.wal.discard_torn()
            raise
        try:
            self.wal.sync()
        except W.WalSyncError:
            self.wal.rollback_to_durable()
            raise
        return rec

    # -- mutation API -------------------------------------------------------
    def insert(self, rows) -> np.ndarray:
        """Durably insert a batch; returns the new global ids.  Compacts
        first when the delta tier cannot hold the batch."""
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.store.dim:
            raise ValueError(f"expected (m, {self.store.dim}) rows, got "
                             f"{rows.shape}")
        m = rows.shape[0]
        if m > self.delta_capacity:
            raise ValueError(f"batch of {m} exceeds delta capacity "
                             f"{self.delta_capacity}")
        if self.delta.count + m > self.delta_capacity:
            self.compact()
        start = self.base_n + self.delta.count
        if start + m > self.capacity:
            raise ValueError(f"id space exhausted: {start}+{m} > capacity "
                             f"{self.capacity}")
        rec = self._log(W.REC_INSERT, W.encode_insert(start, rows))
        local_lo = self.delta.count
        ids = self.delta.append(rows)
        self.applied_lsn = rec.lsn
        self.user_bytes += int(rows.nbytes)
        if self.engine is not None:
            self.engine.account_delta_write(
                np.arange(local_lo, local_lo + m))
        return ids

    def delete(self, ids) -> int:
        """Durably tombstone ids; returns how many were newly dead.  An id
        never allocated is an error; a dead id is an idempotent no-op
        (still logged: replay is idempotent too)."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.unique(np.asarray(ids, np.int64))
        if ids.size and (ids.min() < 0
                         or ids.max() >= self.base_n + self.delta.count):
            raise ValueError("delete of unallocated id")
        rec = self._log(W.REC_DELETE, W.encode_delete(ids))
        newly = self.tombstones.mark(ids)
        self.applied_lsn = rec.lsn
        self.user_bytes += int(ids.nbytes)
        if self.engine is not None and ids.size:
            self.engine.account_tombstone_write(ids)
        return newly

    # -- search -------------------------------------------------------------
    def _executor(self, method: str):
        if method not in self._executors:
            self._executors[method] = make_executor(
                method, self.store, graph=self.graph, index=self.scann,
                storage=self.engine, device=self.device)
        return self._executors[method]

    def _delta_executor(self) -> DeltaExecutor:
        if "delta" not in self._executors:
            self._executors["delta"] = DeltaExecutor(
                self.delta, self.metric, storage=self.engine)
        return self._executors["delta"]

    def live_bitmaps(self, bitmaps) -> tuple[torch.Tensor, torch.Tensor]:
        """(live, base) for packed filter bitmaps over global ids, on the
        device: `live` (Q, words()) is the filter (zero-padded to the
        capacity's width: rows the filter predates do not pass) AND NOT
        the tombstones; `base` is its clip to [0, base_n), the width the
        base executors take."""
        bm = _as_words(bitmaps, self.device)
        w = self.words()
        if bm.shape[-1] < w:
            bm = torch.nn.functional.pad(bm, (0, w - bm.shape[-1]))
        live = bitmap_andnot(bm, self.tombstones.device_words)
        base = _clip_bitmap(live, self.base_n)[..., :bitset_words(
            self.base_n)]
        return live, base

    def search(self, queries, bitmaps, params: SearchParams,
               method: str = "bruteforce") -> MergedResult:
        """Filtered top-k over base + delta - tombstones.

        `bitmaps` (Q, words()) packed filter words over global ids.  The
        tombstones are AND-NOT-composed first, so every strategy sees the
        deletes alike; the base executor runs on the bits < base_n, the
        delta scan on the whole live bitmap, and the two top-k sets merge
        (base first: id-ascending ties) into the answer of one exact scan
        over the union."""
        q = queries.to(self.device) if isinstance(queries, torch.Tensor) \
            else torch.as_tensor(np.asarray(queries, np.float32),
                                 device=self.device)
        live, base_bm = self.live_bitmaps(bitmaps)
        base_res = self._executor(method).search(q, base_bm, params)
        delta_res = self._delta_executor().search(q, live, params)
        dists, ids = merge_topk(base_res.dists, base_res.ids.to(torch.int32),
                                delta_res.dists, delta_res.ids, params.k)
        return MergedResult(dists=dists, ids=ids,
                            stats=base_res.stats + delta_res.stats,
                            strategy=method, base=base_res,
                            delta=delta_res)

    # -- checkpoint / compaction --------------------------------------------
    def _state_tree(self) -> dict:
        return {"base": self.store.vectors,
                "delta": self.delta.vectors.copy(),
                "tomb": self.tombstones.words.copy()}

    def _state_extra(self, kind: str) -> dict:
        return {"kind": kind, "base_n": self.base_n,
                "count": int(self.delta.count),
                "applied_lsn": int(self.applied_lsn),
                "capacity": self.capacity,
                "delta_capacity": self.delta_capacity,
                "compactions": self.compactions}

    def checkpoint(self) -> int:
        """Durably snapshot (base, delta, tombstones) + applied_lsn;
        recovery replays only WAL records past it.  Returns the step."""
        self._ckpt_step += 1
        save_checkpoint(self.ckpt_dir, self._ckpt_step, self._state_tree(),
                        extra=self._state_extra("delta"), fsync=True)
        self._log(W.REC_CHECKPOINT,
                  W.encode_meta({"step": self._ckpt_step,
                                 "applied_lsn": int(self.applied_lsn)}))
        if self.engine is not None:
            self.engine.account_checkpoint(self.delta.count)
        return self._ckpt_step

    def compact(self) -> None:
        """Fold the delta tier into a rebuilt base: the new base array (ids
        stable, tombstoned rows along dead), fresh ScaNN leaves with dead
        rows pruned from the postings, a fresh graph and an SQ8 quantizer
        calibrated on the grown base.  The full checkpoint of the folded
        state is durable before the COMPACT marker enters the WAL, so
        every crash point recovers deterministically (before the
        checkpoint: replay rebuilds the pre-compaction state; after it:
        the checkpoint is the folded state and the marker a no-op)."""
        secs: dict[str, float] = {}
        dev = self.device
        count = self.delta.count
        with _clock(secs, "read", dev):
            if self.engine is not None:
                self.engine.account_compaction_read(count)
            new_base = torch.cat([self.store.vectors, self._on_device(
                self.delta.vectors[:count])])
        self._build_base(new_base)
        secs.update(self.build_seconds)
        with _clock(secs, "prune", dev):
            if self.scann is not None:
                rowids = self.scann.leaf_rowids
                dead = probe_batch(self.tombstones.device_words[None],
                                   rowids.reshape(1, -1)
                                   ).reshape(rowids.shape)
                self.scann = dataclasses.replace(
                    self.scann, leaf_rowids=torch.where(
                        dead, torch.full_like(rowids, -1), rowids))
                self._executors.clear()      # executors captured old scann
        self.delta.reset(self.base_n)
        self.compactions += 1
        self._ckpt_step += 1
        with _clock(secs, "checkpoint", dev):
            save_checkpoint(self.ckpt_dir, self._ckpt_step,
                            self._state_tree(),
                            extra=self._state_extra("full"), fsync=True)
        with _clock(secs, "marker", dev):
            self._log(W.REC_COMPACT,
                      W.encode_meta({"step": self._ckpt_step,
                                     "base_n": self.base_n,
                                     "applied_lsn": int(self.applied_lsn)}))
            if self.engine is not None:
                self.engine.account_compaction_write()
        # the seconds of the last compaction, by step
        self.compaction_seconds = secs

    # -- recovery -----------------------------------------------------------
    @classmethod
    def recover(cls, base_vectors, wal_path: str, ckpt_dir: str,
                **kwargs) -> "MutableIndex":
        """Reconstruct the index a crashed process left behind: restore the
        latest durable checkpoint (or the pristine base), reopen the WAL
        (truncating a torn tail by CRC) and replay the records with lsn >
        the checkpoint's applied_lsn.  The same (base_vectors, seed,
        durable WAL prefix) always yields an index whose searches are
        bit-identical to one that executed that prefix uncrashed."""
        self = cls(base_vectors, wal_path, ckpt_dir, _defer_build=True,
                   **kwargs)
        dim = int(base_vectors.shape[1])
        step = latest_step(ckpt_dir)
        if step is not None:
            extra = read_manifest(ckpt_dir, step)["extra"]
            like = {"base": np.zeros((extra["base_n"], dim), np.float32),
                    "delta": np.zeros((extra["delta_capacity"], dim),
                                      np.float32),
                    "tomb": np.zeros(bitset_words(extra["capacity"]),
                                     np.uint32)}
            tree, _ = restore_checkpoint(ckpt_dir, step, like)
            self.capacity = int(extra["capacity"])
            self.delta_capacity = int(extra["delta_capacity"])
            self._build_base(self._on_device(tree["base"]))
            self.delta = DeltaTier(
                base_n=self.base_n, capacity=self.delta_capacity,
                dim=dim, count=int(extra["count"]),
                vectors=np.array(tree["delta"], np.float32),
                device=self.device)
            self.tombstones = Tombstones(self.capacity, words=tree["tomb"],
                                         device=self.device)
            self.applied_lsn = int(extra["applied_lsn"])
            self._ckpt_step = step
            self.compactions = int(extra.get("compactions", 0))
        else:
            self._build_base(self._on_device(base_vectors))
            self.delta = DeltaTier(base_n=self.base_n,
                                   capacity=self.delta_capacity, dim=dim,
                                   device=self.device)
            self.tombstones = Tombstones(self.capacity, device=self.device)
        self._open_wal()
        for rec in self.wal.replay(from_lsn=self.applied_lsn):
            if rec.kind == W.REC_INSERT:
                start, vecs = W.decode_insert(rec.payload)
                expect = self.base_n + self.delta.count
                if start != expect:
                    raise W.WalCorruption(
                        f"insert record lsn {rec.lsn} starts at id "
                        f"{start}, expected {expect}")
                local_lo = self.delta.count
                self.delta.append(vecs)
                if self.engine is not None:
                    self.engine.account_delta_write(
                        np.arange(local_lo, local_lo + vecs.shape[0]))
                self.user_bytes += int(vecs.nbytes)
            elif rec.kind == W.REC_DELETE:
                ids = W.decode_delete(rec.payload)
                self.tombstones.mark(ids)
                if self.engine is not None and ids.size:
                    self.engine.account_tombstone_write(ids)
                self.user_bytes += int(ids.nbytes)
            # REC_CHECKPOINT / REC_COMPACT are markers: the state they
            # describe was restored from the checkpoint store already
            # (compaction checkpoints durably before logging its marker)
            self.applied_lsn = rec.lsn
        return self

    def close(self) -> None:
        self.wal.close()


def rebuild_oracle_store(index: MutableIndex
                         ) -> tuple[VectorStore, torch.Tensor]:
    """The from-scratch oracle the merge must equal bit for bit: a
    capacity-padded store on the index's device holding the base rows then
    the delta rows (zeros beyond), and the packed live mask (allocated
    AND NOT tombstoned, (words(),) int32) to AND into a filter bitmap
    before `bruteforce.filtered_knn` over the whole store.  Padding rows
    never score: their mask bit is 0."""
    cap, dim, dev = index.capacity, index.store.dim, index.device
    full = torch.zeros((cap, dim), dtype=torch.float32, device=dev)
    full[:index.base_n] = index.store.vectors
    n_alloc = index.base_n + index.delta.count
    full[index.base_n:n_alloc] = index._on_device(
        index.delta.vectors[:index.delta.count])
    alloc = torch.zeros(cap, dtype=torch.bool, device=dev)
    alloc[:n_alloc] = True
    live = bitmap_andnot(pack_bool_bitmap(alloc),
                         index.tombstones.device_words)
    return VectorStore.build(full, index.metric, device=dev), live
