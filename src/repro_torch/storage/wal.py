"""Write-ahead log of the mutable index (numpy and the standard library;
the log bytes equal the reference package's for the same operations).

Every mutation against a `MutableIndex` (core/mutable.py) is made durable
here BEFORE it is applied to the in-memory delta tier — the classic WAL
protocol, so a crash at any instant loses at most the un-fsynced tail and
never leaves the applied state ahead of the log.

Record format (little-endian, fixed 20-byte header + payload):

    magic   u16   0xDA7A  — resync guard; a mismatch means corruption
    type    u8    record kind (INSERT / DELETE / CHECKPOINT / COMPACT)
    _pad    u8    zero
    lsn     u64   monotone log sequence number (1-based)
    len     u32   payload byte length
    crc     u32   CRC32C (Castagnoli) over (type, _pad, lsn, len, payload)
    payload len bytes

The CRC covers the header fields *and* the payload, so a torn tail — a
crash mid-append leaving a prefix of a record on disk — is detected
exactly: `replay()` stops at the first record whose bytes are incomplete
OR whose CRC mismatches at end-of-log (the torn tail, reported via
`tail_torn`), and raises `WalCorruption` only when garbage is followed by
further intact records (true corruption, not a crash artifact).

Durability model: `append()` buffers through the OS file (write syscall);
`sync()` flushes + fsyncs and advances `durable_offset`.  The
deterministic crash harness uses `durable_offset` / record boundaries as
its crash points: `crash_copy(path, at_bytes)` materializes what the disk
would hold if the process died after exactly `at_bytes` bytes reached
storage.  Write-path fault injection (storage/faults.py): a torn-append
fault writes a deterministic prefix of the record and raises
`WalTornWrite` (the process "died" mid-write); a failed fsync raises
`WalSyncError` with the log rolled back to the last durable point; both
draws are counter-keyed splitmix64, replayable run after run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
from typing import Iterator, Optional

import numpy as np

_MAGIC = 0xDA7A
_HEADER = struct.Struct("<HBBQLL")        # magic, type, pad, lsn, len, crc
HEADER_BYTES = _HEADER.size               # 20

# record kinds
REC_INSERT = 1
REC_DELETE = 2
REC_CHECKPOINT = 3
REC_COMPACT = 4
_KINDS = (REC_INSERT, REC_DELETE, REC_CHECKPOINT, REC_COMPACT)


# -- CRC32C (Castagnoli), table-driven ---------------------------------------

def _make_crc32c_table() -> list[int]:
    poly = 0x82F63B78                      # reflected Castagnoli
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C over `data` (optionally continuing a running crc)."""
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class WalCorruption(Exception):
    """Garbage mid-log (bad magic / CRC with MORE valid data after it) —
    not a torn tail, which replay() truncates silently."""


class WalTornWrite(Exception):
    """Injected torn append: the process 'crashed' mid-write.  The WAL
    file holds a prefix of the record; the owning MutableIndex must be
    recovered before further use."""


class WalSyncError(Exception):
    """Injected fsync failure: bytes since the last successful sync may
    not have reached storage (wal.durable_offset did not advance)."""


@dataclasses.dataclass(frozen=True)
class WalRecord:
    lsn: int
    kind: int
    payload: bytes
    offset: int          # byte offset of the record header in the file
    length: int          # total on-disk bytes (header + payload)

    @property
    def end(self) -> int:
        return self.offset + self.length


def encode_record(kind: int, lsn: int, payload: bytes) -> bytes:
    if kind not in _KINDS:
        raise ValueError(f"unknown WAL record kind {kind}")
    body = struct.pack("<BBQL", kind, 0, lsn, len(payload)) + payload
    crc = crc32c(body)
    return _HEADER.pack(_MAGIC, kind, 0, lsn, len(payload), crc) + payload


# -- payload codecs (numpy, fixed little-endian) -----------------------------

def encode_insert(start_id: int, vectors: np.ndarray) -> bytes:
    v = np.ascontiguousarray(vectors, dtype="<f4")
    head = struct.pack("<QLL", start_id, v.shape[0], v.shape[1])
    return head + v.tobytes()


def decode_insert(payload: bytes) -> tuple[int, np.ndarray]:
    start_id, rows, dim = struct.unpack_from("<QLL", payload, 0)
    v = np.frombuffer(payload, dtype="<f4", offset=16,
                      count=rows * dim).reshape(rows, dim)
    return start_id, np.array(v, dtype=np.float32)   # writable copy


def encode_delete(ids: np.ndarray) -> bytes:
    a = np.ascontiguousarray(ids, dtype="<i8")
    return struct.pack("<L", a.shape[0]) + a.tobytes()


def decode_delete(payload: bytes) -> np.ndarray:
    (n,) = struct.unpack_from("<L", payload, 0)
    return np.array(np.frombuffer(payload, dtype="<i8", offset=4, count=n),
                    dtype=np.int64)


def encode_meta(meta: dict) -> bytes:
    return json.dumps(meta, sort_keys=True).encode()


def decode_meta(payload: bytes) -> dict:
    return json.loads(payload.decode())


class WriteAheadLog:
    """Append-only WAL over one file.

    `faults` is an optional storage/faults.FaultInjector whose WRITE-path
    draws (`on_wal_append`, `on_fsync`) are counter-keyed on the WAL's own
    append/sync counters — deterministic per (plan.seed, counter), exactly
    like the read-path faults.

    `page_hook(offset, nbytes, kind)` is called once per physical write
    ("append" data, "sync" flush) so the storage engine can charge WAL
    page I/O through the buffer pool (kind "append" dirties the touched
    pages; "sync" flushes them).
    """

    def __init__(self, path: str, faults=None, page_hook=None):
        self.path = path
        self.faults = faults
        self.page_hook = page_hook
        exists = os.path.exists(path)
        self._f = open(path, "ab" if exists else "wb")
        self._f.seek(0, os.SEEK_END)
        self.offset = self._f.tell()         # logical end of log
        self.durable_offset = self.offset    # advanced by sync()
        self.next_lsn = 1
        if exists and self.offset:
            last = None
            for rec in iter_records(path):
                last = rec
            if last is not None:
                self.next_lsn = last.lsn + 1
                # anything past the last intact record is a torn tail
                self.offset = last.end
                self.durable_offset = last.end
                self._f.seek(last.end)
                self._f.truncate(last.end)

    # -- write path ---------------------------------------------------------
    def append(self, kind: int, payload: bytes) -> WalRecord:
        """Durably order one record (buffered; call sync() for fsync).
        Raises WalTornWrite when an injected torn-append fault fires —
        the on-disk file then holds a prefix of the record."""
        lsn = self.next_lsn
        raw = encode_record(kind, lsn, payload)
        torn = None
        if self.faults is not None:
            torn = self.faults.on_wal_append(len(raw))
        if torn is not None:
            self._f.write(raw[:torn])
            self._f.flush()
            raise WalTornWrite(
                f"torn WAL append at lsn {lsn}: {torn}/{len(raw)} bytes "
                f"reached the file")
        self._f.write(raw)
        rec = WalRecord(lsn, kind, payload, self.offset, len(raw))
        if self.page_hook is not None:
            self.page_hook(self.offset, len(raw), "append")
        self.offset += len(raw)
        self.next_lsn = lsn + 1
        return rec

    def sync(self) -> int:
        """fsync the log; returns the new durable offset.  An injected
        fsync failure raises WalSyncError and leaves durable_offset where
        it was (the tail may be lost on crash)."""
        if self.faults is not None and self.faults.on_fsync():
            raise WalSyncError(
                f"fsync failed; durable through byte {self.durable_offset} "
                f"of {self.offset}")
        self._f.flush()
        os.fsync(self._f.fileno())
        if self.page_hook is not None and self.offset > self.durable_offset:
            self.page_hook(self.durable_offset,
                           self.offset - self.durable_offset, "sync")
        self.durable_offset = self.offset
        return self.durable_offset

    def discard_torn(self) -> None:
        """After a WalTornWrite: drop the torn fragment (bytes past the
        last complete record) so in-process appends can continue without
        a full recover — exactly what reopening the file would do."""
        self._f.flush()
        self._f.truncate(self.offset)
        self._f.seek(self.offset)

    def rollback_to_durable(self) -> None:
        """After a WalSyncError: the un-fsynced tail may never reach
        storage, so applying its mutations anyway would let memory run
        ahead of the log.  Drop the tail (truncate to durable_offset) and
        rewind next_lsn from the surviving records — the failed batch is
        simply 'not written', deterministically."""
        self._f.flush()
        self._f.truncate(self.durable_offset)
        self._f.seek(self.durable_offset)
        self.offset = self.durable_offset
        last = None
        for rec in iter_records(self.path):
            last = rec
        self.next_lsn = last.lsn + 1 if last is not None else 1

    def close(self) -> None:
        self._f.close()

    # -- read path ----------------------------------------------------------
    def replay(self, from_lsn: int = 0) -> list[WalRecord]:
        """All intact records with lsn > from_lsn, in order.  Stops
        cleanly at a torn tail (see iter_records)."""
        self._f.flush()
        return [r for r in iter_records(self.path) if r.lsn > from_lsn]

    # -- crash simulation ---------------------------------------------------
    def crash_copy(self, dest: str, at_bytes: Optional[int] = None) -> str:
        """Materialize the file a crash would leave behind: the first
        `at_bytes` bytes of the log (default: `durable_offset` — what an
        OS that lost the un-fsynced page cache would present)."""
        self._f.flush()
        cut = self.durable_offset if at_bytes is None else at_bytes
        shutil.copyfile(self.path, dest)
        with open(dest, "r+b") as f:
            f.truncate(cut)
        return dest


def iter_records(path: str) -> Iterator[WalRecord]:
    """Scan a WAL file, yielding intact records in order.

    Termination contract (the crash-consistency core, tested at every
    record boundary): a record whose header is incomplete, whose payload
    is shorter than its header claims, or whose CRC mismatches is treated
    as the TORN TAIL iff it reaches end-of-file — iteration stops there
    (the crash lost that record; everything before it is intact).  The
    same damage followed by more bytes than the record claims is true
    corruption and raises WalCorruption.
    """
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    total = len(data)
    expect_lsn = None
    while off < total:
        if off + HEADER_BYTES > total:
            return                               # torn header at the tail
        magic, kind, pad, lsn, plen, crc = _HEADER.unpack_from(data, off)
        end = off + HEADER_BYTES + plen
        if magic != _MAGIC:
            raise WalCorruption(f"bad magic at byte {off}")
        if end > total:
            return                               # torn payload at the tail
        # CRC covers (type, pad, lsn, len) — header bytes 2..16, i.e.
        # everything after the magic and before the crc field — + payload
        body = data[off + 2: off + HEADER_BYTES - 4] + \
            data[off + HEADER_BYTES: end]
        if crc32c(body) != crc:
            if end >= total:
                return                           # torn/corrupt tail record
            raise WalCorruption(
                f"CRC mismatch at byte {off} (lsn {lsn}) with intact data "
                f"after it")
        if expect_lsn is not None and lsn != expect_lsn:
            raise WalCorruption(
                f"LSN discontinuity at byte {off}: got {lsn}, "
                f"expected {expect_lsn}")
        yield WalRecord(lsn, kind, data[off + HEADER_BYTES: end], off,
                        HEADER_BYTES + plen)
        expect_lsn = lsn + 1
        off = end
