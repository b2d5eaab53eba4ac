"""Seeded, deterministic storage fault injection.

A `FaultPlan` says what can go wrong on the physical read path (transient
page-read failures, latency spikes, buffer-pool pressure windows) and on
the write path (torn WAL appends, failed fsyncs); a `FaultInjector` turns
it into a reproducible schedule.  Read faults fire only on buffer-pool
misses.

Every draw is a pure hash of (plan.seed, access counter, salt), splitmix64
on Python integers, so the same seed driven by the same page-access stream
gives the same schedule, draw for draw, as the reference package.  Faults
are accounting only: results are computed from the dense tensors and stay
bit-identical; a failed read flags its query in StorageStats.  An all-zero
plan draws nothing.
"""
from __future__ import annotations

import dataclasses

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


def _uniform(seed: int, counter: int, salt: int) -> float:
    """Deterministic U[0, 1) from (seed, counter, salt); (counter, salt)
    pack disjoint bit ranges (salt < 2**16, counter < 2**48)."""
    h = _splitmix64((seed & _M64) ^ _splitmix64(((counter << 16) ^ salt)
                                               & _M64))
    return h / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What the injector may do, with what probability.  All-zero
    probabilities (the default) disable injection."""

    seed: int = 0
    # transient failure per physical read attempt, retried up to
    # max_retries times; a read whose every attempt fails flags the query
    read_fail_prob: float = 0.0
    max_retries: int = 3
    # latency spike per successful physical read
    latency_spike_prob: float = 0.0
    # per logical access, chance a window opens in which the pool's
    # capacity shrinks to pressure_frac for pressure_len accesses
    pressure_prob: float = 0.0
    pressure_len: int = 256
    pressure_frac: float = 0.5
    # write path: torn WAL append per append, failed fsync per sync
    wal_torn_prob: float = 0.0
    fsync_fail_prob: float = 0.0

    @property
    def active(self) -> bool:
        return (self.read_fail_prob > 0 or self.latency_spike_prob > 0
                or self.pressure_prob > 0 or self.write_active)

    @property
    def write_active(self) -> bool:
        return self.wal_torn_prob > 0 or self.fsync_fail_prob > 0


# draw salts, one namespace per decision kind
_SALT_FAIL = 1
_SALT_SPIKE = 2
_SALT_PRESSURE = 3
_SALT_WAL_TORN = 4
_SALT_WAL_FRAC = 5
_SALT_FSYNC = 6


class FaultInjector:
    """Executes one FaultPlan over one pool's access stream.  Its state is
    the logical-access counter, the end of the current pressure window and
    the write-path counters, so `reset()` replays the same schedule.
    Read-path and write-path draws use disjoint counters."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counter = 0
        self._pressure_until = 0
        self.wal_appends = 0
        self.wal_syncs = 0

    def reset(self) -> None:
        self.counter = 0
        self._pressure_until = 0
        self.wal_appends = 0
        self.wal_syncs = 0

    def tick(self) -> None:
        """Advance the logical-access counter (once per access, hit or
        miss); maybe open a pressure window."""
        self.counter += 1
        p = self.plan
        if p.pressure_prob > 0 and self.counter >= self._pressure_until:
            if _uniform(p.seed, self.counter, _SALT_PRESSURE) \
                    < p.pressure_prob:
                self._pressure_until = self.counter + p.pressure_len

    def capacity_frac(self) -> float:
        """Effective-capacity fraction right now (1.0 outside windows)."""
        if self.counter < self._pressure_until:
            return self.plan.pressure_frac
        return 1.0

    def on_miss(self) -> tuple[int, bool, bool]:
        """(retries, failed, spike) of one physical read: `failed` when
        all 1 + max_retries attempts failed."""
        p = self.plan
        retries = 0
        failed = False
        if p.read_fail_prob > 0:
            for attempt in range(1 + p.max_retries):
                if _uniform(p.seed, self.counter,
                            _SALT_FAIL + (attempt << 8)) >= p.read_fail_prob:
                    break
                if attempt == p.max_retries:
                    failed = True
                else:
                    retries += 1
        spike = False
        if not failed and p.latency_spike_prob > 0:
            spike = _uniform(p.seed, self.counter, _SALT_SPIKE) \
                < p.latency_spike_prob
        return retries, failed, spike

    def on_wal_append(self, record_bytes: int):
        """None for a clean append, else the bytes that reach the file
        before the simulated crash (at least 1, fewer than the record)."""
        self.wal_appends += 1
        p = self.plan
        if p.wal_torn_prob <= 0:
            return None
        if _uniform(p.seed, self.wal_appends, _SALT_WAL_TORN) \
                >= p.wal_torn_prob:
            return None
        frac = _uniform(p.seed, self.wal_appends, _SALT_WAL_FRAC)
        return max(1, min(record_bytes - 1, int(frac * record_bytes)))

    def on_fsync(self) -> bool:
        """True when this fsync fails."""
        self.wal_syncs += 1
        p = self.plan
        if p.fsync_fail_prob <= 0:
            return False
        return _uniform(p.seed, self.wal_syncs, _SALT_FSYNC) \
            < p.fsync_fail_prob
