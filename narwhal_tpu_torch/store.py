"""Persistent KV store with `notify_read` — the dependency-resolution primitive.

Reference store/src/lib.rs (94 LoC): a rocksdb behind an mpsc actor with three
commands — Write, Read, and NotifyRead, a read that parks the caller until the
key is written.  The obligations map is what the whole sync/recovery machinery
is built on (SURVEY.md §2.1 row 4, §3.5).

Here: an in-process map with an append-only log for crash recovery (replayed
on open), and parked asyncio futures per missing key.  Since the protocol
state machine runs on one event loop, plain-dict reads/writes are already
serialized — the actor boundary of the reference collapses to method calls,
which removes a channel hop from every hot-path store access.

Log persistence is a synchronous ``writev(2)`` straight from the caller:
one gather-list syscall per record, no serialization copy, page-cache
durability (power-loss durability would need fsync, which the reference's
rocksdb default also skips).  A writer thread was measured to be strictly
worse on shared-core hosts: every queue handoff forces a producer↔consumer
thread ping-pong through the GIL and scheduler (~1.4 ms per record), which
starves the event loop.
"""

from __future__ import annotations

import asyncio
import os
import struct
import weakref
from typing import Dict, List, Optional

from . import metrics

_REC = struct.Struct("<II")  # key length, value length

_m_puts = metrics.counter("store.puts")
_m_put_bytes = metrics.counter("store.put_bytes")
_m_gets = metrics.counter("store.gets")

# Parked notify_read obligations across every live store in the process —
# the depth of the dependency-resolution machinery (sync/recovery stalls
# show up here first).
_STORES: "weakref.WeakSet[Store]" = weakref.WeakSet()
metrics.gauge_fn(
    "store.parked_obligations",
    lambda: sum(len(s._obligations) for s in _STORES),
)


class Store:
    # writev(2) gather-list ceiling (IOV_MAX is 1024 on Linux); deferred
    # flushes chunk their buffer lists at this bound.
    _IOV_MAX = 1024

    def __init__(self, path: Optional[str] = None) -> None:
        self._map: Dict[bytes, bytes] = {}
        self._obligations: Dict[bytes, List[asyncio.Future]] = {}
        self._fd: Optional[int] = None
        self._size = 0  # valid log length (single writer: we own the file)
        self._failed = False  # log lost its record boundary; writes refuse
        self._pending: List[bytes] = []  # deferred log buffers (see below)
        _STORES.add(self)
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if os.path.exists(path):
                self._replay(path)
            self._fd = os.open(
                path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644
            )

    def _replay(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        pos, n = 0, len(data)
        while pos + _REC.size <= n:
            klen, vlen = _REC.unpack_from(data, pos)
            end = pos + _REC.size + klen + vlen
            if end > n:
                break  # torn tail record from a crash; discard
            k = data[pos + _REC.size : pos + _REC.size + klen]
            self._map[k] = data[pos + _REC.size + klen : end]
            pos = end
        if pos < n:
            # Truncate the torn tail NOW: appending after the garbage would
            # make every post-recovery record unreachable to the next replay
            # (it stops at the first torn record).
            with open(path, "r+b") as f:
                f.truncate(pos)
        self._size = pos

    def _append(self, bufs: List[bytes]) -> None:
        """Append a gather list of record buffers to the log.
        writev may write short (signal, ENOSPC cleared later): retry
        the remainder, else the torn record would make every later
        append unrecoverable on replay (truncation stops at it)."""
        total = sum(len(b) for b in bufs)
        try:
            # Short writes are retried PER CHUNK, before the next chunk is
            # written: retrying at the end against the flattened whole
            # would re-append the tail while leaving a hole at the short
            # chunk — a silent mid-log tear that replay only discovers by
            # truncating everything after it.
            for off in range(0, len(bufs), self._IOV_MAX):
                chunk = bufs[off : off + self._IOV_MAX]
                chunk_total = sum(len(b) for b in chunk)
                written = os.writev(self._fd, chunk)
                if written < chunk_total:
                    flat = b"".join(chunk)
                    while written < chunk_total:
                        written += os.write(self._fd, flat[written:])
        except OSError:
            # A torn record would strand every later append behind it on
            # replay (truncation stops at the first torn record): roll
            # the file back to the record boundary before propagating.
            try:
                os.ftruncate(self._fd, self._size)
            except OSError:
                # Boundary unrecoverable — poison the store so later
                # writes fail instead of appending unreachable records.
                # The fd must end up cleared even if close() itself
                # fails on the dying device (else Store.close() would
                # double-close a reused fd number).
                self._failed = True
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                finally:
                    self._fd = None
            raise
        self._size += total

    def _deliver(self, key: bytes, value: bytes) -> None:
        """Memory map update + parked notify_read wakeups for one record."""
        _m_puts.inc()
        _m_put_bytes.inc(len(key) + len(value))
        self._map[key] = value
        waiters = self._obligations.pop(key, None)
        if waiters:
            for fut in waiters:
                if not fut.done():
                    fut.set_result(value)

    def write(self, key: bytes, value: bytes) -> None:
        if self._failed:
            # The log lost its record boundary (see below): refusing loudly
            # beats silently keeping memory-only state the next replay will
            # never see.  The reference aborts on storage failure too
            # (core.rs:392-395).
            raise OSError("store log is failed; refusing further writes")
        if self._fd is not None:
            # Drain any deferred buffer FIRST: an immediate append jumping
            # ahead of buffered records would invert the callers' persist
            # order in the log (e.g. a certificate logged before the
            # header it certifies — a crash pre-flush would then replay
            # the cert without its header, which the reference's
            # header-then-cert write order can never produce).
            if self._pending:
                self.flush_deferred()
            # Log FIRST, memory after: a failed append must leave memory and
            # log agreeing (both without the record), not diverged.
            # One writev() per record: no serialization copy, atomic w.r.t.
            # our own replay logic (torn tails are discarded on open).
            self._append([_REC.pack(len(key), len(value)), key, value])
        self._deliver(key, value)

    def write_deferred(self, key: bytes, value: bytes) -> None:
        """Write with the log append DEFERRED to the next flush_deferred().

        Memory (and parked notify_read waiters) see the record immediately
        — every in-process invariant is identical to write() — but the log
        record is only buffered, so a burst of N records costs ONE writev
        at flush time instead of N syscalls on the hot path.  The caller
        owns the durability ordering: anything that must not leave the
        node before the record is logged (a vote for the header, per the
        persist-before-vote rule) must flush first.  Note the inversion vs
        write(): memory is updated BEFORE the log here, so a flush failure
        leaves memory ahead of the log — acceptable because a failed
        append poisons the store and the node aborts (reference
        core.rs:392-395 does the same on storage failure)."""
        if self._failed:
            raise OSError("store log is failed; refusing further writes")
        if self._fd is not None:
            self._pending.extend(
                (_REC.pack(len(key), len(value)), key, value)
            )
        self._deliver(key, value)

    def flush_deferred(self) -> None:
        """Append every record buffered by write_deferred in one writev
        (chunked at IOV_MAX).  No-op when nothing is pending.

        On a failed append the records STAY buffered: _append rolls the
        file back to the record boundary, so a later flush (or close(),
        which flushes) retries the whole batch — dropping them here would
        silently diverge memory (already served to notify_read waiters)
        from the log.  If the rollback itself failed, the store is
        poisoned and this raises like every other write path."""
        if not self._pending:
            return
        if self._failed:
            raise OSError("store log is failed; refusing further writes")
        if self._fd is not None:
            self._append(self._pending)  # raises with records kept pending
        self._pending = []

    def read(self, key: bytes) -> Optional[bytes]:
        _m_gets.inc()
        return self._map.get(key)

    def values(self) -> List[bytes]:
        """Snapshot of every stored value (boot-time recovery scans: the
        post-restore consensus replay parses these for certificates)."""
        return list(self._map.values())

    async def notify_read(self, key: bytes) -> bytes:
        """Return the value for `key`, parking until it is written if absent
        (reference store/src/lib.rs:47-58)."""
        val = self._map.get(key)
        if val is not None:
            return val
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # lint: allow-interleave(every store-sharing task root can append to _obligations while this waiter is suspended on its future — safely: _deliver pops a key's WHOLE waiter list atomically before resolving any future, and the cancelled-waiter cleanup below removes only the future THIS call appended, re-reading the dict after the suspension)
        self._obligations.setdefault(key, []).append(fut)
        try:
            return await fut
        finally:
            # A cancelled waiter must not leak its obligation entry (keys that
            # never arrive would otherwise accumulate futures forever).
            if fut.cancelled():
                waiters = self._obligations.get(key)
                if waiters is not None:
                    try:
                        waiters.remove(fut)
                    except ValueError:
                        pass
                    if not waiters:
                        del self._obligations[key]

    def flush(self) -> None:
        """write() records hit the OS immediately; this only drains any
        write_deferred buffer (see flush_deferred)."""
        self.flush_deferred()

    def close(self) -> None:
        if self._fd is not None:
            try:
                self.flush_deferred()
            finally:
                if self._fd is not None:  # _append may have poisoned us
                    os.close(self._fd)
                    self._fd = None
