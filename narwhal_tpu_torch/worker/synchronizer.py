"""Worker Synchronizer: fetch batches our primary is waiting for.

Reference worker/src/synchronizer.rs (226 LoC): execute the primary's
`Synchronize` commands — check the store, record pending requests, send a
`BatchRequest` to the target author's same-id worker; a 1 s resolution timer
re-broadcasts overdue requests to `sync_retry_nodes` random peers
(191-222); `Cleanup(round)` garbage-collects pending state (160-176).

Beyond the reference, the retry is a jittered, capped EXPONENTIAL backoff
per digest (one `next_backoff` schedule each, the reconnect schedule of
network/reliable_sender.py) instead of the reference's fixed cadence: a
fixed-period re-broadcast against a slow or withholding author is the
same duplicate-flood shape that outran signature verification in the
partition-heal fault scenario (ROADMAP item 4's second catch), only on
the payload plane — every period each helpful peer re-sends a ~500 kB
batch.  Requests are also chunked under the Helper's per-request digest
cap so an honest retry burst is never mistaken for the `sync_flood`
amplification attack.

Detection plane: ``worker.unserved_sync_age_seconds`` (age of the OLDEST
still-unserved request across the process's synchronizers) is the
``batch_withholding`` health rule's input — a worker whose certified
batches cannot be fetched is exactly the availability attack the paper's
certificate claim rules out.
"""

from __future__ import annotations

import asyncio
import logging
import random
import weakref
from typing import Dict

from .. import metrics
from ..config import Committee, WorkerId
from ..crypto import Digest, PublicKey
from ..messages import Round, encode_batch_request
from ..network import SimpleSender
from ..network.reliable_sender import next_backoff
from .helper import max_request_digests
from ..utils.clock import loop_now
from ..utils.tasks import spawn

log = logging.getLogger("narwhal.worker")

TIMER_RESOLUTION = 1.0  # seconds (reference synchronizer.rs:22)

# Live synchronizers, for the snapshot-time age gauge (one registry per
# process; the WeakSet mirrors store._STORES / reliable_sender._SENDERS).
_SYNCHRONIZERS: "weakref.WeakSet[Synchronizer]" = weakref.WeakSet()


def _oldest_unserved_age() -> float:
    oldest = None
    for sync in _SYNCHRONIZERS:
        for p in sync.pending.values():
            if oldest is None or p.first_ts < oldest:
                oldest = p.first_ts
    if oldest is None:
        return 0.0
    return max(0.0, loop_now() - oldest)


metrics.gauge_fn("worker.unserved_sync_age_seconds", _oldest_unserved_age)


class _PendingSync:
    """One digest's fetch obligation: when it was first requested (the
    age gauge's anchor), and its private backoff schedule."""

    __slots__ = ("round", "first_ts", "delay", "due")

    def __init__(self, round_: Round, now: float, delay: float) -> None:
        self.round = round_
        self.first_ts = now
        self.delay = delay        # next_backoff input (doubles toward cap)
        self.due = now + delay    # the first retry window is un-jittered


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        worker_id: WorkerId,
        committee: Committee,
        store,
        sync_retry_delay_ms: int,
        sync_retry_nodes: int,
        in_queue: asyncio.Queue,  # decoded PrimaryWorkerMessage tuples
        gc_depth: Round = 50,
        rng: random.Random = random,  # type: ignore[assignment]
    ) -> None:
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.store = store
        self.sync_retry_delay = sync_retry_delay_ms / 1000.0
        self.sync_retry_nodes = sync_retry_nodes
        self.in_queue = in_queue
        self.gc_depth = gc_depth
        self.sender = SimpleSender()
        self.round: Round = 0
        self.pending: Dict[Digest, _PendingSync] = {}
        self._waiters: Dict[Digest, asyncio.Task] = {}
        self._rng = rng  # injectable: tests pin the jitter deterministically
        self._m_requested = metrics.counter("worker.sync_requested_digests")
        self._m_retries = metrics.counter("worker.sync_retried_digests")
        _SYNCHRONIZERS.add(self)

    async def run(self) -> None:
        timer = spawn(self._timer(), name="worker-sync-timer")
        try:
            while True:
                cmd = await self.in_queue.get()
                if cmd[0] == "synchronize":
                    _, digests, target = cmd
                    await self._synchronize(digests, target)
                elif cmd[0] == "cleanup":
                    self._cleanup(cmd[1])
        finally:
            timer.cancel()
            for task in self._waiters.values():
                task.cancel()
            self._waiters.clear()

    def _send_chunked(self, addresses, digests, escalate: bool) -> None:
        """Emit BatchRequests in chunks under the Helper's per-request
        cap — a storm of overdue digests must not turn our own retry into
        an over-limit request the peers count as abuse."""
        cap = max_request_digests()
        for i in range(0, len(digests), cap):
            message = encode_batch_request(digests[i : i + cap], self.name)
            if escalate:
                self.sender.lucky_broadcast(
                    addresses, message, self.sync_retry_nodes,
                    msg_type="batch_request",
                )
            else:
                for address in addresses:
                    self.sender.send(
                        address, message, msg_type="batch_request"
                    )

    async def _synchronize(self, digests, target: PublicKey) -> None:
        missing = []
        now = loop_now()
        for digest in digests:
            if digest in self.pending:
                continue
            if self.store.read(bytes(digest)) is not None:
                continue
            missing.append(digest)
            self.pending[digest] = _PendingSync(
                self.round, now, self.sync_retry_delay
            )
            # Clear pending as soon as the batch lands in the store
            # (the Processor writes it when the Helper's reply arrives).
            self._waiters[digest] = spawn(self._await_arrival(digest))
        if not missing:
            return
        self._m_requested.inc(len(missing))
        try:
            address = self.committee.worker(target, self.worker_id).worker_to_worker
        except Exception:
            log.warning("Sync request for unknown target authority")
            return
        self._send_chunked([address], missing, escalate=False)

    async def _await_arrival(self, digest: Digest) -> None:
        await self.store.notify_read(bytes(digest))
        self.pending.pop(digest, None)
        self._waiters.pop(digest, None)

    def _cleanup(self, round: Round) -> None:
        """Drop requests older than the GC window — they can no longer matter
        to header validation (reference synchronizer.rs:160-176 retains
        entries for gc_depth rounds, not merely the current round)."""
        self.round = round
        horizon = round - self.gc_depth
        for digest in [
            d for d, p in self.pending.items() if p.round < horizon
        ]:
            del self.pending[digest]
            waiter = self._waiters.pop(digest, None)
            if waiter is not None:
                waiter.cancel()

    async def _timer(self) -> None:
        while True:
            await asyncio.sleep(TIMER_RESOLUTION)
            self._retry_sweep()

    def _retry_sweep(self, now: float = None) -> int:  # type: ignore[assignment]
        """Escalate overdue requests to `sync_retry_nodes` random peers
        (reference synchronizer.rs:191-222), one jittered backoff window
        per digest; returns how many digests were re-requested (``now``
        is injectable so tests drive the windows deterministically)."""
        now = loop_now() if now is None else now
        overdue = []
        for digest, p in self.pending.items():
            if now < p.due:
                continue
            if self.store.read(bytes(digest)) is not None:
                # Landed, but the notify_read waiter task has not run
                # yet this tick: re-requesting would make helpful
                # peers re-send ~500 kB we already hold.  The waiter
                # will clear the entry on its next wakeup.
                continue
            overdue.append(digest)
            # Jittered exponential escalation: the sleep is this
            # window, the delay doubles toward the (env-tunable)
            # reconnect cap — same schedule, same rationale as the
            # sender's reconnect backoff.
            sleep_s, p.delay = next_backoff(p.delay, rng=self._rng)
            p.due = now + sleep_s
        if not overdue:
            return 0
        self._m_retries.inc(len(overdue))
        addresses = [
            addrs.worker_to_worker
            for _, addrs in self.committee.others_workers(self.name, self.worker_id)
        ]
        self._send_chunked(addresses, overdue, escalate=True)
        return len(overdue)
