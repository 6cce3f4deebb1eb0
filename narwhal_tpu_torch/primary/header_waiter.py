"""HeaderWaiter: park suspended headers until their dependencies arrive.

Reference primary/src/header_waiter.rs (293 LoC): on SyncBatches, command our
workers to fetch the missing batches (PrimaryWorkerMessage::Synchronize); on
SyncParents, request the missing certificates from the header author's
primary; park the header on notify_read of every missing store key and loop
it back to the Core once they all land.  A 1 s timer escalates overdue parent
requests to `sync_retry_nodes` random primaries; per-round state is GC'd from
the shared consensus round.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Tuple

from .. import metrics
from ..config import Committee
from ..crypto import Digest, PublicKey
from ..messages import Round, encode_synchronize
from ..network import SimpleSender
from ..store import Store
from .core import AtomicRound
from .messages import Header, encode_certificates_request
from .synchronizer import payload_key
from ..utils.clock import loop_now
from ..utils.tasks import spawn

log = logging.getLogger("narwhal.primary")

TIMER_RESOLUTION = 1.0  # seconds


class HeaderWaiter:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        consensus_round: AtomicRound,
        gc_depth: Round,
        sync_retry_delay_ms: int,
        sync_retry_nodes: int,
        rx_synchronizer: asyncio.Queue,  # ("sync_batches"|"sync_parents", ...)
        tx_core: asyncio.Queue,  # resumed headers
    ) -> None:
        self.name = name
        self.committee = committee
        self.store = store
        self.consensus_round = consensus_round
        self.gc_depth = gc_depth
        self.sync_retry_delay = sync_retry_delay_ms / 1000.0
        self.sync_retry_nodes = sync_retry_nodes
        self.rx_synchronizer = rx_synchronizer
        self.tx_core = tx_core
        self.sender = SimpleSender()

        # header id → (round, parked task)
        self.pending: Dict[Digest, Tuple[Round, asyncio.Task]] = {}
        # missing certificate digest → (round, last request time)
        self.parent_requests: Dict[Digest, Tuple[Round, float]] = {}
        # Where headers wait: those parked on missing batches and on
        # missing parents, the parent digests the timer asks for again
        # past sync_retry_delay, and how long each parked header waited
        # until it resumed or was collected.
        self._m_parked_batches = metrics.counter(
            "primary.header_waiter.parked_batches"
        )
        self._m_parked_parents = metrics.counter(
            "primary.header_waiter.parked_parents"
        )
        self._m_retried = metrics.counter(
            "primary.header_waiter.retried_digests"
        )
        self._m_parked_seconds = metrics.histogram(
            "primary.header_waiter.parked_seconds"
        )

    async def run(self) -> None:
        timer = spawn(self._timer(), name="header-waiter-timer")
        try:
            while True:
                message = await self.rx_synchronizer.get()
                kind = message[0]
                if kind == "sync_batches":
                    _, missing, header = message
                    await self._sync_batches(missing, header)
                elif kind == "sync_parents":
                    _, missing, header = message
                    await self._sync_parents(missing, header)
                self._gc()
        finally:
            timer.cancel()
            for _, task in self.pending.values():
                task.cancel()
            self.pending.clear()

    # --- handlers -----------------------------------------------------------

    async def _sync_batches(self, missing: Dict[Digest, int], header: Header) -> None:
        if header.id in self.pending:
            return
        # Ask our own workers (grouped by worker id) to fetch the batches
        # from the header author's workers.
        by_worker: Dict[int, List[Digest]] = {}
        for digest, worker_id in missing.items():
            by_worker.setdefault(worker_id, []).append(digest)
        our_workers = self.committee.authorities[self.name].workers
        for worker_id, digests in by_worker.items():
            addrs = our_workers.get(worker_id)
            if addrs is None:
                log.warning("Header references unknown worker id %d", worker_id)
                continue
            self.sender.send(
                addrs.primary_to_worker,
                encode_synchronize(digests, header.author),
                msg_type="synchronize",
            )
        keys = [payload_key(d, w) for d, w in missing.items()]
        self._m_parked_batches.inc()
        self._park(header, keys)

    async def _sync_parents(self, missing: List[Digest], header: Header) -> None:
        if header.id in self.pending:
            return
        # Optimistically ask the header author; the timer escalates later.
        now = loop_now()
        to_request = []
        for digest in missing:
            if digest not in self.parent_requests:
                self.parent_requests[digest] = (header.round, now)
                to_request.append(digest)
        if to_request:
            address = self.committee.primary(header.author).primary_to_primary
            self.sender.send(
                address,
                encode_certificates_request(to_request, self.name),
                msg_type="cert_request",
            )
        self._m_parked_parents.inc()
        self._park(header, [bytes(d) for d in missing])

    def _park(self, header: Header, keys: List[bytes]) -> None:
        task = spawn(self._wait(header, keys, loop_now()))
        self.pending[header.id] = (header.round, task)

    async def _wait(
        self, header: Header, keys: List[bytes], parked_at: float
    ) -> None:
        try:
            await asyncio.gather(*(self.store.notify_read(k) for k in keys))
        finally:
            # Resumed, or collected by the GC or at shutdown.
            self._m_parked_seconds.observe(loop_now() - parked_at)
        self.pending.pop(header.id, None)
        for digest in header.parents:
            self.parent_requests.pop(digest, None)
        await self.tx_core.put(header)

    # --- timer + GC ---------------------------------------------------------

    async def _timer(self) -> None:
        while True:
            await asyncio.sleep(TIMER_RESOLUTION)
            now = loop_now()
            overdue = []
            for d, (_, t) in list(self.parent_requests.items()):
                if now - t < self.sync_retry_delay:
                    continue
                if self.store.read(bytes(d)) is not None:
                    # Satisfied while overdue (the parked header's
                    # notify_read fired; the batch entry clears only when
                    # the whole header unparks): a landed certificate must
                    # fall out of the retry broadcast HERE, because every
                    # re-request makes sync_retry_nodes peers re-send it,
                    # and on a catching-up node that duplicate flood
                    # outruns signature verification — the runaway the
                    # partition-heal fault scenario exposed (the node
                    # verified duplicates at 100% CPU for 60+ s and never
                    # committed again).
                    del self.parent_requests[d]
                    continue
                overdue.append(d)
            if overdue:
                self._m_retried.inc(len(overdue))
                addresses = [
                    a.primary_to_primary
                    for _, a in self.committee.others_primaries(self.name)
                ]
                message = encode_certificates_request(overdue, self.name)
                self.sender.lucky_broadcast(
                    addresses, message, self.sync_retry_nodes,
                    msg_type="cert_request",
                )
                for d in overdue:
                    r, _ = self.parent_requests[d]
                    self.parent_requests[d] = (r, now)
            self._gc()

    def _gc(self) -> None:
        round = self.consensus_round.value
        if round <= self.gc_depth:
            return
        gc_round = round - self.gc_depth
        for hid in [h for h, (r, _) in self.pending.items() if r <= gc_round]:
            _, task = self.pending.pop(hid)
            task.cancel()
        for d in [d for d, (r, _) in self.parent_requests.items() if r <= gc_round]:
            del self.parent_requests[d]
