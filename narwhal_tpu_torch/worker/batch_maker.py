"""BatchMaker: the worker's transaction ingestion plane.

Reference worker/src/batch_maker.rs (157 LoC): gather raw transactions until
`batch_size` bytes or `max_batch_delay` ms (71-98), then seal — serialize,
reliable-broadcast the batch to the same-id workers of every other authority,
and hand the serialized batch plus its ACK futures to the QuorumWaiter
(102-156).  Under benchmark mode, log the sample-tx ids and the batch size so
the log parser can compute TPS and latency (103-141).

TPU-host design difference from the reference: the per-transaction loop
(frame split, byte counting, sample scan, batch serialization) runs in the
native data plane (native/dataplane.c) on raw socket buffers — this class
binds the client transaction socket itself (replacing the generic Receiver +
per-tx queue of the reference architecture) and observes only *sealed
batches*, tens per second.  Python cost is therefore per-batch, not per-tx —
essential on small host cores where the whole committee shares the CPU.

Backpressure: when the downstream queue fills, reading is paused on every
client transport (TCP flow control pushes back to the client), mirroring the
bounded-channel backpressure of the reference (worker.rs:26).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import List, Optional, Tuple

from .. import metrics, native
from ..config import Committee, WorkerId
from ..crypto import PublicKey, digest32
from ..network import ReliableSender
from ..network import transport as _transport
from ..network.framing import parse_address
from ..utils.tasks import spawn

log = logging.getLogger("narwhal.worker")

# How often the ingress-overflow warning may fire: the event itself is
# per-batch and a flooded committee would emit thousands of identical
# lines (and the bench parser reads every one).
_OVERFLOW_WARN_INTERVAL = 5.0


class _TxProtocol(asyncio.Protocol):
    """One inbound client connection: feeds raw chunks to the shared
    batcher through a per-connection framer (partial frames are
    per-stream state)."""

    __slots__ = ("maker", "framer", "transport")

    def __init__(self, maker: "BatchMaker") -> None:
        self.maker = maker
        self.framer = native.make_framer(maker.batcher)
        self.transport = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        self.maker._protocols.add(self)
        if self.maker._paused:
            transport.pause_reading()

    def data_received(self, data: bytes) -> None:
        try:
            self.maker._on_tx_data(self.framer, data)
        except ValueError as e:
            self.maker._m_malformed.inc()
            log.warning("Dropping tx connection (malformed stream): %s", e)
            self.transport.close()

    def connection_lost(self, exc) -> None:
        self.maker._protocols.discard(self)


class BatchMaker:
    def __init__(
        self,
        name: PublicKey,
        worker_id: WorkerId,
        committee: Committee,
        batch_size: int,
        max_batch_delay_ms: int,
        address: str,  # client transaction socket to bind
        out_queue: asyncio.Queue,  # → QuorumWaiter: (serialized, [(stake, fut)])
        benchmark: bool = False,
    ) -> None:
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.batch_size = batch_size
        self.max_batch_delay = max_batch_delay_ms / 1000.0
        self.address = address
        self.out_queue = out_queue
        self.benchmark = benchmark
        self.sender = ReliableSender()
        self.batcher = native.make_batcher(batch_size)
        # Same-id workers at every other authority, resolved once.
        self._peers: List[Tuple[int, str]] = [
            (committee.stake(peer_name), addrs.worker_to_worker)
            for peer_name, addrs in committee.others_workers(name, worker_id)
        ]
        self._protocols: set = set()
        self._paused = False
        self._overflow: List = []
        self._drain_task: Optional[asyncio.Task] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._deadline: Optional[float] = None
        self._dirty = asyncio.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.started = asyncio.Event()  # set once the tx socket is bound
        self.boot_error: Optional[BaseException] = None  # bind failure
        self._m_sealed = metrics.counter("worker.batches_sealed")
        self._m_tx_bytes = metrics.counter("worker.batch_bytes_sealed")
        self._m_txs = metrics.counter("worker.txs_sealed")
        self._m_overflow = metrics.counter("worker.ingress_overflow")
        self._m_malformed = metrics.counter("worker.malformed_tx_streams")
        self._trace = metrics.trace()
        self._last_overflow_warn = 0.0
        # Plain int alongside the counter: the warning text must report a
        # true event count even under NARWHAL_METRICS=0 (null counter).
        self._overflow_events = 0

    @property
    def port(self) -> int:
        """Actual bound port (useful when spawned with port 0)."""
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def run(self) -> None:
        self._loop = asyncio.get_running_loop()
        host, port = parse_address(self.address)
        try:
            # Transport seam (see network/transport.py): an installed
            # in-memory transport owns the client-transaction ingress
            # too — the simulation harness's clients feed _TxProtocol
            # through seeded in-process connections, no kernel socket.
            sim = _transport.active()
            if sim is not None:
                self._server = sim.create_tx_server(
                    self.address, lambda: _TxProtocol(self)
                )
            else:
                self._server = await self._loop.create_server(
                    lambda: _TxProtocol(self), host, port
                )
        except BaseException as e:
            # Surface bind failures to Worker.spawn (which waits on
            # `started`) instead of dying silently in this task.
            self.boot_error = e
            self.started.set()
            raise
        self.started.set()
        try:
            # The seal deadline is fixed when the first tx of a batch
            # arrives — NOT restarted per tx — so a steady trickle still
            # seals every max_batch_delay (reference batch_maker.rs:71-98
            # uses an interval timer for the same reason).
            while True:
                # lint: allow-interleave(_dirty/_deadline are rewritten by the client-socket data_received callbacks (size-seal path) while this loop sleeps — safely: every suspension is followed by a `continue` that re-reads both before acting, and the deadline-expired _seal below runs synchronously from a post-suspension read, so a size-seal can only ever cause one spurious re-check, never a stale seal)
                await self._dirty.wait()
                # lint: allow-interleave(same re-read discipline as the wait above: the sleep is followed by a `continue`, never by acting on the pre-sleep deadline)
                deadline = self._deadline
                if deadline is None:  # sealed by size meanwhile
                    self._dirty.clear()
                    continue
                remaining = deadline - self._loop.time()
                if remaining > 0:
                    await asyncio.sleep(remaining)
                    continue  # re-check: a size-seal may have intervened
                self._seal()
        finally:
            if self._drain_task is not None:
                self._drain_task.cancel()
            self._server.close()
            for p in list(self._protocols):
                if p.transport is not None:
                    p.transport.close()

    # -- hot path (called from data_received; must not await) ---------------

    def _on_tx_data(self, framer, data: bytes) -> None:
        batcher = self.batcher
        more = framer.feed(batcher, data)
        while more:
            self._seal()
            more = framer.feed(batcher, b"")  # drain retained remainder
        if batcher.tx_count > 0 and self._deadline is None:
            # First tx of a new batch (fresh stream or post-seal remainder):
            # fix the seal deadline now, not per tx.
            self._deadline = self._loop.time() + self.max_batch_delay
            self._dirty.set()

    def _seal(self) -> None:
        self._deadline = None
        self._dirty.clear()
        sealed = self.batcher.seal()
        if sealed is None:
            return

        # The digest is computed exactly once per own batch, here, and flows
        # with the message through QuorumWaiter → Processor (the reference
        # re-hashes in the processor, processor.rs:35 — at ~500 kB per batch
        # the duplicate hash is worth eliminating on shared-core hosts).
        digest = digest32(sealed.message)
        self._m_sealed.inc()
        self._m_tx_bytes.inc(sealed.tx_bytes)
        self._m_txs.inc(sealed.tx_count)
        # ``samples``: the sample ids the batch holds (the ids the benchmark
        # lines below print), so the stage trace joins a sample to its batch.
        self._trace.mark(
            bytes(digest).hex(), "seal", bytes=sealed.tx_bytes,
            txs=sealed.tx_count, samples=sealed.samples,
        )
        if self.benchmark:
            # Sample transactions carry byte0 == 0 and a u64 counter; the
            # log parser joins these lines with the client's send log to
            # measure end-to-end latency (reference batch_maker.rs:103-141).
            for sample_id in sealed.samples:
                log.info("Batch %r contains sample tx %d", digest, sample_id)
            log.info("Batch %r contains %d B", digest, sealed.tx_bytes)

        handlers = self._broadcast_batch(digest, sealed.message)
        item = (digest, sealed.message, handlers)
        try:
            self.out_queue.put_nowait(item)
        except asyncio.QueueFull:
            # Downstream is lagging: park the batch, stop reading clients
            # (TCP flow control), drain asynchronously.  Counted + a
            # rate-limited warning: a flooded committee must be VISIBLE
            # (round 5 published 3 s latencies because this path was
            # silent, VERDICT.md §1), but one line per parked batch would
            # melt the log under exactly the load that triggers it.
            self._m_overflow.inc()
            self._overflow_events += 1
            now = time.monotonic()
            if now - self._last_overflow_warn >= _OVERFLOW_WARN_INTERVAL:
                self._last_overflow_warn = now
                log.warning(
                    "Client ingress overflowing: quorum pipeline full "
                    "(%d events so far); pausing client sockets",
                    self._overflow_events,
                )
            self._overflow.append(item)
            if not self._paused:
                self._paused = True
                for p in self._protocols:
                    if p.transport is not None:
                        p.transport.pause_reading()
                self._drain_task = spawn(
                    self._drain_overflow(), name="batch-maker-drain"
                )

    def _broadcast_batch(self, digest, message: bytes):
        """Reliable-broadcast the sealed batch to our counterpart workers
        at every other authority; returns the ``[(stake, ack_future)]``
        list the QuorumWaiter counts.  This is the quorum-ACK half of the
        worker's availability split (the Helper serves the fetch half) —
        the fault suite's ByzantineBatchMaker overrides exactly this seam
        to under-share while still certifying."""
        return [
            (stake, self.sender.send(addr, message, msg_type="batch"))
            for stake, addr in self._peers
        ]

    async def _drain_overflow(self) -> None:
        while self._overflow:
            item = self._overflow.pop(0)
            await self.out_queue.put(item)
        self._paused = False
        for p in self._protocols:
            if p.transport is not None:
                p.transport.resume_reading()
