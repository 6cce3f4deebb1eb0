"""Worker wiring: three inbound planes, three pipelines.

Reference worker/src/worker.rs (318 LoC): `Worker::spawn` wires
- client transactions → BatchMaker → QuorumWaiter → Processor(own) →
  PrimaryConnector (the throughput hot path, SURVEY.md §3.2),
- other workers' frames → ACK → Processor(others) / Helper,
- primary commands → Synchronizer.
Channel capacity 1000 throughout (worker.rs:26) for backpressure.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from .. import metrics, native
from ..config import Committee, Parameters, WorkerId
from ..crypto import PublicKey
from ..messages import (
    PRIMARY_WORKER_FRAME_TYPES,
    WORKER_BATCH,
    WORKER_FRAME_TYPES,
    decode_primary_worker_message,
    decode_worker_message,
    frame_classifier,
    set_wire_committee,
)
from ..network import Receiver, Writer
from ..network.clocksync import stamp_ack
from ..store import Store
from ..utils.env import env_flag, env_int, positive_int
from ..utils.tasks import spawn
from .batch_maker import BatchMaker
from .helper import Helper, max_request_digests
from .primary_connector import PrimaryConnector
from .processor import Processor
from .quorum_waiter import QuorumWaiter
from .synchronizer import Synchronizer

log = logging.getLogger("narwhal.worker")

CHANNEL_CAPACITY = 1_000

# In-flight sealed batches awaiting their ACK quorum.  Deliberately tiny
# (unlike the uniform 1000-capacity channels of the reference,
# worker.rs:26): when this fills, the BatchMaker pauses the client sockets,
# so TCP flow control adapts the offered load to the committee's real ACK
# bandwidth.  A deep queue here is pure bufferbloat — on congested hosts the
# ACK rate drops as the backlog grows (peers drown in queued batch frames),
# which turns a transient stall into an unrecoverable spiral.
QUORUM_WINDOW = 8


def max_batch_bytes(batch_size: int) -> int:
    """Largest serialized batch frame this worker accepts, derived from
    the committee's configured ``batch_size`` (an honest seal overshoots
    the threshold by at most one transaction plus frame overhead) with
    2x headroom plus 64 KiB of slack.  ``NARWHAL_MAX_BATCH_BYTES``
    overrides — raise it for deployments whose single transactions
    legitimately dwarf the batch threshold.  Anything larger is garbage
    or hostile: without this gate a peer can make us SHA-512 and persist
    megabytes of junk per frame (the fault suite's ``garbage_batches``
    behavior), bounded only by the 32 MiB wire cap."""
    return positive_int("NARWHAL_MAX_BATCH_BYTES", 2 * batch_size + 65_536)


def max_request_bytes() -> int:
    """Largest non-batch worker frame worth DECODING.  An over-cap
    BatchRequest is truncated-and-served by the Helper (the documented
    degradation), but decoding is itself O(frame) — a ~32 MiB hostile
    request would allocate ~1M Digest objects before the cap dropped
    99.99% of them.  Frames that could not possibly dedup down to the
    cap get a length compare instead of a decode: 8x the cap's wire size
    tolerates sloppy-but-honest senders (and the fault suite's own
    1024-digest flood, which must reach the truncation path under the
    default cap) while bounding the decode cost of a frame to ~8x what
    the Helper would ever serve."""
    # tag + count + digests + requestor key, at 8x the digest cap.
    return 1 + 4 + 32 * (8 * max_request_digests()) + 32


class WorkerReceiverHandler:
    """Other workers' traffic: ACK everything, route batches to the
    others-Processor and batch requests to the Helper
    (reference worker.rs:264-292)."""

    def __init__(
        self,
        others_queue: asyncio.Queue,
        helper_queue: asyncio.Queue,
        max_batch_bytes: Optional[int] = None,
    ) -> None:
        self.others_queue = others_queue
        self.helper_queue = helper_queue
        self.max_batch_bytes = max_batch_bytes
        self._max_request_bytes = max_request_bytes()
        self._m_batches_in = metrics.counter("worker.batches_received")
        self._m_batch_bytes_in = metrics.counter("worker.batch_bytes_received")
        self._m_malformed = metrics.counter("worker.malformed_frames")
        self._m_garbage = metrics.counter("worker.garbage_batches")
        self._m_request_rejected = metrics.counter(
            "worker.helper_rejected_requests"
        )

    async def dispatch(self, writer: Writer, message: bytes) -> None:
        # Batches are large and their raw frame is the hashing/storage unit:
        # structurally validate without decoding (native length-prefix walk,
        # no per-tx allocation), then ACK and store the raw bytes.  A
        # malformed batch is dropped un-ACKed, like the reference's
        # deserialization failure path (worker.rs:264-292).
        if message and message[0] == WORKER_BATCH:
            if (
                self.max_batch_bytes is not None
                and len(message) > self.max_batch_bytes
            ):
                # Size gate BEFORE the structural walk and the 32 B hash:
                # an oversized frame must cost us a length compare, not a
                # multi-megabyte SHA-512 + store append (worker.rs has no
                # equivalent; the garbage_batches fault scenario is the
                # regression harness).  Counted for the `garbage_batches`
                # health rule; dropped un-ACKed.
                self._m_garbage.inc()
                log.warning(
                    "Dropping oversized batch frame (%d B > cap %d B)",
                    len(message), self.max_batch_bytes,
                )
                return
            if native.validate_batch(message) < 0:
                self._m_malformed.inc()
                log.warning("Dropping malformed batch frame")
                return
            await writer.send(stamp_ack())
            self._m_batches_in.inc()
            self._m_batch_bytes_in.inc(len(message))
            await self.others_queue.put(message)
            return
        if len(message) > self._max_request_bytes:
            # Same cost discipline as the batch size gate: a request
            # frame too large to ever survive the Helper's dedup+cap is
            # dropped for a length compare, not an O(frame) decode
            # (counted into the helper_abuse rule's input).
            self._m_request_rejected.inc()
            log.warning(
                "Dropping oversized batch-request frame (%d B > cap %d B)",
                len(message), self._max_request_bytes,
            )
            return
        try:
            decoded = decode_worker_message(message)
        except ValueError as e:
            self._m_malformed.inc()
            log.warning("Dropping malformed worker message: %s", e)
            return
        await writer.send(stamp_ack())
        _, digests, requestor = decoded
        await self.helper_queue.put((digests, requestor))


class PrimaryReceiverHandler:
    """Commands from our primary (reference worker.rs:295-318)."""

    def __init__(self, sync_queue: asyncio.Queue) -> None:
        self.sync_queue = sync_queue

    async def dispatch(self, writer: Writer, message: bytes) -> None:
        try:
            cmd = decode_primary_worker_message(message)
        except ValueError as e:
            log.warning("Dropping malformed primary message: %s", e)
            return
        await self.sync_queue.put(cmd)


class Worker:
    def __init__(
        self,
        name: PublicKey,
        worker_id: WorkerId,
        committee: Committee,
        parameters: Parameters,
        store: Store,
        benchmark: bool = False,
    ) -> None:
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.parameters = parameters
        self.store = store
        self.benchmark = benchmark
        self.tasks: List[asyncio.Task] = []
        self.receivers: List[Receiver] = []
        self.senders: List = []  # network senders owned by our components

    @classmethod
    async def spawn(
        cls,
        name: PublicKey,
        worker_id: WorkerId,
        committee: Committee,
        parameters: Parameters,
        store: Store,
        benchmark: bool = False,
        fault_plan=None,
    ) -> "Worker":
        """``fault_plan`` (a ``narwhal_tpu.faults.byzantine.ByzantinePlan``
        with worker behaviors) swaps the BatchMaker/Helper pair for their
        Byzantine wrappers and spawns the sync flooder — the fault
        suite's worker-plane adversary; None (the default) is the honest
        worker."""
        self = cls(name, worker_id, committee, parameters, store, benchmark)
        loop = asyncio.get_running_loop()
        # Wire v2 key-index space (see Primary.spawn).
        set_wire_committee(committee)
        cap = env_int("NARWHAL_CHANNEL_CAPACITY", CHANNEL_CAPACITY)
        q = lambda ch: metrics.InstrumentedQueue(cap, channel=ch)  # noqa: E731

        # Byzantine wiring mirrors primary.py: same channels, same
        # pipelines — the adversary acts only at the network boundary.
        maker_cls, helper_cls = BatchMaker, Helper
        extra: tuple = ()
        flooder = None
        if fault_plan is not None and fault_plan.worker_behaviors():
            from ..faults.byzantine_worker import (
                ByzantineBatchMaker,
                ByzantineHelper,
                SyncFlooder,
            )

            maker_cls, helper_cls = ByzantineBatchMaker, ByzantineHelper
            extra = (fault_plan,)
            if "sync_flood" in fault_plan.behaviors:
                flooder = SyncFlooder(
                    fault_plan, name, worker_id, committee, store
                )

        # to_quorum keeps its QUORUM_WINDOW depth: its fullness IS the
        # admission backpressure (below queue_saturated's MIN_CAP floor
        # on purpose — running full there is mechanism, not anomaly).
        to_quorum = metrics.InstrumentedQueue(
            QUORUM_WINDOW, channel="worker.to_quorum"
        )
        own_batches = q("worker.own_batches")
        others_batches = q("worker.others_batches")
        to_primary = q("worker.to_primary")
        helper_queue = q("worker.helper")
        sync_queue = q("worker.sync")

        # Queue-depth gauges: callbacks polled only at snapshot/scrape
        # time, so the hot path pays nothing.  These are exactly the
        # depths the NARWHAL_TRACE heartbeat used to log — now first-class.
        # One literal call per name (no loop) so the metric-name-drift
        # lint rule can see every registered name statically.
        metrics.gauge_fn("worker.queue.to_quorum", to_quorum.qsize)
        metrics.gauge_fn("worker.queue.own_batches", own_batches.qsize)
        metrics.gauge_fn("worker.queue.others_batches", others_batches.qsize)
        metrics.gauge_fn("worker.queue.to_primary", to_primary.qsize)
        metrics.gauge_fn("worker.queue.helper", helper_queue.qsize)
        metrics.gauge_fn("worker.queue.sync", sync_queue.qsize)

        addrs = committee.worker(name, worker_id)
        primary_addr = committee.primary(name).worker_to_primary

        # Inbound planes.  The client transaction socket is bound by the
        # BatchMaker itself (native per-tx path; see batch_maker.py).
        self.receivers.append(
            await Receiver.spawn(
                addrs.worker_to_worker,
                WorkerReceiverHandler(
                    others_batches,
                    helper_queue,
                    max_batch_bytes=max_batch_bytes(parameters.batch_size),
                ),
                classify=frame_classifier(WORKER_FRAME_TYPES),
            )
        )
        self.receivers.append(
            await Receiver.spawn(
                addrs.primary_to_worker,
                PrimaryReceiverHandler(sync_queue),
                classify=frame_classifier(PRIMARY_WORKER_FRAME_TYPES),
            )
        )

        # Pipelines.
        batch_maker = maker_cls(
            *extra,
            name,
            worker_id,
            committee,
            parameters.batch_size,
            parameters.max_batch_delay,
            addrs.transactions,
            to_quorum,
            benchmark=benchmark,
        )
        quorum_waiter = QuorumWaiter(name, committee, to_quorum, own_batches)
        processor_own = Processor(worker_id, store, own_batches, to_primary, True)
        processor_others = Processor(
            worker_id, store, others_batches, to_primary, False
        )
        connector = PrimaryConnector(primary_addr, to_primary)
        synchronizer = Synchronizer(
            name,
            worker_id,
            committee,
            store,
            parameters.sync_retry_delay,
            parameters.sync_retry_nodes,
            sync_queue,
            gc_depth=parameters.gc_depth,
        )
        helper = helper_cls(*extra, worker_id, committee, store, helper_queue)
        self.senders = [
            batch_maker.sender,
            connector.sender,
            synchronizer.sender,
            helper.sender,
        ]

        runners = [
            batch_maker,
            quorum_waiter,
            processor_own,
            processor_others,
            connector,
            synchronizer,
            helper,
        ]
        if flooder is not None:
            runners.append(flooder)
            self.senders.append(flooder.sender)
        for runner in runners:
            self.tasks.append(
                spawn(runner.run(), name=type(runner).__name__.lower())
            )
        # The tx socket is bound inside BatchMaker.run; wait so clients can
        # connect as soon as spawn returns, and fail fast on a bind error.
        await batch_maker.started.wait()
        if batch_maker.boot_error is not None:
            await self.shutdown()
            raise batch_maker.boot_error

        if env_flag("NARWHAL_TRACE"):
            async def heartbeat():
                while True:
                    t0 = loop.time()
                    await asyncio.sleep(1.0)
                    lag = (loop.time() - t0) - 1.0
                    sender = batch_maker.sender
                    buf = sum(
                        len(c.buffer) + len(c.pending)
                        for c in sender._connections.values()
                    )
                    log.info(
                        "TRACE hb lag=%.0fms q_quorum=%d q_own=%d q_others=%d "
                        "q_prim=%d sender_backlog=%d batcher=%d",
                        lag * 1000, to_quorum.qsize(), own_batches.qsize(),
                        others_batches.qsize(), to_primary.qsize(), buf,
                        batch_maker.batcher.tx_bytes,
                    )

            self.tasks.append(spawn(heartbeat(), name="trace-heartbeat"))

        log.info(
            "Worker %d successfully booted on %s",
            worker_id,
            addrs.transactions.rsplit(":", 1)[0],
        )
        return self

    async def shutdown(self) -> None:
        for task in self.tasks:
            task.cancel()
        for sender in self.senders:
            sender.close()
        for receiver in self.receivers:
            await receiver.shutdown()
        await asyncio.gather(*self.tasks, return_exceptions=True)
