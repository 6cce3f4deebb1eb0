"""Primary wiring: receivers, channels, and the eight protocol tasks.

Reference primary/src/primary.rs (275 LoC): builds the channels, spawns
network receivers for primary↔primary (WAN) and worker→primary (LAN)
traffic, and wires Core, GarbageCollector, PayloadReceiver, HeaderWaiter,
CertificateWaiter, Proposer and Helper around the shared store and the
atomic consensus round.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List

from .. import metrics
from ..config import Committee, Parameters
from ..crypto import KeyPair, SchemeMismatch, SignatureService
from ..messages import (
    WORKER_PRIMARY_FRAME_TYPES,
    decode_worker_primary_message,
    frame_classifier,
    set_wire_committee,
)
from ..network import Receiver, Writer
from ..network.clocksync import stamp_ack
from ..store import Store
from ..utils.env import env_int
from ..utils.tasks import spawn
from .certificate_waiter import CertificateWaiter
from .core import AtomicRound, Core
from .garbage_collector import GarbageCollector
from .header_waiter import HeaderWaiter
from .helper import Helper
from .messages import PRIMARY_FRAME_TYPES, decode_primary_message
from .payload_receiver import PayloadReceiver
from .proposer import Proposer
from .synchronizer import Synchronizer

log = logging.getLogger("narwhal.primary")

CHANNEL_CAPACITY = 1_000


class PrimaryReceiverHandler:
    """primary↔primary plane: ACK, then route to Core or Helper
    (reference primary.rs:224-243)."""

    def __init__(self, tx_primaries: asyncio.Queue, tx_helper: asyncio.Queue) -> None:
        self.tx_primaries = tx_primaries
        self.tx_helper = tx_helper

    async def dispatch(self, writer: Writer, message: bytes) -> None:
        try:
            decoded = decode_primary_message(message)
        except SchemeMismatch as e:
            # A certificate from a peer running the OTHER cert-sig
            # scheme: counted into primary.invalid_signatures (its
            # signature material is unreadable here, which is what the
            # invalid_signature health rule should fire on), named
            # loudly — a mixed committee is an operator error, not
            # line noise.
            metrics.counter("primary.invalid_signatures").inc()
            log.warning("Dropping cross-scheme primary message: %s", e)
            return
        except ValueError as e:
            log.warning("Dropping malformed primary message: %s", e)
            return
        await writer.send(stamp_ack())
        if decoded[0] == "certificates_request":
            await self.tx_helper.put((decoded[1], decoded[2]))
        else:
            await self.tx_primaries.put(decoded)


class WorkerReceiverHandler:
    """worker→primary LAN plane: OurBatch → Proposer, OthersBatch →
    PayloadReceiver (reference primary.rs:246-261)."""

    def __init__(self, tx_our_digests: asyncio.Queue, tx_others_digests: asyncio.Queue) -> None:
        self.tx_our_digests = tx_our_digests
        self.tx_others_digests = tx_others_digests

    async def dispatch(self, writer: Writer, message: bytes) -> None:
        try:
            decoded = decode_worker_primary_message(message)
        except ValueError as e:
            log.warning("Dropping malformed worker message: %s", e)
            return
        if decoded.ours:
            await self.tx_our_digests.put((decoded.digest, decoded.worker_id))
        else:
            await self.tx_others_digests.put((decoded.digest, decoded.worker_id))


class Primary:
    def __init__(self) -> None:
        self.tasks: List[asyncio.Task] = []
        self.receivers: List[Receiver] = []
        self.senders: List = []
        self.tx_consensus: asyncio.Queue | None = None
        self.rx_consensus: asyncio.Queue | None = None

    @classmethod
    async def spawn(
        cls,
        keypair: KeyPair,
        committee: Committee,
        parameters: Parameters,
        store: Store,
        tx_consensus: asyncio.Queue,
        rx_consensus: asyncio.Queue,
        benchmark: bool = False,
        fault_plan=None,
    ) -> "Primary":
        """`tx_consensus` carries fresh certificates to the consensus task;
        `rx_consensus` brings committed certificates back for GC.

        ``fault_plan`` (a ``narwhal_tpu.faults.byzantine.ByzantinePlan``)
        swaps the Proposer/Core pair for their Byzantine wrappers — the
        fault-injection suite's adversary wiring; None (the default) is
        the honest node."""
        self = cls()
        name = keypair.name
        loop = asyncio.get_running_loop()
        # Wire v2 key-index space: the committee roster, installed before
        # any codec runs (store replay, receivers, proposer).
        set_wire_committee(committee)
        cap = env_int("NARWHAL_CHANNEL_CAPACITY", CHANNEL_CAPACITY)
        q = lambda ch: metrics.InstrumentedQueue(cap, channel=ch)  # noqa: E731

        tx_primaries = q("primary.primaries")  # network → core
        tx_helper = q("primary.helper")
        rx_our_digests = q("primary.our_digests")  # workers → proposer
        rx_others_digests = q("primary.others_digests")  # workers → payload receiver
        tx_headers_sync = q("primary.headers_sync")  # synchronizer → header waiter
        tx_certs_sync = q("primary.certs_sync")  # synchronizer → certificate waiter
        tx_headers_loopback = q("primary.header_waiter")  # header waiter → core
        tx_certs_loopback = q("primary.cert_waiter")  # certificate waiter → core
        tx_own_headers = q("primary.own_headers")  # proposer → core
        # NOTE: no core → proposer queue anymore — parents are delivered
        # via Proposer.deliver_parents, a synchronous same-loop callback
        # (skips the queue round-trip on the round-cadence critical path).

        # Queue-depth gauges, polled only at snapshot/scrape time.  One
        # literal call per name (no loop) so the metric-name-drift lint
        # rule can see every registered name statically.
        metrics.gauge_fn("primary.queue.primaries", tx_primaries.qsize)
        metrics.gauge_fn("primary.queue.helper", tx_helper.qsize)
        metrics.gauge_fn("primary.queue.our_digests", rx_our_digests.qsize)
        metrics.gauge_fn(
            "primary.queue.others_digests", rx_others_digests.qsize
        )
        metrics.gauge_fn(
            "primary.queue.header_waiter", tx_headers_loopback.qsize
        )
        metrics.gauge_fn("primary.queue.cert_waiter", tx_certs_loopback.qsize)
        metrics.gauge_fn("primary.queue.own_headers", tx_own_headers.qsize)
        metrics.gauge_fn("primary.queue.consensus", tx_consensus.qsize)

        consensus_round = AtomicRound()
        metrics.gauge_fn(
            "primary.consensus_round", lambda: consensus_round.value
        )
        signature_service = SignatureService(keypair)
        synchronizer = Synchronizer(
            name, committee, store, tx_headers_sync, tx_certs_sync
        )

        addrs = committee.primary(name)
        self.receivers.append(
            await Receiver.spawn(
                addrs.primary_to_primary,
                PrimaryReceiverHandler(tx_primaries, tx_helper),
                classify=frame_classifier(PRIMARY_FRAME_TYPES),
            )
        )
        self.receivers.append(
            await Receiver.spawn(
                addrs.worker_to_primary,
                WorkerReceiverHandler(rx_our_digests, rx_others_digests),
                classify=frame_classifier(WORKER_PRIMARY_FRAME_TYPES),
            )
        )

        # The Proposer is built first so the Core can hand it parent
        # quorums directly (deliver_parents) instead of through a queue.
        # A fault plan swaps in the Byzantine wrappers (same wiring, same
        # channels — the adversary acts only at the network boundary).
        proposer_cls, core_cls = Proposer, Core
        extra: tuple = ()
        if fault_plan is not None and fault_plan.primary_behaviors():
            from ..faults.byzantine import ByzantineCore, ByzantineProposer

            proposer_cls, core_cls = ByzantineProposer, ByzantineCore
            extra = (fault_plan,)
        proposer = proposer_cls(
            *extra,
            name,
            committee,
            signature_service,
            parameters.header_size,
            parameters.max_header_delay,
            rx_core=None,  # parents arrive via deliver_parents
            rx_workers=rx_our_digests,
            tx_core=tx_own_headers,
            benchmark=benchmark,
            min_header_delay_ms=parameters.min_header_delay,
            header_linger_ms=parameters.header_linger,
            gc_depth=parameters.gc_depth,
        )
        core = core_cls(
            *extra,
            name,
            committee,
            store,
            synchronizer,
            signature_service,
            consensus_round,
            parameters.gc_depth,
            rx_primaries=tx_primaries,
            rx_header_waiter=tx_headers_loopback,
            rx_certificate_waiter=tx_certs_loopback,
            rx_proposer=tx_own_headers,
            tx_consensus=tx_consensus,
            parents_cb=proposer.deliver_parents,
            # Late-parent forwarding only matters while a linger window
            # can be open; leave it unwired otherwise so the post-quorum
            # certificate path stays zero-cost.
            late_parents_cb=(
                proposer.deliver_late_parent
                if parameters.header_linger > 0
                else None
            ),
        )
        garbage_collector = GarbageCollector(
            name, committee, consensus_round, rx_consensus, proposer
        )
        payload_receiver = PayloadReceiver(store, rx_others_digests)
        header_waiter = HeaderWaiter(
            name,
            committee,
            store,
            consensus_round,
            parameters.gc_depth,
            parameters.sync_retry_delay,
            parameters.sync_retry_nodes,
            rx_synchronizer=tx_headers_sync,
            tx_core=tx_headers_loopback,
        )
        certificate_waiter = CertificateWaiter(
            store,
            consensus_round,
            parameters.gc_depth,
            rx_synchronizer=tx_certs_sync,
            tx_core=tx_certs_loopback,
        )
        helper = Helper(committee, store, tx_helper)

        for runner in (
            core,
            garbage_collector,
            payload_receiver,
            header_waiter,
            certificate_waiter,
            proposer,
            helper,
        ):
            self.tasks.append(
                spawn(runner.run(), name=type(runner).__name__.lower())
            )
        self.senders = [
            core.network,
            garbage_collector.sender,
            header_waiter.sender,
            helper.sender,
        ]

        log.info(
            "Primary %r successfully booted on %s",
            name,
            addrs.primary_to_primary.rsplit(":", 1)[0],
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
