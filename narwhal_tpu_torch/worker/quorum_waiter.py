"""QuorumWaiter: hold each sealed batch until 2f+1 stake has ACKed it.

Reference worker/src/quorum_waiter.rs (87 LoC): wait on the ACK futures until
the acknowledging stake (including our own) reaches the quorum threshold,
then release the batch downstream; remaining in-flight deliveries are
abandoned (their retransmission pressure ends with the cancel).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .. import metrics
from ..config import Committee
from ..crypto import PublicKey
from ..utils.clock import loop_now
from ..utils.env import env_flag

log = logging.getLogger("narwhal.worker")
_TRACE = env_flag("NARWHAL_TRACE")


class QuorumWaiter:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        in_queue: asyncio.Queue,  # ← BatchMaker: (serialized, [(stake, fut)])
        out_queue: asyncio.Queue,  # → Processor: serialized batch
    ) -> None:
        self.name = name
        self.committee = committee
        self.in_queue = in_queue
        self.out_queue = out_queue
        self._m_latency = metrics.histogram("worker.quorum_latency_seconds")
        self._m_reached = metrics.counter("worker.quorum_reached")
        self._m_dropped = metrics.counter("worker.quorum_dropped")
        self._mtrace = metrics.trace()
        # Live wedge detection (health rule `quorum_wedge`): how long the
        # CURRENT batch has been waiting for quorum (0 when idle) and how
        # much stake has ACKed it so far.  A waiter stuck at 2f stake —
        # one ACK short, forever — previously surfaced only via
        # pending-ACK growth on the sender; these gauges name it.
        self._wait_started: Optional[float] = None
        self._m_acked_stake = metrics.gauge("worker.quorum_acked_stake")
        self._m_threshold = metrics.gauge("worker.quorum_threshold")
        metrics.gauge_fn(
            "worker.quorum_wait_age_seconds",
            lambda: (
                0.0
                if self._wait_started is None
                else max(0.0, loop_now() - self._wait_started)
            ),
        )

    async def run(self) -> None:
        threshold = self.committee.quorum_threshold()
        self._m_threshold.set(threshold)
        loop = asyncio.get_running_loop()
        while True:
            digest, serialized, handlers = await self.in_queue.get()
            # ACK-latency clock starts here, when the wait begins: the
            # broadcast itself was enqueued at seal time, so this measures
            # wire + peer validation + ACK return (minus queue time in
            # to_quorum, which the queue-depth gauge exposes separately).
            t0 = loop.time()
            self._wait_started = loop_now()
            total = self.committee.stake(self.name)  # our own stake counts
            self._m_acked_stake.set(total)
            pending = {fut: stake for stake, fut in handlers}
            while total < threshold and pending:
                done, _ = await asyncio.wait(
                    set(pending), return_when=asyncio.FIRST_COMPLETED
                )
                for fut in done:
                    stake = pending.pop(fut)
                    if not fut.cancelled() and fut.exception() is None:
                        total += stake
                self._m_acked_stake.set(total)
            # Quorum reached (or unreachable): abandon in-flight deliveries.
            for fut in pending:
                fut.cancel()
            self._wait_started = None
            self._m_acked_stake.set(0)
            if total >= threshold:
                self._m_latency.observe(loop.time() - t0)
                self._m_reached.inc()
                self._mtrace.mark(bytes(digest).hex(), "quorum")
                if _TRACE:
                    log.info("TRACE quorum reached (%d B)", len(serialized))
                await self.out_queue.put((digest, serialized))
            else:
                self._m_dropped.inc()
                log.warning("Batch dropped: quorum unreachable (got %d)", total)
