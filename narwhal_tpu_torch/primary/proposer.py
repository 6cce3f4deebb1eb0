"""Proposer: owns the round counter and mints signed headers.

Reference primary/src/proposer.rs (155 LoC): starts at round 1 with genesis
parents; creates a header whenever it has parents AND (payload ≥ header_size
OR max_header_delay elapsed); round advances when the Core delivers a quorum
of certificates for the current round.

Two cadence extensions beyond the reference (ISSUE r10):

- **min_header_delay** (Sui-style): when > 0, a parent quorum plus ANY
  payload proposes as soon as min_header_delay has elapsed since the last
  header, instead of riding max_header_delay waiting for header_size bytes
  of digests.  Empty rounds still wait for the max delay, so an idle
  committee does not spin headers at wire speed.  0 disables the knob and
  keeps reference behavior exactly.
- **direct parent delivery**: the Core calls :meth:`deliver_parents`
  synchronously when the certificate quorum forms, instead of a queue
  put → event-loop wakeup → queue get round-trip.  The round advances (and
  ``primary.round_advance_seconds`` observes) at quorum time; a wake event
  nudges the run loop to mint the next header.  The queue path (rx_core)
  is kept for harnesses that wire the Proposer standalone.

And a third one (ISSUE r19, the multileader commit rule's proposer-side
half):

- **header_linger** — when > 0, a round advance arms a linger deadline
  and the fast mint paths (payload-ready, full header) hold until it
  passes; certificates of the just-advanced round that land AFTER the
  2f+1 quorum are merged into the pending parent set via
  :meth:`deliver_late_parent` (the Core forwards them while the round is
  current).  Without it every header cites exactly the FIRST 2f+1
  certificates of its round, so each commit-rule leader slot is cited
  with probability ≈ 2/3 and slot support hovers at the quorum
  borderline.  max_header_delay still caps the round; 0 disables the
  window and keeps prior behavior bit-for-bit.

And one that is always on:

- **re-proposal of dead payloads** — the proposer remembers the payload
  of each header it mints, by round, for ``gc_depth`` rounds.  Tusk
  skips a certificate of an authority at or below that authority's last
  committed round, so once consensus commits one of this primary's
  certificates at round r', none of its certificates below r' can ever
  commit: a header of ours below r' whose certificate has not come back
  committed (orphaned, or never certified) has lost its batches.
  :meth:`own_committed` puts their digests back into the next header,
  once, so each batch commits exactly once; headers stay as they were
  wherever no header of ours dies.  The memory is the process's own: a
  restarted primary does not re-propose what it lost before the restart.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Tuple

from ..utils.env import env_flag

_TRACE = env_flag("NARWHAL_TRACE")

from .. import metrics
from ..config import Committee, WorkerId
from ..crypto import Digest, PublicKey, SignatureService
from ..messages import Round
from .messages import Header, genesis

log = logging.getLogger("narwhal.primary")


class Proposer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        signature_service: SignatureService,
        header_size: int,
        max_header_delay_ms: int,
        rx_core: Optional[asyncio.Queue],  # (parent digests, round); None
        # when parents arrive solely via deliver_parents (Primary wiring)
        rx_workers: asyncio.Queue,  # (digest, worker_id)
        tx_core: asyncio.Queue,  # Header
        benchmark: bool = False,
        min_header_delay_ms: int = 0,
        header_linger_ms: int = 0,
        gc_depth: int = 50,
    ) -> None:
        self.name = name
        self.signature_service = signature_service
        self.header_size = header_size
        self.max_header_delay = max_header_delay_ms / 1000.0
        # min is a FLOOR under the max deadline; a min above the max would
        # make payload rounds cycle slower than empty ones (which still
        # mint at the max) — clamp loudly instead.
        if min_header_delay_ms / 1000.0 > self.max_header_delay:
            log.warning(
                "min_header_delay (%d ms) exceeds max_header_delay "
                "(%d ms); clamping to the max",
                min_header_delay_ms, max_header_delay_ms,
            )
        self.min_header_delay = min(
            min_header_delay_ms / 1000.0, self.max_header_delay
        )
        # Linger is likewise bounded by the max deadline: a window the max
        # timer always truncates would silently never run full length.
        if header_linger_ms / 1000.0 > self.max_header_delay:
            log.warning(
                "header_linger (%d ms) exceeds max_header_delay "
                "(%d ms); clamping to the max",
                header_linger_ms, max_header_delay_ms,
            )
        self.header_linger = min(
            header_linger_ms / 1000.0, self.max_header_delay
        )
        self.rx_core = rx_core
        self.rx_workers = rx_workers
        self.tx_core = tx_core
        self.benchmark = benchmark

        self.round: Round = 1
        self.last_parents: List[Digest] = [c.digest() for c in genesis(committee)]
        self.digests: List[Tuple[Digest, WorkerId]] = []
        self.payload_size = 0
        # Set by deliver_parents (the Core's direct, queue-skipping path)
        # to nudge the run loop out of its queue wait.
        self._wake = asyncio.Event()
        # Armed by _advance when header_linger > 0; the fast mint paths
        # hold until it passes so late parents can still be cited.
        self._linger_deadline = 0.0
        # The payloads of our own headers by round, until consensus
        # commits their certificate, a later one of ours, or gc_depth
        # rounds pass (own_committed).
        self.gc_depth = gc_depth
        self._proposed: Dict[Round, Dict[Digest, WorkerId]] = {}
        self._m_reproposed = metrics.counter(
            "primary.proposer.reproposed_batches"
        )
        self._m_headers = metrics.counter("primary.headers_proposed")
        self._m_late_parents = metrics.counter("primary.late_parents_cited")
        self._m_payload_digests = metrics.counter("primary.payload_digests")
        self._m_round = metrics.gauge("primary.round")
        # Round period: seconds between consecutive round advances.  The
        # cert→commit attribution (PR 4) shows commit latency is
        # dominated by protocol cadence — this histogram is the cadence
        # denominator (cert_inserted→commit_trigger ≈ commit depth ×
        # this), so a slow commit path reads directly as either a slow
        # round period (look here) or a starved commit rule (look at
        # consensus.commit_lag_rounds).  The per-round sub-stage trace
        # (metrics.ROUND_STAGES) decomposes it.
        self._m_round_advance = metrics.histogram(
            "primary.round_advance_seconds"
        )
        self._last_advance: Optional[float] = None
        self._mtrace = metrics.trace()
        self._rtrace = metrics.round_trace()

    def deliver_parents(self, parents: List[Digest], round: Round) -> None:
        """Direct (same-event-loop, synchronous) parent delivery from the
        Core: the round advances HERE, at certificate-quorum time, and the
        run loop is woken to mint the next header — no queue round-trip on
        the cadence critical path."""
        self._advance(parents, round)
        self._wake.set()

    def deliver_late_parent(self, digest: Digest, round: Round) -> None:
        """Merge a post-quorum certificate of the CURRENT round's parent
        round into the pending parent set (Core forwards these only while
        a linger window can still be open).  A stale round, an
        already-consumed parent set, or a duplicate digest are all
        silently dropped — the certificate is already in the DAG either
        way, this only widens the citation."""
        if round + 1 != self.round or not self.last_parents:
            return
        if digest in self.last_parents:
            return
        self.last_parents.append(digest)
        self._m_late_parents.inc()
        if _TRACE:
            log.info("TRACE late parent cited %r for round %d", digest, self.round)

    def own_committed(self, round: Round) -> None:
        """Consensus committed our certificate of ``round``.  Tusk commits
        an authority's certificates in round order and skips any at or
        below its last committed round, so the payload of each header of
        ours below ``round`` that has not come back committed can never
        commit: its digests go into the next header.  Everything at or
        below ``round`` is forgotten, so a payload goes back once."""
        for r in sorted(r for r in self._proposed if r <= round):
            payload = self._proposed.pop(r)
            if r == round:
                continue
            self.digests.extend(payload.items())
            self._m_reproposed.inc(len(payload))
            metrics.flight_event("repropose", round=r, batches=len(payload))

    def _advance(self, parents: List[Digest], round: Round) -> bool:
        """Apply a parent quorum for ``round``; returns True if the round
        advanced.  Observes ``round_advance_seconds`` exactly once per
        advance (stale re-deliveries for old rounds are dropped)."""
        if round < self.round:
            return False
        self.round = round + 1
        self._m_round.set(self.round)
        now = asyncio.get_running_loop().time()
        if self._last_advance is not None:
            self._m_round_advance.observe(now - self._last_advance)
        self._last_advance = now
        self._linger_deadline = now + self.header_linger
        # Round-cadence trace: round `round`'s lifecycle ends here.
        self._rtrace.mark(str(round), "round_advance")
        metrics.flight_event("round_advance", round=self.round)
        log.debug("Dag moved to round %d", self.round)
        self.last_parents = parents
        return True

    async def _make_header(self) -> None:
        payload = dict(self.digests)
        self.digests = []
        parents, self.last_parents = self.last_parents, []
        header = await Header.new(
            self.name, self.round, payload, parents, self.signature_service
        )
        log.debug("Created %r", header)
        if payload:
            self._proposed[header.round] = payload
            for r in [r for r in self._proposed
                      if r + self.gc_depth < header.round]:
                del self._proposed[r]
        self._m_headers.inc()
        self._m_payload_digests.inc(len(payload))
        self._rtrace.mark(str(header.round), "header_proposed")
        for digest in payload:
            self._mtrace.mark(bytes(digest).hex(), "header")
        if self.benchmark:
            for digest in header.payload:
                # Parsed by the benchmark log parser to attribute batches to
                # rounds (reference proposer.rs:93-97).
                log.info("Created B%d(%r) -> %r", header.round, header.id, digest)
        await self.tx_core.put(header)

    async def run(self) -> None:
        log.debug("Dag starting at round %d", self.round)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.max_header_delay
        min_deadline = loop.time()  # min delay trivially elapsed at boot
        core_get = (
            loop.create_task(self.rx_core.get())
            if self.rx_core is not None
            else None
        )
        workers_get = loop.create_task(self.rx_workers.get())
        wake_get = loop.create_task(self._wake.wait())
        try:
            while True:
                now = loop.time()
                timer_expired = now >= deadline
                min_expired = now >= min_deadline
                enough_digests = self.payload_size >= self.header_size
                # "Ready" payload: a full header, or — with the min-delay
                # cadence enabled — any payload at all.
                ready = enough_digests or (
                    self.min_header_delay > 0 and bool(self.digests)
                )
                # The linger window holds the fast paths only; the max
                # deadline is an unconditional ceiling.
                linger_ok = now >= self._linger_deadline
                if self.last_parents and (
                    timer_expired or (min_expired and linger_ok and ready)
                ):
                    await self._make_header()
                    self.payload_size = 0
                    now = loop.time()
                    deadline = now + self.max_header_delay
                    min_deadline = now + self.min_header_delay

                # With no parent quorum the timers are irrelevant (we cannot
                # propose anyway) — wait purely on the queues instead of
                # busy-spinning on an already-expired deadline.  With
                # parents, wait only until the deadline that can actually
                # trigger: the min one if payload is ready, else the max.
                if not self.last_parents:
                    timeout = None
                elif ready:
                    # Wake at whichever gate still holds the fast path —
                    # min delay or linger — but never past the max
                    # deadline, which mints unconditionally.
                    gate = max(min_deadline, self._linger_deadline)
                    timeout = max(0.0, min(deadline, gate) - now)
                else:
                    timeout = max(0.0, deadline - now)
                waits = {workers_get, wake_get}
                if core_get is not None:
                    waits.add(core_get)
                done, _ = await asyncio.wait(
                    waits,
                    timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if wake_get in done:
                    # deliver_parents already advanced the round; just
                    # rearm the event and fall through to the mint check.
                    self._wake.clear()
                    wake_get = loop.create_task(self._wake.wait())
                if core_get is not None and core_get in done:
                    parents, round = core_get.result()
                    core_get = loop.create_task(self.rx_core.get())
                    # lint: allow-interleave(round/last_parents ARE written mid-mint by Core's synchronous deliver_parents callback while _make_header awaits Header.new — safely: _advance only ever replaces last_parents with a NEWER quorum and bumps round monotonically, _make_header consumed the previous quorum into locals before its first yield, and every loop iteration re-reads both fresh before the next mint decision)
                    self._advance(parents, round)
                if workers_get in done:
                    digest, worker_id = workers_get.result()
                    workers_get = loop.create_task(self.rx_workers.get())
                    if _TRACE:
                        log.info("TRACE payload arrived %r", digest)
                    self._mtrace.mark(bytes(digest).hex(), "digest_at_primary")
                    self.payload_size += len(digest)
                    self.digests.append((digest, worker_id))
        finally:
            if core_get is not None:
                core_get.cancel()
            workers_get.cancel()
            wake_get.cancel()
