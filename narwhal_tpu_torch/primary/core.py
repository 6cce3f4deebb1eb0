"""Core: the DAG state machine.

Reference primary/src/core.rs (412 LoC): one select loop over peer messages,
waiter loopbacks and own proposals.  process_header (dedupe → parents present
+ quorum of round-1 → payload present → persist → vote once per (round,
author)); process_vote (aggregate → broadcast certificate at quorum);
process_certificate (ensure header processed, ancestors delivered, persist,
feed CertificatesAggregator → advance round, forward to consensus).
Sanitizers verify signatures and round bounds; per-round maps are GC'd from
the shared consensus round.

Round-cadence fast path (ISSUE r10).  The r09 attribution showed 97-98% of
commit latency is protocol cadence (round period × commit depth), so the
header→vote→cert round-trip is pipelined here:

- **Vote fast path**: a valid header's vote decision (the once-per-(round,
  author) rule) and signature happen immediately, but the header's store
  record is buffered (``Store.write_deferred``) and the vote send is
  staged; one flush per drained burst appends every buffered record in a
  single writev and THEN releases the staged votes.  Persist-before-vote
  is preserved — no vote leaves the node before its header is logged —
  but the log syscall is paid once per burst, not once per header.
  ``NARWHAL_VOTE_FAST_PATH=0`` (or ``fast_path=False``) restores the
  per-header persist+send for A/B measurement (bench_cadence.py).
- **Direct parent delivery**: when the certificate quorum for a round
  completes, the parents are handed to the Proposer via a synchronous
  callback (``parents_cb``) instead of a queue put → event-loop wakeup →
  queue get round-trip.
- **Per-burst GC**: the per-round-map GC sweep runs once per drained
  burst, not once per message (mirrors the r09 consensus gc-per-burst).
- **Cached address lists**: the committee is static per run, so broadcast
  address lists and the per-author primary address map are computed once
  at init instead of per header/vote/certificate.

Verify-batch window (ISSUE r19, ROADMAP item 1).  With
``NARWHAL_VERIFY_BATCH_WINDOW_MS > 0`` the peer-message arm of the main
loop stops verifying inline: drained bursts are forwarded to a
pipelined ``_verify_loop`` task that coalesces cross-message-type
signature claims (headers, votes, certificates) from several drains —
up to ``NARWHAL_VERIFY_BATCH_MAX`` messages or the window, whichever
closes first — into ONE backend dispatch, then replays in arrival
order.  The device round trip runs off the event loop (the backend's
dispatch thread), and run() keeps servicing the proposer/waiter sources
and draining the network throughout, so consecutive rounds pipeline
behind the verify instead of stalling — and the arrivals during a
dispatch deepen the next batch.  The window is the knob that turns the
r12 mean burst of 3.6 claims into device-sized batches for the
``jax``/``tpu`` backend (crypto/backend.py).
"""

from __future__ import annotations

import asyncio
import logging
import hashlib
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import metrics
from ..config import Committee
from ..crypto import Digest, PublicKey, SignatureService
from ..messages import Round
from ..network import ReliableSender
from ..store import Store
from ..utils.clock import loop_now
from ..utils.env import env_flag, env_float, env_int
from ..utils.serde import Writer
from .aggregators import CertificatesAggregator, VotesAggregator
from .errors import (
    DagError,
    HeaderRequiresQuorum,
    InvalidSignature,
    MalformedHeader,
    TooOld,
    UnexpectedVote,
)
from .messages import (
    Certificate,
    Header,
    Vote,
    encode_primary_message,
)
from .synchronizer import Synchronizer

log = logging.getLogger("narwhal.primary")


class AtomicRound:
    """Shared consensus-round cell (the reference's AtomicU64 with Relaxed
    ordering, primary.rs:89 — plain attribute suffices on one event loop)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Round = 0


class Core:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        synchronizer: Synchronizer,
        signature_service: SignatureService,
        consensus_round: AtomicRound,
        gc_depth: Round,
        rx_primaries: asyncio.Queue,
        rx_header_waiter: asyncio.Queue,
        rx_certificate_waiter: asyncio.Queue,
        rx_proposer: asyncio.Queue,
        tx_consensus: asyncio.Queue,
        tx_proposer: Optional[asyncio.Queue] = None,
        parents_cb: Optional[Callable[[List[Digest], Round], None]] = None,
        late_parents_cb: Optional[Callable[[Digest, Round], None]] = None,
        fast_path: Optional[bool] = None,
        verify_window_ms: Optional[float] = None,
        verify_batch_max: Optional[int] = None,
    ) -> None:
        self.name = name
        self.committee = committee
        self.store = store
        self.synchronizer = synchronizer
        self.signature_service = signature_service
        self.consensus_round = consensus_round
        self.gc_depth = gc_depth
        self.rx_primaries = rx_primaries
        self.rx_header_waiter = rx_header_waiter
        self.rx_certificate_waiter = rx_certificate_waiter
        self.rx_proposer = rx_proposer
        self.tx_consensus = tx_consensus
        self.tx_proposer = tx_proposer
        # Direct (synchronous, same-event-loop) parent delivery to the
        # Proposer; falls back to the tx_proposer queue when unset.
        # At least one must exist, or every parent quorum would be
        # silently discarded and the proposer never advance past round 1.
        if parents_cb is None and tx_proposer is None:
            raise ValueError(
                "Core needs a parent-quorum sink: pass parents_cb "
                "(Proposer.deliver_parents) or a tx_proposer queue"
            )
        self.parents_cb = parents_cb
        # Post-quorum parent forwarding (the proposer's header_linger
        # window): a FRESH certificate of a round whose 2f+1 parent list
        # already went out is offered to the Proposer as a late parent.
        # Only wired when the linger is on — with no window open the
        # callback would be pure per-certificate overhead.
        self.late_parents_cb = late_parents_cb
        # Rounds whose parent quorum has emitted (Dict so the _gc_sweep
        # map loop collects it like the other per-round state).
        self._parents_emitted: Dict[Round, None] = {}
        # Vote fast path (coalesced persist-before-vote); the env knob is
        # the A/B arm selector for bench_cadence.py.
        if fast_path is None:
            fast_path = env_flag("NARWHAL_VOTE_FAST_PATH")
        self.fast_path = fast_path
        # Verify-batch accumulation window (ROADMAP item 1): >0 routes
        # drained peer messages through a pipelined verify task that
        # coalesces claims from MULTIPLE bursts (headers, votes, certs
        # alike) arriving within the window into one backend dispatch —
        # the knob that turns the r12 mean batch of 3.6 into device-
        # sized batches.  0 (default) keeps the pre-r19 inline behavior:
        # one averify per drained burst, replay before the next drain.
        if verify_window_ms is None:
            verify_window_ms = env_float("NARWHAL_VERIFY_BATCH_WINDOW_MS")
        self.verify_window_s = max(0.0, float(verify_window_ms) / 1000.0)
        if verify_batch_max is None:
            verify_batch_max = env_int("NARWHAL_VERIFY_BATCH_MAX")
        self.verify_batch_max = max(1, int(verify_batch_max))
        # Bounded hand-off into the verify pipeline: run() blocks on put
        # when the pipeline is behind, so rx_primaries (and through it
        # the network receiver) keeps its backpressure.
        self._verify_q: Optional[asyncio.Queue] = (
            metrics.InstrumentedQueue(
                max(256, 2 * self.verify_batch_max),
                channel="primary.verify_window",
            )
            if self.verify_window_s > 0
            else None
        )

        self.gc_round: Round = 0
        self.last_voted: Dict[Round, Set[PublicKey]] = {}
        self.processing: Dict[Round, Set[Digest]] = {}
        self.current_header: Header = Header(
            author=name, round=0, payload={}, parents=set()
        )
        self.votes_aggregator = VotesAggregator()
        self.certificates_aggregators: Dict[Round, CertificatesAggregator] = {}
        self.network = ReliableSender()
        self.cancel_handlers: Dict[Round, List[asyncio.Future]] = {}
        # The committee is static per run: compute the broadcast list and
        # the author → primary-address map ONCE instead of per message.
        self.others_addresses: List[str] = [
            a.primary_to_primary
            for _, a in committee.others_primaries(name)
        ]
        self.primary_addresses: Dict[PublicKey, str] = {
            n: a.primary.primary_to_primary
            for n, a in committee.authorities.items()
        }
        # Votes staged by the fast path, released by _flush_pending after
        # the burst's single store flush: (round, author, encoded vote).
        # Only votes for OTHER authors' headers are staged — our own vote
        # never leaves the node, and deferring it past the next
        # process_own_header would mis-aggregate it against the replaced
        # current_header, so it stays inline.
        self._pending_votes: List[Tuple[Round, PublicKey, bytes]] = []
        # Which header id we voted for per (round, author): the witness
        # that turns a second, different header for the same slot into a
        # PROVEN equivocation (the fault-injection detection plane reads
        # the counter; the `equivocation` health rule fires on it).
        self.voted_ids: Dict[Round, Dict[PublicKey, Digest]] = {}
        # Our own header id per round, while the round is within the GC
        # window: the attribution witness for the per-peer vote counters.
        # A received vote only counts as "peer X voted for us" if it names
        # a header we actually proposed — a validly self-signed vote for a
        # fabricated id must not keep a withholding peer's counter warm.
        self.own_header_ids: Dict[Round, Digest] = {}
        # Peers already counted per round: one vote per (round, author)
        # reaches the counter, so re-sending one old genuine vote over and
        # over cannot simulate ongoing participation either.
        self.counted_votes: Dict[Round, Set[PublicKey]] = {}
        # Conflicting header ids already counted as equivocations, per
        # round: retransmissions and sync re-sends re-enter
        # process_header, and each distinct twin must count ONCE — not
        # once per delivery — or the counter misreports attack magnitude.
        self.equivocation_ids: Dict[Round, Set[Tuple[PublicKey, Digest]]] = {}
        # First VERIFIED header id seen per (round, author) — recorded at
        # receipt, before any dependency sync.  Two validly-signed
        # headers for one slot are a proven equivocation the moment both
        # signatures check out; waiting for process_header's vote
        # decision (the original witness) let a paired payload-plane
        # attack mask the proof — the conflicting headers parked in the
        # waiters on exactly the batches the same adversary's worker was
        # withholding, and the fuzzed equivocate+withhold/garbage
        # compositions sailed past the `equivocation` rule at N≥10
        # (sim sweep points 7023/7024/7034/7035).
        self.seen_header_ids: Dict[Round, Dict[PublicKey, Digest]] = {}
        self._m_headers_in = metrics.counter("primary.headers_processed")
        self._m_votes_in = metrics.counter("primary.votes_received")
        self._m_votes_out = metrics.counter("primary.votes_sent")
        self._m_certs_formed = metrics.counter("primary.certificates_formed")
        self._m_certs_in = metrics.counter("primary.certificates_processed")
        self._m_dag_errors = metrics.counter("primary.dag_errors")
        self._m_stale = metrics.counter("primary.stale_messages")
        self._m_late_votes = metrics.counter("primary.late_votes")
        # FIFO cache of verified header/cert digests (see VERIFIED_CACHE).
        # Hits (re-deliveries that skipped crypto) and misses (fresh
        # messages that paid for verification) are both exported: hits ÷
        # (hits + misses) is the duplicate fraction of inbound traffic,
        # and hits × claims-per-message is verification work the cache
        # absorbed — the observability the PR 6 cache shipped without.
        self._verified_recent: Dict[bytes, None] = {}
        self._m_verify_cache_hits = metrics.counter(
            "primary.verify_cache_hits"
        )
        self._m_verify_cache_misses = metrics.counter(
            "primary.verify_cache_misses"
        )
        self._m_vote_flushes = metrics.counter("primary.vote_flushes")
        # Fault-detection plane (read by the NARWHAL_HEALTH rules):
        # proven header equivocations, signature-check rejections, and a
        # per-peer count of votes received from each validator.  The per-peer
        # counters are registered at boot (value 0) so the vote-silence
        # rule has a history series for every peer from the first sample.
        self._m_equivocations = metrics.counter(
            "primary.equivocations_detected"
        )
        self._m_invalid_sigs = metrics.counter("primary.invalid_signatures")
        self._peer_vote_counters: Dict[PublicKey, metrics.Counter] = {
            n: metrics.counter(f"primary.peer_votes.{a}")
            for n, a in self.primary_addresses.items()
            if n != name
        }
        # Quorum-straggler attribution (causal commit tracer): when a
        # vote quorum or a parent quorum completes, the authority whose
        # message CLOSED it is charged by primary address, and the span
        # from that quorum's first arrival to completion lands in a gap
        # histogram.  Both ride the loop clock — wall on a live node,
        # virtual (bit-reproducible) under the sim.  The emit-once
        # aggregator contract (weight reset at quorum, authority-reuse
        # rejection/dedupe) is what makes the charge exactly-once per
        # completion, duplicates and equivocations included.
        self._m_quorum_straggler = {
            n: metrics.counter(f"primary.quorum_straggler.{a}")
            for n, a in self.primary_addresses.items()
        }
        self._m_vote_quorum_gap = metrics.histogram(
            "primary.vote_quorum_gap_ms", metrics.LATENCY_MS_BUCKETS
        )
        self._m_parent_quorum_gap = metrics.histogram(
            "primary.parent_quorum_gap_ms", metrics.LATENCY_MS_BUCKETS
        )
        self._vote_first_ts: Optional[float] = None
        self._parent_first_ts: Dict[Round, float] = {}
        # Crypto-cost ledger, burst side: signature claims entering the
        # batched verify PER MESSAGE KIND.  The backend's per-site
        # instruments see the whole burst as "batch_burst"; these split
        # it back into protocol terms (a header contributes 1 claim, a
        # vote 1, a certificate 2f+2), which is what the bench's
        # protocol-arithmetic cross-check reads.
        self._m_burst_claims = {
            kind: metrics.counter(f"crypto.burst_claims.{kind}")
            for kind in ("header", "vote", "certificate")
        }
        # Wire-goodput ledger: empty vs payload-carrying own headers.
        # "Empty certs per committed byte" (ROADMAP item 3's
        # min_header_delay sub-question) needs the numerator counted at
        # the source: an idle-round header and the votes/certificate it
        # mints are pure control-plane overhead.
        self._m_headers_empty = metrics.counter("primary.own_headers_empty")
        self._m_headers_payload = metrics.counter(
            "primary.own_headers_payload"
        )
        self._mtrace = metrics.trace()
        self._rtrace = metrics.round_trace()

    # --- processing ---------------------------------------------------------

    def _broadcast_own_header(self, header: Header) -> List:
        """Ship our freshly minted header to every peer; returns the
        delivery handlers.  A dedicated seam so the Byzantine wrapper can
        split-cast or re-sign the wire copy without re-implementing
        own-header processing."""
        return self.network.broadcast(
            self.others_addresses, encode_primary_message(header),
            msg_type="header",
        )

    async def process_own_header(self, header: Header) -> None:
        self.current_header = header
        self.own_header_ids[header.round] = header.id
        if header.payload:
            self._m_headers_payload.inc()
        else:
            self._m_headers_empty.inc()
        self.votes_aggregator = VotesAggregator()
        self._vote_first_ts = None  # fresh quorum, fresh first-arrival
        handlers = self._broadcast_own_header(header)
        self._rtrace.mark(str(header.round), "header_broadcast")
        self.cancel_handlers.setdefault(header.round, []).extend(handlers)
        await self.process_header(header)

    async def process_header(self, header: Header) -> None:
        log.debug("Processing %r", header)
        self._m_headers_in.inc()
        self.processing.setdefault(header.round, set()).add(header.id)

        # Ensure we have all parents; otherwise the HeaderWaiter will gather
        # them and loop the header back to us.
        parents = await self.synchronizer.get_parents(header)
        if not parents:
            log.debug("Processing of %r suspended: missing parent(s)", header.id)
            return

        # Parents must form a quorum, all from the previous round.
        stake = 0
        for parent in parents:
            if parent.round + 1 != header.round:
                raise MalformedHeader(repr(header.id))
            stake += self.committee.stake(parent.origin)
        if stake < self.committee.quorum_threshold():
            raise HeaderRequiresQuorum(repr(header.id))

        # Ensure we have the payload; otherwise our workers fetch it and the
        # header comes back through the waiter.
        if await self.synchronizer.missing_payload(header):
            log.debug("Processing of %r suspended: missing payload", header.id)
            return

        # Store the header.  Fast path: the record is buffered (memory and
        # notify_read waiters see it immediately) and the log append is
        # coalesced into the burst's single flush — which happens before
        # any staged vote leaves the node (persist-before-vote).
        w = Writer()
        header.encode(w)
        if self.fast_path:
            self.store.write_deferred(bytes(header.id), w.finish())
        else:
            self.store.write(bytes(header.id), w.finish())

        # Vote at most once per (round, author).  The decision (and the
        # last_voted record) is made HERE, at processing time — staging the
        # send cannot double-vote.
        voted = self.last_voted.setdefault(header.round, set())
        if header.author not in voted:
            voted.add(header.author)
            self.voted_ids.setdefault(header.round, {})[header.author] = (
                header.id
            )
            # lint: allow-interleave(the vote decision and its witnesses (last_voted add, voted_ids record) are complete in the sync block ABOVE this first yield — a second root replaying the same header while Vote.new awaits takes the else-branch and cannot double-vote; the callee chain's later writes only ever ADD other (round, author) entries)
            vote = await Vote.new(header, self.name, self.signature_service)
            self._m_votes_out.inc()
            log.debug("Created %r", vote)
            # lint: allow-interleave(equivocation_ids mutates only in the sync else-branch below (setdefault+add before any yield); a cross-root suspension here can at most interleave ANOTHER author's counting, and each distinct twin still counts exactly once)
            await self._dispatch_vote(vote, header)
        else:
            prev_id = self.voted_ids.get(header.round, {}).get(header.author)
            if prev_id is not None and prev_id != header.id:
                # Two validly-signed headers from one author for one round:
                # a PROVEN equivocation (we hold both signed statements).
                # We already voted for the first — the once-per-slot rule
                # keeps safety — but the protocol silently tolerating it is
                # exactly what the fault suite must not: count it so the
                # `equivocation` health rule names the author.  Each
                # distinct twin counts once, however many times it is
                # re-delivered.
                twin = (header.author, header.id)
                counted = self.equivocation_ids.setdefault(
                    header.round, set()
                )
                if twin not in counted:
                    counted.add(twin)
                    self._m_equivocations.inc()
                    log.warning(
                        "Equivocation by %r at round %d: voted for %r, "
                        "now offered %r",
                        header.author, header.round, prev_id, header.id,
                    )

    async def _dispatch_vote(self, vote: Vote, header: Header) -> None:
        """Send (or locally apply) one freshly created vote.  A dedicated
        seam so the Byzantine wrapper can withhold votes for targeted
        authors without re-implementing header processing."""
        if vote.origin == self.name:
            # lint: allow-interleave(_pending_votes/cancel_handlers are append-only lists consumed by the subset-safe _flush_pending / the monotonic GC sweep — a cross-root append or early flush while this own-vote processing is suspended releases staged votes EARLIER behind their already-buffered store records, never out of persist order)
            await self.process_vote(vote)
        elif self.fast_path:
            self._pending_votes.append(
                (header.round, header.author, encode_primary_message(vote))
            )
        else:
            address = self.primary_addresses[header.author]
            handler = self.network.send(
                address, encode_primary_message(vote), msg_type="vote"
            )
            self.cancel_handlers.setdefault(header.round, []).append(handler)

    def _flush_pending(self) -> None:
        """Release the burst's staged votes: ONE coalesced log flush for
        every header buffered this burst, then the staged sends.  Called
        once per drained burst (the flush alone also covers headers that
        were buffered but produced no vote, e.g. equivocations)."""
        self.store.flush_deferred()
        if not self._pending_votes:
            return
        self._m_vote_flushes.inc()
        staged, self._pending_votes = self._pending_votes, []
        for round, author, body in staged:
            handler = self.network.send(
                self.primary_addresses[author], body, msg_type="vote"
            )
            self.cancel_handlers.setdefault(round, []).append(handler)

    def _note_peer_vote(self, vote: Vote) -> None:
        """Per-peer vote accounting: a validator that stops voting for
        our headers while rounds keep advancing is withholding — the
        `peer_vote_silence` rule reads these rates.  Counted at RECEIPT
        (before the current-header match in sanitize_vote): an
        honest-but-slow peer whose votes consistently land one round
        late — after we propose the next header — is still voting, and
        must not read as silent.  Only signature-backed votes reach
        here (the burst path verifies votes down to one round late;
        farther-late votes skip crypto AND counting), and the vote must
        name the header we actually proposed for its round, at most once
        per (round, peer) — so neither a forged vote, a validly
        self-signed vote for a fabricated header id, nor a replayed old
        genuine vote can keep a withholding peer's counter warm."""
        if (
            vote.author != self.name
            and vote.origin == self.name
            and self.own_header_ids.get(vote.round) == vote.id
        ):
            counted = self.counted_votes.setdefault(vote.round, set())
            if vote.author not in counted:
                counted.add(vote.author)
                peer_votes = self._peer_vote_counters.get(vote.author)
                if peer_votes is not None:
                    peer_votes.inc()

    async def process_vote(self, vote: Vote) -> None:
        log.debug("Processing %r", vote)
        self._m_votes_in.inc()
        self._rtrace.mark(str(vote.round), "first_vote")
        if self._vote_first_ts is None:
            self._vote_first_ts = loop_now()
        certificate = self.votes_aggregator.append(
            vote, self.committee, self.current_header
        )
        if certificate is not None:
            log.debug("Assembled %r", certificate)
            self._m_certs_formed.inc()
            self._rtrace.mark(str(certificate.round), "vote_quorum")
            # This vote CLOSED the quorum: charge its author and record
            # the first-arrival→completion gap (usually our own instant
            # self-vote opens the window, so the gap prices how long the
            # 2f+1-th validator made the certificate wait).
            self._m_vote_quorum_gap.observe(
                1000.0 * (loop_now() - self._vote_first_ts)
            )
            straggler = self._m_quorum_straggler.get(vote.author)
            if straggler is not None:
                straggler.inc()
            # Stage trace: OUR header just got certified — the payload
            # digests it carries cross the header→certificate boundary.
            for digest in certificate.header.payload:
                self._mtrace.mark(bytes(digest).hex(), "cert")
            # Defensive: our certificate must never leave the node before
            # its header's (possibly still buffered) record is logged.
            self.store.flush_deferred()
            handlers = self.network.broadcast(
                self.others_addresses, encode_primary_message(certificate),
                msg_type="certificate",
            )
            self._rtrace.mark(str(certificate.round), "cert_broadcast")
            self.cancel_handlers.setdefault(certificate.round, []).extend(handlers)
            await self.process_certificate(certificate)

    async def process_certificate(self, certificate: Certificate) -> None:
        log.debug("Processing %r", certificate)
        self._m_certs_in.inc()

        # Process the embedded header if we haven't (certified ⇒ its data is
        # retrievable, so processing may proceed regardless).
        if certificate.header.id not in self.processing.get(
            certificate.header.round, ()
        ):
            # lint: allow-interleave(the verify pipeline adds a second root (run + _verify_loop) that can replay this certificate concurrently from the waiter loopback — safely: CertificatesAggregator.append dedupes by origin (a double replay appends nothing), VotesAggregator raises AuthorityReuse into the DagError handler, `processing`/`last_voted`/`voted_ids` mutate in sync blocks before any yield (take-before-yield), and the store writes are idempotent by key)
            await self.process_header(certificate.header)

        # All ancestors must be delivered before consensus sees this.
        if not await self.synchronizer.deliver_certificate(certificate):
            log.debug("Processing of %r suspended: missing ancestors", certificate)
            return

        # Store the certificate.  Fast path: deferred like the headers —
        # nothing leaves the node ordered against this record before the
        # burst flush (our OWN cert broadcast happens in process_vote,
        # before this write, in both arms), and an immediate write here
        # would drain the deferred buffer per certificate, degenerating
        # the one-flush-per-burst coalescing under mixed bursts.  Deferred
        # records keep call order, so the header-then-cert log order the
        # reference guarantees is preserved inside the buffer too.
        if self.fast_path:
            self.store.write_deferred(
                bytes(certificate.digest()), certificate.serialize()
            )
        else:
            self.store.write(
                bytes(certificate.digest()), certificate.serialize()
            )

        # Enough certificates to advance the DAG round?
        aggregator = self.certificates_aggregators.setdefault(
            certificate.round, CertificatesAggregator()
        )
        if (
            certificate.origin not in aggregator.used
            and certificate.round not in self._parent_first_ts
        ):
            # First FRESH certificate of this round's parent quorum
            # (origin-dedupe means a re-delivery never opens the window).
            self._parent_first_ts[certificate.round] = loop_now()
        fresh = certificate.origin not in aggregator.used
        parents = aggregator.append(certificate, self.committee)
        if parents is not None:
            self._parents_emitted[certificate.round] = None
            self._rtrace.mark(str(certificate.round), "parent_quorum")
            first_ts = self._parent_first_ts.get(certificate.round)
            if first_ts is not None:
                self._m_parent_quorum_gap.observe(
                    1000.0 * (loop_now() - first_ts)
                )
            # This certificate CLOSED the round's parent quorum.
            straggler = self._m_quorum_straggler.get(certificate.origin)
            if straggler is not None:
                straggler.inc()
            if self.parents_cb is not None:
                # Synchronous hand-off to the Proposer: the round advances
                # at quorum time, not a queue round-trip later.
                self.parents_cb(parents, certificate.round)
            elif self.tx_proposer is not None:
                await self.tx_proposer.put((parents, certificate.round))
        elif (
            fresh
            and self.late_parents_cb is not None
            and certificate.round in self._parents_emitted
        ):
            # Quorum already emitted for this round: a fresh straggler
            # can still be cited if the proposer's linger window is open.
            self.late_parents_cb(certificate.digest(), certificate.round)

        await self.tx_consensus.put(certificate)

    # --- sanitization -------------------------------------------------------
    #
    # State checks run at processing time, in arrival order, exactly like
    # the reference's sanitize_* (core.rs:306-346); the CRYPTO part of
    # sanitization is hoisted out: every drained message's signature claims
    # are verified in ONE backend batch before the replay (SURVEY.md §7
    # "accumulate → batch-verify → replay"), so the device sees one large
    # dispatch instead of per-message calls.  `sig_ok=None` means "not
    # pre-verified" (waiter loopbacks, own proposals) and keeps the
    # reference's inline verification.

    def sanitize_header(self, header: Header, sig_ok=None) -> None:
        if header.round < self.gc_round:
            raise TooOld(f"header {header.id!r} round {header.round}")
        if sig_ok is None:
            header.verify(self.committee)
        else:
            header.verify_structure(self.committee)
            if not sig_ok:
                raise InvalidSignature(f"header {header.id!r}")

    def sanitize_vote(self, vote: Vote, sig_ok=None) -> None:
        if vote.round < self.current_header.round:
            raise TooOld(f"vote {vote.digest()!r} round {vote.round}")
        if not (
            vote.id == self.current_header.id
            and vote.origin == self.current_header.author
            and vote.round == self.current_header.round
        ):
            raise UnexpectedVote(repr(vote.id))
        if sig_ok is None:
            vote.verify(self.committee)
        else:
            vote.verify_structure(self.committee)
            if not sig_ok:
                raise InvalidSignature(f"vote {vote.digest()!r}")

    def sanitize_certificate(self, certificate: Certificate, sig_ok=None) -> None:
        if certificate.round < self.gc_round:
            raise TooOld(f"certificate {certificate.digest()!r}")
        if sig_ok is None:
            certificate.verify(self.committee)
        else:
            certificate.verify_structure(self.committee)
            if not sig_ok:
                raise InvalidSignature(
                    f"certificate {certificate.digest()!r}"
                )

    # --- main loop ----------------------------------------------------------

    def _note_header_seen(self, header) -> None:
        """Receipt-time equivocation witness: called with a header whose
        author signature has just been verified (directly, or as part of
        its certificate).  Recording the first id per (round, author) —
        and counting any different verified id against it — needs no
        payload/parent sync, so a Byzantine worker plane starving the
        waiters cannot delay the proof past the scenario window.  Shares
        ``equivocation_ids`` with the vote-time witness, so however many
        paths observe one twin it counts exactly once."""
        seen = self.seen_header_ids.setdefault(header.round, {})
        prev = seen.setdefault(header.author, header.id)
        if prev == header.id:
            return
        twin = (header.author, header.id)
        counted = self.equivocation_ids.setdefault(header.round, set())
        if twin not in counted:
            counted.add(twin)
            self._m_equivocations.inc()
            log.warning(
                "Equivocation by %r at round %d: first saw %r, now "
                "offered %r (both validly signed)",
                header.author, header.round, prev, header.id,
            )

    async def _handle(self, source: str, item, sig_ok=None) -> None:
        try:
            if source == "primaries":
                kind = item[0]
                if kind == "header":
                    self.sanitize_header(item[1], sig_ok)
                    self._note_header_seen(item[1])
                    # lint: allow-interleave(window mode runs _handle from two roots — run() for waiter/proposer sources, _verify_loop for peer messages — over the per-round maps and aggregators: every decision+record pair (vote-once via last_voted/voted_ids, equivocation counting, aggregator append) happens in one sync block BEFORE any yield, the aggregators dedupe by authority, and sanitize_* re-checks round state at replay time, so a cross-root suspension can reorder processing but never tear an invariant)
                    await self.process_header(item[1])
                elif kind == "vote":
                    if sig_ok is not False:  # exclude known-forged votes
                        # lint: allow-interleave(same two-root discipline as above: _note_peer_vote completes its read-check-count sync before process_vote's first yield, and own_header_ids is only ever written by process_own_header in a sync prefix — a concurrent own-header replacement changes FUTURE counting, never the completed one)
                        self._note_peer_vote(item[1])
                    self.sanitize_vote(item[1], sig_ok)
                    await self.process_vote(item[1])
                elif kind == "certificate":
                    self.sanitize_certificate(item[1], sig_ok)
                    # The embedded header's signature is one of the
                    # certificate's verified claims — a twin-voter whose
                    # directly-received twin is still parked on payload
                    # sync proves the equivocation HERE, when the real
                    # header's certificate arrives.
                    self._note_header_seen(item[1].header)
                    await self.process_certificate(item[1])
                else:
                    log.warning("Unexpected core message %r", kind)
            elif source == "header_waiter":
                await self.process_header(item)
            elif source == "certificate_waiter":
                await self.process_certificate(item)
            elif source == "proposer":
                await self.process_own_header(item)
        except TooOld as e:
            if (
                source == "primaries"
                and item[0] == "vote"
                and item[1].round >= self.gc_round
            ):
                # A within-GC-window vote for a header we already
                # replaced is LATE, not a replay: routine on a busy
                # committee (the peer's vote raced our next proposal).
                # Keeping it out of stale_messages is what lets the
                # stale_replay rule fire on true replay floods without
                # false-positiving a clean run.  Votes from BELOW the GC
                # horizon are replay material like headers/certificates
                # — they stay in stale_messages so a replayed ancient
                # vote flood still trips the rule.
                self._m_late_votes.inc()
            else:
                self._m_stale.inc()
            log.debug("%s", e)
        except InvalidSignature as e:
            # Counted separately from generic DAG errors: a forged or
            # rogue-key signature never occurs in a healthy committee, so
            # the `invalid_signature` health rule can fire on count > 0.
            self._m_invalid_sigs.inc()
            self._m_dag_errors.inc()
            log.warning("%s", e)
        except DagError as e:
            self._m_dag_errors.inc()
            log.warning("%s", e)

    def _gc_sweep(self) -> None:
        """GC internal per-round state from the shared consensus round.
        Hoisted out of the per-message path: one sweep per drained burst
        (the sweep iterates every per-round map — per-message it was
        O(burst × rounds), pure event-loop stall)."""
        round = self.consensus_round.value
        if round > self.gc_depth:
            gc_round = round - self.gc_depth
            if gc_round <= self.gc_round:
                return  # nothing new to collect
            for m in (
                self.last_voted,
                self.voted_ids,
                self.seen_header_ids,
                self.own_header_ids,
                self.counted_votes,
                self.equivocation_ids,
                self.processing,
                self.certificates_aggregators,
                self._parent_first_ts,
                self._parents_emitted,
            ):
                for k in [k for k in m if k < gc_round]:
                    del m[k]
            for k in [k for k in self.cancel_handlers if k < gc_round]:
                for fut in self.cancel_handlers[k]:
                    fut.cancel()
                del self.cancel_handlers[k]
            self.gc_round = gc_round

    # Max messages drained per wakeup: bounds the batch the device verifies
    # and the latency added ahead of the first message's processing.
    DRAIN_LIMIT = 128
    # Recently-verified header/certificate digests whose re-deliveries
    # skip crypto.  Catch-up is where this matters: a node resyncing a
    # gap receives the same certificates several times over (sync-retry
    # responses race ReliableSender retransmissions), and at pure-Python
    # verify speeds paying full crypto per duplicate is what let the
    # re-request flood outrun verification in the partition-heal fault
    # scenario (100% CPU verifying duplicates, zero commits, 60+ s).
    VERIFIED_CACHE = 8192

    async def _handle_primaries_burst(self, items: List) -> None:
        """Batch-verify the signature claims of a drained burst in one
        backend call, then replay the messages in arrival order."""
        from ..crypto import backend as crypto_backend

        spans = []
        msgs: List[bytes] = []
        keys: List[PublicKey] = []
        sigs: List = []
        for item in items:
            kind = item[0]
            # Pre-filter obviously stale items so they never cost crypto:
            # the replay's sanitize_* raises TooOld on the same (monotone)
            # round checks before ever looking at sig_ok, so skipping the
            # claims here cannot change observable semantics — it only
            # removes a DoS amplification (paying 2f+1 verifications for a
            # certificate the reference rejects pre-crypto).
            # Votes: only FAR-late votes (2+ rounds behind) skip crypto.
            # A vote at current_header.round - 1 is the routine race — the
            # peer voted for the header we just replaced — and it IS
            # verified, so the receipt-time per-peer counter only ever
            # counts signature-backed votes (a forged late vote naming a
            # withholding accomplice cannot keep its counter warm and
            # suppress peer_vote_silence).  The verify cost is bounded by
            # the same argument as current-round votes: one signature per
            # message, no amplification.
            # lint: allow-interleave(current_header/gc_round may advance in the other root while this burst later awaits the backend — safely: both are monotone, so a pre-filter decision taken against an older value is only ever MORE permissive than replay-time sanitize_*, which re-checks the live state and raises TooOld itself; a filter that wrongly marks an item stale cannot happen because rounds never move backward)
            stale = (
                kind in ("header", "certificate")
                and item[1].round < self.gc_round
            ) or (
                kind == "vote"
                # lint: allow-interleave(same monotone-round argument as the pragma above: a stale verdict taken against an older current_header stays valid because rounds never move backward, and replay-time sanitize_vote re-checks the live header)
                and item[1].round + 1 < self.current_header.round
            )
            # Re-delivery of an already-verified header/certificate skips
            # crypto via the cache.  The cache key covers the SIGNATURE
            # bytes, not just the content digest: a re-sent copy whose
            # signatures were tampered (same header id / cert digest,
            # corrupted sig) must MISS the cache and pay full verification
            # — were the key digest-only, the tampered copy would ride
            # sig_ok=True into process_*, and its store.write would
            # replace the genuine record with bytes every syncing peer
            # rejects (a permanent sync hole).  Genuine retransmissions
            # are byte-identical, so they still hit.
            dedup_key = None
            if not stale and kind == "header":
                h = hashlib.sha256(b"h")
                h.update(bytes(item[1].id))
                h.update(bytes(item[1].signature))
                dedup_key = h.digest()
            elif not stale and kind == "certificate":
                h = hashlib.sha256(b"c")
                h.update(bytes(item[1].digest()))
                h.update(bytes(item[1].header.signature))
                for vn, vs in item[1].votes:
                    h.update(bytes(vn))
                    h.update(bytes(vs))
                # halfagg: the signer list and aggregate blob are the
                # signature material — same tamper argument as votes (a
                # re-sent copy with a corrupted aggregate must MISS).
                if item[1].agg is not None:
                    for vn in item[1].agg_signers:
                        h.update(bytes(vn))
                    h.update(bytes(item[1].agg))
                dedup_key = h.digest()
            # lint: allow-interleave(_handle_primaries_burst is single-flight by mode exclusivity: with the window off _verify_loop is never spawned and only run() calls it; with the window on run() forwards peer messages instead of handling them, so only _verify_loop calls it — the cache read→await→insert window is therefore never concurrent with another burst's insert)
            seen = dedup_key is not None and dedup_key in self._verified_recent
            if seen:
                self._m_verify_cache_hits.inc()
            elif dedup_key is not None:
                self._m_verify_cache_misses.inc()
            claims = (
                item[1].signature_claims()
                if not stale and not seen
                and kind in ("header", "vote", "certificate")
                else []
            )
            if claims:
                self._m_burst_claims[kind].inc(len(claims))
            spans.append((len(msgs), len(claims), stale, seen, dedup_key))
            for m, k, s in claims:
                msgs.append(m)
                keys.append(k)
                sigs.append(s)
        mask = (
            await crypto_backend.averify_batch_mask(
                msgs, keys, sigs, site="batch_burst"
            )
            if msgs
            else []
        )
        for item, (off, count, stale, seen, dedup_key) in zip(items, spans):
            # Fail CLOSED on stale-filtered items: they carry zero verified
            # claims, so `all([])` would hand them sig_ok=True.  Today the
            # replay raises TooOld on the same round checks before ever
            # consulting sig_ok, but any future drift between this
            # pre-filter and sanitize_* must not skip the signature gate.
            sig_ok = (not stale) and (seen or all(mask[off : off + count]))
            if dedup_key is not None and sig_ok and not seen:
                self._verified_recent[dedup_key] = None
                if len(self._verified_recent) > self.VERIFIED_CACHE:
                    self._verified_recent.pop(
                        next(iter(self._verified_recent))
                    )
            await self._handle("primaries", item, sig_ok)

    async def _verify_loop(self) -> None:
        """Pipelined verify stage (active when the batch window is on):
        collect peer messages forwarded by run() until the window
        closes or the batch cap is hit, then one backend dispatch +
        in-order replay.  While a dispatch's device round trip is in
        flight (off the event loop), run() keeps draining the next
        bursts into the queue — so round N+1's network/proposer work
        pipelines behind round N's verify instead of stalling, and the
        backlog naturally deepens the next batch."""
        queue = self._verify_q
        loop = asyncio.get_running_loop()
        while True:
            items = [await queue.get()]
            deadline = loop.time() + self.verify_window_s
            while len(items) < self.verify_batch_max:
                try:
                    items.append(queue.get_nowait())
                    continue
                except asyncio.QueueEmpty:
                    pass
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    items.append(
                        await asyncio.wait_for(queue.get(), remaining)
                    )
                except asyncio.TimeoutError:
                    break
            # lint: allow-interleave(run() may flush/sweep after a waiter/proposer burst while this replay is suspended — safely: _flush_pending is subset-safe (flush_deferred appends EVERY buffered store record before releasing any staged vote, so persist-before-vote holds for an early flush of a partial burst) and _gc_sweep is monotonic-guarded (gc_round only advances; a concurrent sweep makes this one a no-op))
            await self._handle_primaries_burst(items)
            # Same per-burst epilogue as run(): one coalesced log flush
            # releasing the staged votes, then the per-round-map sweep.
            self._flush_pending()
            self._gc_sweep()

    async def _forward_to_verify(self, items, verify_task) -> None:
        """Forward a drained burst into the verify pipeline.  Each
        blocked put races the verify task: if the pipeline's sole
        consumer has crashed, a full queue would otherwise block run()
        forever with the failure never surfaced — here the crash
        re-raises out of run() instead."""
        for item in items:
            if not self._verify_q.full() and not verify_task.done():
                self._verify_q.put_nowait(item)
                continue
            put = asyncio.ensure_future(self._verify_q.put(item))
            await asyncio.wait(
                {put, verify_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if verify_task.done():
                put.cancel()
                await asyncio.gather(put, return_exceptions=True)
                verify_task.result()  # re-raises the stage's exception
                raise RuntimeError("core verify loop exited unexpectedly")
            await put

    async def run(self) -> None:
        sources = {
            "primaries": self.rx_primaries,
            "header_waiter": self.rx_header_waiter,
            "certificate_waiter": self.rx_certificate_waiter,
            "proposer": self.rx_proposer,
        }
        loop = asyncio.get_running_loop()
        gets = {
            name: loop.create_task(q.get(), name=f"core-{name}")
            for name, q in sources.items()
        }
        verify_task = (
            loop.create_task(self._verify_loop(), name="core-verify")
            if self._verify_q is not None
            else None
        )
        try:
            while True:
                # The verify task rides in the wait set so its death
                # wakes an otherwise-idle run() immediately; its crash
                # re-raises here instead of wedging the primary.
                wait_set = set(gets.values())
                if verify_task is not None:
                    wait_set.add(verify_task)
                done, _ = await asyncio.wait(
                    wait_set, return_when=asyncio.FIRST_COMPLETED
                )
                if verify_task is not None and verify_task.done():
                    verify_task.result()  # surface a crashed verify stage
                    raise RuntimeError(
                        "core verify loop exited unexpectedly"
                    )
                for name, task in list(gets.items()):
                    if task not in done:
                        continue
                    burst = [task.result()]
                    # Drain whatever else is already queued so the crypto
                    # batch is as large as the backlog allows.
                    queue = sources[name]
                    while len(burst) < self.DRAIN_LIMIT:
                        try:
                            burst.append(queue.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                    gets[name] = loop.create_task(
                        queue.get(), name=f"core-{name}"
                    )
                    if name == "primaries":
                        if self._verify_q is not None:
                            # Window mode: hand the burst to the verify
                            # pipeline and return to draining — the
                            # proposer/waiter sources stay serviced
                            # while the batch accumulates/verifies.
                            await self._forward_to_verify(
                                burst, verify_task
                            )
                        else:
                            # lint: allow-interleave(mode exclusivity: this arm only runs with the window OFF, where _verify_loop was never spawned — the "other root" the static merge sees cannot exist at runtime; the shared epilogue below is additionally subset-safe/monotonic as pragma'd in _verify_loop)
                            await self._handle_primaries_burst(burst)
                    else:
                        for item in burst:
                            await self._handle(name, item)
                    # Once per burst: release the staged votes behind one
                    # coalesced log flush, then sweep the per-round maps.
                    self._flush_pending()
                    self._gc_sweep()
        finally:
            for task in gets.values():
                task.cancel()
            if verify_task is not None:
                verify_task.cancel()
                await asyncio.gather(verify_task, return_exceptions=True)
