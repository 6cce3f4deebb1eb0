"""Byzantine primary behaviors: ``ByzantineCore`` / ``ByzantineProposer``.

Both are thin subclasses of the live protocol classes — the node runs the
REAL header/vote/certificate machinery and the fault is injected exactly
where a real adversary would act, at the network boundary:

- ``equivocate`` — the Proposer mints a signed twin header per round
  (same round, slightly different parent set or payload, so every honest
  peer can fully process it) and the Core broadcasts the real header to
  just enough peers to still certify (quorum − 1, plus our own vote) and
  the twin to everyone else.  Honest peers vote for whichever they saw
  first; when the real header's certificate reaches a twin-voter, its
  Core holds two validly signed headers for one (round, author) slot —
  a proven equivocation, counted into
  ``primary.equivocations_detected`` (the `equivocation` rule's input).
- ``wrong_key`` — headers go out carrying a rogue keypair's signature
  over the correct header id; peers' signature checks reject them
  (``primary.invalid_signatures`` → the `invalid_signature` rule).
- ``withhold_votes`` — never send votes for targeted authors' headers
  (the once-per-slot vote record is still kept, so the node is a silent
  abstainer, not a double voter); the victims' ``peer_vote_silence``
  rule names this node.
- ``replay_stale`` — re-broadcast the node's earliest own certificates
  forever; once the committee's GC horizon passes them, every replay is
  a ``primary.stale_messages`` hit on every peer (the `stale_replay`
  rule's input).

All randomness (peer-set splits, twin perturbation, the rogue key) comes
from the plan's seeded ``random.Random`` so a scenario replays
identically under the same ``NARWHAL_FAULT_SEED``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import metrics
from ..crypto import KeyPair, PublicKey
from ..messages import Round
from ..primary.core import Core
from ..primary.messages import Header, Vote, encode_primary_message
from ..primary.proposer import Proposer
from .spec import BYZANTINE_BEHAVIORS, SpecError
from ..utils.tasks import spawn

log = logging.getLogger("narwhal.faults")

# How many of our earliest certificates the replay loop cycles through.
_STALE_CAP = 4
# Twin headers kept for the Core to pick up (rounds move on; a twin the
# Core never consumed is garbage after a few rounds).
_TWIN_CAP = 16


class ByzantinePlan:
    """Shared state between the Byzantine Proposer and Core of one node:
    which behaviors are active, the seeded RNG, the rogue keypair, and
    the twin headers minted by the Proposer for the Core to split-cast."""

    def __init__(
        self,
        behaviors: Sequence[str],
        seed: int = 0,
        withhold_targets: Optional[Set[PublicKey]] = None,
        replay_interval_ms: int = 250,
        flood_interval_ms: int = 200,
        garbage_bytes: int = 2_200_000,
    ) -> None:
        unknown = set(behaviors) - set(BYZANTINE_BEHAVIORS)
        if unknown:
            raise SpecError(f"unknown byzantine behavior(s): {sorted(unknown)}")
        if {"withhold_batches", "garbage_batches"} <= set(behaviors):
            raise SpecError(
                "withhold_batches and garbage_batches conflict "
                "(both decide what the worker Helper serves)"
            )
        self.behaviors = set(behaviors)
        self.seed = seed
        self.rng = random.Random(seed)
        # None = withhold from every other author.
        self.withhold_targets = withhold_targets
        self.replay_interval_ms = replay_interval_ms
        self.flood_interval_ms = flood_interval_ms
        self.garbage_bytes = garbage_bytes
        self.twins: Dict[Round, Header] = {}
        # Deterministic rogue identity for wrong_key: valid ed25519
        # signatures from a key that is simply not the author's.
        self.rogue = KeyPair.generate(self.rng.randbytes(32))

    def primary_behaviors(self) -> Set[str]:
        from .spec import PRIMARY_BEHAVIORS

        return self.behaviors & set(PRIMARY_BEHAVIORS)

    def worker_behaviors(self) -> Set[str]:
        from .spec import WORKER_BEHAVIORS

        return self.behaviors & set(WORKER_BEHAVIORS)

    @classmethod
    def from_json(cls, obj: dict) -> "ByzantinePlan":
        targets = obj.get("withhold_targets")
        resolved: Optional[Set[PublicKey]] = None
        if targets:
            resolved = {PublicKey.decode_base64(t) for t in targets}
        return cls(
            behaviors=list(obj.get("behaviors", [])),
            seed=int(obj.get("seed", 0)),
            withhold_targets=resolved,
            replay_interval_ms=int(obj.get("replay_interval_ms", 250)),
            flood_interval_ms=int(obj.get("flood_interval_ms", 200)),
            garbage_bytes=int(obj.get("garbage_bytes", 2_200_000)),
        )

    @classmethod
    def load(cls, path: str) -> "ByzantinePlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def favored_split(
        self, addr_by_name: Dict, keep: int
    ) -> Tuple[List[str], List[str]]:
        """The adversary's ONE coordinated peer split, keyed by authority
        so every plane of this node favors the SAME validators: the
        Core's real-header share and the worker's batch under-share both
        take the first ``keep`` names of one seed-derived permutation.

        Coordination is the point (and what a real adversary would do):
        when the splits were drawn independently per plane and per round,
        an equivocate+withhold composition starved the adversary's OWN
        vote quorum — the real-header share needed every member to hold
        the under-shared batch, which at N≥10 almost never happened, so
        the certificate never formed, never crossed the split to the
        twin-voters, and the committee could not prove the equivocation
        it was expected to detect (sim sweep points 7023/7024/7034/7035).
        Aligned splits keep the attack COHERENT: the favored quorum can
        vote, the certificate forms, and the starved side both misses
        batches (the withholding evidence) and holds the twin (the
        equivocation evidence).

        Deterministic from the plan seed and the roster alone — two
        independently-loaded plan instances (one per role process) with
        the same seed produce the same split, and nothing here consumes
        the shared sequential ``self.rng`` stream."""
        names = sorted(addr_by_name)
        random.Random(f"narwhal-favored-peers:{self.seed}").shuffle(names)
        keep = max(0, min(keep, len(names)))
        return (
            [addr_by_name[n] for n in names[:keep]],
            [addr_by_name[n] for n in names[keep:]],
        )


def _require_unit_stake(committee, behavior: str = "equivocate") -> None:
    """Behaviors that split a peer set by COUNT against the
    stake-denominated ``quorum_threshold()`` (equivocate's twin/real
    share, the worker plane's withhold/garbage under-share) are only
    valid when every stake is 1 (count == stake).  On a weighted
    committee the split could fall below quorum (never certified /
    never proven at any peer), silently voiding the scenario — refuse
    loudly instead, naming the behavior that needs the property."""
    stakes = {
        str(n): a.stake
        for n, a in committee.authorities.items()
        if a.stake != 1
    }
    if stakes:
        raise SpecError(
            f"the {behavior!r} behavior requires a unit-stake committee "
            f"(count == stake); found weighted authorities: {stakes}"
        )


class ByzantineProposer(Proposer):
    """Mints the equivocation twin alongside every real header."""

    def __init__(self, plan: ByzantinePlan, name, committee, *args, **kwargs):
        super().__init__(name, committee, *args, **kwargs)
        self.plan = plan
        self.committee = committee
        if "equivocate" in plan.behaviors:
            _require_unit_stake(committee)
        self._m_twins = metrics.counter("faults.byzantine.twins_minted")

    async def _make_header(self) -> None:
        # Mint and register the twin BEFORE super() queues the real
        # header: the Core can consume the header the moment it is
        # queued, and a twin registered after that pop is silently never
        # split-cast (which rounds equivocate would then depend on
        # scheduling, not on the seed).
        if "equivocate" in self.plan.behaviors:
            await self._mint_twin(
                self.round, list(self.last_parents), dict(self.digests)
            )
        await super()._make_header()

    async def _mint_twin(self, round_, parents, payload) -> None:
        # The twin must be fully processable by honest peers (otherwise it
        # parks in their waiters and the equivocation is never proven), so
        # it only ever SHRINKS the real header: drop one parent when the
        # set stays above quorum (stake-1 committees: count == stake), else
        # drop one payload digest (a subset of batches the peers already
        # hold).  An empty-parent-margin, empty-payload round mints none.
        twin_parents, twin_payload = parents, payload
        if len(parents) > self.committee.quorum_threshold():
            drop = self.plan.rng.randrange(len(parents))
            twin_parents = [p for i, p in enumerate(parents) if i != drop]
        elif payload:
            gone = self.plan.rng.choice(sorted(payload))
            twin_payload = {d: w for d, w in payload.items() if d != gone}
        else:
            return
        twin = await Header.new(
            self.name, round_, twin_payload, twin_parents,
            self.signature_service,
        )
        self._m_twins.inc()
        self.plan.twins[round_] = twin
        while len(self.plan.twins) > _TWIN_CAP:
            self.plan.twins.pop(min(self.plan.twins))


class ByzantineCore(Core):
    """Executes the plan's behaviors at the broadcast/vote boundary; all
    inbound processing stays byte-for-byte the honest Core."""

    def __init__(self, plan: ByzantinePlan, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.plan = plan
        if "equivocate" in plan.behaviors:
            _require_unit_stake(self.committee)
        self._stale_certs: List[bytes] = []
        self._replay_futs: List[asyncio.Future] = []
        self._m_equivocated = metrics.counter(
            "faults.byzantine.equivocated_headers"
        )
        self._m_wrong_key = metrics.counter(
            "faults.byzantine.wrong_key_headers"
        )
        self._m_withheld = metrics.counter("faults.byzantine.votes_withheld")
        self._m_replays = metrics.counter("faults.byzantine.stale_replays")

    def _broadcast_own_header(self, header: Header) -> List:
        # Only the WIRE copy is tampered with — local processing (our
        # vote, our certificate aggregation) still sees the real header,
        # exactly like the honest path, because the base class calls this
        # seam for the broadcast alone.
        plan = self.plan
        wire_header = header
        if "wrong_key" in plan.behaviors:
            # Correct header id, valid signature, WRONG key: peers must
            # reject it at the signature gate, not the structure gate.
            wire_header = Header(
                author=header.author,
                round=header.round,
                payload=dict(header.payload),
                parents=set(header.parents),
                id=header.id,
                signature=plan.rogue.sign(header.id),
            )
            self._m_wrong_key.inc()
        message = encode_primary_message(wire_header)
        twin = (
            plan.twins.pop(header.round, None)
            if "equivocate" in plan.behaviors
            else None
        )
        if twin is None:
            return self.network.broadcast(
                self.others_addresses, message, msg_type="header"
            )
        real_share, twin_share = plan.favored_split(
            {
                n: self.committee.primary(n).primary_to_primary
                for n in self.committee.authorities
                if n != self.name
            },
            self.committee.quorum_threshold() - 1,
        )
        handlers = self.network.broadcast(
            real_share, message, msg_type="header"
        )
        handlers.extend(
            self.network.broadcast(
                twin_share, encode_primary_message(twin), msg_type="header"
            )
        )
        self._m_equivocated.inc()
        log.warning(
            "FAULT equivocating at round %d: %r to %d peer(s), "
            "twin %r to %d peer(s)",
            header.round, header.id, len(real_share),
            twin.id, len(twin_share),
        )
        return handlers

    async def _dispatch_vote(self, vote: Vote, header: Header) -> None:
        plan = self.plan
        if "withhold_votes" in plan.behaviors and vote.origin != self.name:
            targets = plan.withhold_targets
            if targets is None or header.author in targets:
                self._m_withheld.inc()
                log.warning(
                    "FAULT withholding vote for %r round %d",
                    header.author, header.round,
                )
                return
        await super()._dispatch_vote(vote, header)

    async def process_certificate(self, certificate) -> None:
        if (
            "replay_stale" in self.plan.behaviors
            and certificate.origin == self.name
            and len(self._stale_certs) < _STALE_CAP
        ):
            self._stale_certs.append(encode_primary_message(certificate))
        await super().process_certificate(certificate)

    async def run(self) -> None:
        replay_task = None
        if "replay_stale" in self.plan.behaviors:
            replay_task = spawn(self._replay_loop(), name="byz-replay")
        try:
            await super().run()
        finally:
            if replay_task is not None:
                replay_task.cancel()

    def _seed_stale_from_store(self) -> None:
        """A restarted replay attacker replays its OLD certificates, not
        its post-restart ones: without this, a crash/restart composition
        re-anchored ``_stale_certs`` at the restart round and the GC
        horizon could not pass them within any affordable scenario
        window (sim sweep point 7017 at N=20) — a replay adversary that
        forgets what it persisted is not a believable adversary.  Scans
        the retained store once at replay start for our earliest own
        vote-carrying certificates."""
        from ..primary.messages import Certificate

        mine = []
        for value in self.store.values():
            if len(value) < 140:
                continue
            try:
                cert = Certificate.deserialize(value)
            except Exception:
                continue
            if cert.votes and cert.origin == self.name:
                mine.append(cert)
        mine.sort(key=lambda c: c.round)
        for cert in mine[:_STALE_CAP]:
            self._stale_certs.append(encode_primary_message(cert))

    async def _replay_loop(self) -> None:
        """Re-broadcast our earliest certificates forever.  Early on the
        replays are idempotent re-inserts at the peers; once the
        committee's GC horizon passes the certificates' rounds, every
        replay is a TooOld rejection — the stale-flood signal."""
        if not self._stale_certs:
            self._seed_stale_from_store()
        interval = max(0.01, self.plan.replay_interval_ms / 1000.0)
        i = 0
        while True:
            await asyncio.sleep(interval)
            if not self._stale_certs:
                continue
            message = self._stale_certs[i % len(self._stale_certs)]
            i += 1
            self._replay_futs = [
                f for f in self._replay_futs if not f.done()
            ]
            if len(self._replay_futs) > 1_000:
                # Peers gone/unreachable: stop accumulating un-ACKed
                # deliveries (the flood must not OOM the attacker).
                for f in self._replay_futs:
                    f.cancel()
                self._replay_futs = []
            self._replay_futs.extend(
                self.network.broadcast(
                    self.others_addresses, message, msg_type="certificate"
                )
            )
            self._m_replays.inc()
