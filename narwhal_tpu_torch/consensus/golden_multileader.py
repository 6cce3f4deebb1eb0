"""The multi-leader commit rule's frozen dict-walk oracle.

A commit-rule CHANGE (not a rewrite) needs its own oracle: the
multileader rule (``consensus/tusk.py::MultiLeaderTusk``) deliberately
produces a DIFFERENT commit sequence than both Tusk and LowDepthTusk —
every even round carries K leader slots and the commit anchors on the
lowest supported slot — so neither ``GoldenTusk`` nor
``GoldenLowDepthTusk`` can judge it.  This module freezes the reference
walk for the NEW sequence, written in the same deliberately-naive style
as ``golden.py`` (linear parent scans, per-even-round BFS cone
recomputation, from-scratch support rescans, per-certificate GC sweep)
so the live indexed implementation and its oracle share no optimized
code — including an independent copy of the slot schedule.

The decision rules (Mysticeti's multi-leader insight, arXiv:2310.14821,
instantiated over this repo's even-round cadence):

- **slot schedule** — even round L has K = 3 leader slots; slot 0
  rotates through the sorted committee (``(L // 2) % n``) and the
  backup slots are a round-salted rotation of the rest, so the schedule
  is a pure function of (committee, round) and no authority
  monopolizes the anchor slot.
- **direct anchor** — scan slots 0..K-1 in order; a slot with < 2f+1
  support whose non-support has reached 2f+1 is DEAD (at most f stake
  of child certificates remain, so it can never reach quorum anywhere)
  and the scan passes it; a slot with 2f+1 direct support anchors the
  commit; an undecided slot stops the scan (another node could still
  anchor it).  Two nodes that direct-anchor a round therefore anchor
  the same slot.
- **indirect decision** — when an anchor commits, each earlier even
  round's chain member is the first slot whose leader holds f+1 stake
  of supporters inside the causal cone of the chain head above it.  A
  direct-anchored slot always re-derives (its 2f+1 supporters intersect
  any ≥ 2f+1-stake cone level in f+1 stake); dead lower slots (≤ f
  global support) never can — so direct and indirect nodes order the
  same slots at the same positions.

Checkpoints written under this rule carry their own magic (``NCKML1``):
a frontier snapshot is only meaningful to the rule that produced the
frontier, so a cross-rule restore must refuse, not reinterpret.

Do not optimize this file.  Its only job is to stay what it is.
"""

from __future__ import annotations

import hashlib
import logging
import struct
from typing import Dict, List, Optional, Tuple

from ..config import Committee
from ..crypto import Digest, PublicKey
from ..messages import Round
from ..primary.messages import Certificate, genesis
from .tusk import _check_scheme_trailer, _scheme_trailer

log = logging.getLogger("narwhal.consensus")

# dag: Round → {origin → (certificate digest, certificate)}
Dag = Dict[Round, Dict[PublicKey, Tuple[Digest, Certificate]]]

# Frozen copy of the live schedule's constants and derivation
# (consensus/tusk.py::leader_slots) — the oracle must derive the
# schedule independently, not import the code under test.
MULTILEADER_SLOTS = 3


def _leader_slots(
    sorted_keys: List[PublicKey], round_: Round, fixed_coin: bool
) -> List[PublicKey]:
    n = len(sorted_keys)
    k = min(n, MULTILEADER_SLOTS)
    if fixed_coin:
        return list(sorted_keys[:k])
    base = (round_ // 2) % n
    order = [sorted_keys[(base + j) % n] for j in range(n)]
    head, rest = order[0], order[1:]
    if len(rest) > 1:
        salt = int.from_bytes(
            hashlib.sha256(struct.pack("<Q", round_)).digest()[:8], "little"
        )
        off = salt % len(rest)
        rest = rest[off:] + rest[:off]
    return [head] + rest[: k - 1]


class GoldenMultiLeaderState:
    """Consensus state — dict-DAG only, ``golden.py`` shape."""

    def __init__(self, genesis_certs: List[Certificate]) -> None:
        gen = {c.origin: (c.digest(), c) for c in genesis_certs}
        self.last_committed_round: Round = 0
        self.last_committed: Dict[PublicKey, Round] = {
            name: cert.round for name, (_, cert) in gen.items()
        }
        self.dag: Dag = {0: gen}

    _CKPT_MAGIC = b"NCKML1"

    def snapshot_bytes(self) -> bytes:
        out = bytearray(self._CKPT_MAGIC)
        out += struct.pack("<Q", self.last_committed_round)
        items = sorted(self.last_committed.items())
        out += struct.pack("<I", len(items))
        for name, round in items:
            if len(bytes(name)) != 32:
                raise ValueError("checkpoint: authority key must be 32 bytes")
            out += bytes(name) + struct.pack("<Q", round)
        out += _scheme_trailer()
        return bytes(out)

    def restore(self, blob: bytes) -> None:
        if len(blob) < 18 or blob[:6] != self._CKPT_MAGIC:
            raise ValueError("checkpoint: bad magic")
        (last_round,) = struct.unpack_from("<Q", blob, 6)
        (n,) = struct.unpack_from("<I", blob, 14)
        _check_scheme_trailer(blob, 18 + 40 * n)
        entries = []
        pos = 18
        for _ in range(n):
            name = PublicKey(blob[pos : pos + 32])
            (round,) = struct.unpack_from("<Q", blob, pos + 32)
            entries.append((name, round))
            pos += 40
        self.last_committed_round = last_round
        for name, round in entries:
            self.last_committed[name] = round

    def update(self, certificate: Certificate, gc_depth: Round) -> None:
        """Record a commit and garbage-collect the DAG window — one full
        sweep per committed certificate (the naive form)."""
        origin = certificate.origin
        self.last_committed[origin] = max(
            self.last_committed.get(origin, 0), certificate.round
        )
        self.last_committed_round = max(self.last_committed.values())
        last = self.last_committed_round
        for name, round in self.last_committed.items():
            for r in list(self.dag):
                authorities = self.dag[r]
                if name in authorities and r < round:
                    del authorities[name]
                if not authorities or r + gc_depth < last:
                    del self.dag[r]


class GoldenMultiLeaderTusk:
    """The multi-leader commit rule: feed certificates, get ordered
    commit batches anchored on the lowest committable leader slot."""

    commit_rule = "multileader"

    def __init__(
        self, committee: Committee, gc_depth: Round, fixed_coin: bool = False
    ) -> None:
        self.committee = committee
        self.gc_depth = gc_depth
        self.fixed_coin = fixed_coin
        self.state = GoldenMultiLeaderState(genesis(committee))
        self._sorted_keys = sorted(committee.authorities.keys())

    def _slots(self, round_: Round) -> List[PublicKey]:
        return _leader_slots(self._sorted_keys, round_, self.fixed_coin)

    def insert_certificate(self, certificate: Certificate) -> None:
        self.state.dag.setdefault(certificate.round, {})[
            certificate.origin
        ] = (certificate.digest(), certificate)

    def _slot_support(self, leader_round: Round, digest: Digest) -> int:
        """From-scratch support for one slot leader: stake of
        round-(L+1) certificates citing its digest."""
        return sum(
            self.committee.stake(cert.origin)
            for _, cert in self.state.dag.get(leader_round + 1, {}).values()
            if digest in cert.header.parents
        )

    def _child_stake(self, leader_round: Round) -> int:
        return sum(
            self.committee.stake(cert.origin)
            for _, cert in self.state.dag.get(leader_round + 1, {}).values()
        )

    def process_certificate(self, certificate: Certificate) -> List[Certificate]:
        state = self.state
        round = certificate.round
        self.insert_certificate(certificate)

        # Which leader round can this arrival have affected?  A
        # round-(L+1) certificate changes slot support and child stake
        # for round L (both sides of the anchor scan); a slot leader's
        # own arrival makes already-present support countable.  Any
        # other arrival changes no slot decision and cannot trigger.
        if round % 2 == 1:
            leader_round = round - 1
        elif certificate.origin in self._slots(round):
            leader_round = round
        else:
            return []
        if leader_round < 2 or leader_round <= state.last_committed_round:
            return []

        # Slot-ordered anchor scan (module docstring): lowest slot with
        # direct 2f+1 support, passing only DEAD lower slots.  All
        # tallies recomputed from scratch over the whole child round.
        quorum = self.committee.quorum_threshold()
        child_stake = self._child_stake(leader_round)
        anchor = None
        for name in self._slots(leader_round):
            got = state.dag.get(leader_round, {}).get(name)
            support = (
                self._slot_support(leader_round, got[0])
                if got is not None
                else 0
            )
            if support >= quorum:
                if got is None:
                    return []
                anchor = got[1]
                break
            if child_stake - support < quorum:
                return []  # undecided slot: nothing may anchor past it
            # dead slot: scan on
        if anchor is None:
            return []

        sequence: List[Certificate] = []
        for past_leader in reversed(self.order_leaders(anchor)):
            for x in self.order_dag(past_leader):
                state.update(x, self.gc_depth)
                sequence.append(x)
        return sequence

    def order_leaders(self, leader: Certificate) -> List[Certificate]:
        to_commit = [leader]
        state = self.state
        for r in range(
            leader.round - 2, state.last_committed_round + 1, -2
        ):
            member = self._cone_member(leader, r, state.dag)
            if member is not None:
                to_commit.append(member)
                leader = member
        return to_commit

    def _cone_member(
        self, chain_tail: Certificate, leader_round: Round, dag: Dag
    ) -> Optional[Certificate]:
        """Chain member for even round ``leader_round``: the first slot
        whose leader holds f+1 stake of supporters inside the causal
        cone of ``chain_tail`` at round leader_round+1.  The cone level
        is recomputed by a fresh round-by-round BFS per even round (the
        naive form of the live walk's single descending frontier)."""
        frontier = [chain_tail]
        for r in range(chain_tail.round - 1, leader_round, -1):
            frontier = [
                certificate
                for digest, certificate in dag.get(r, {}).values()
                if any(digest in x.header.parents for x in frontier)
            ]
        validity = self.committee.validity_threshold()
        for name in self._slots(leader_round):
            got = dag.get(leader_round, {}).get(name)
            if got is None:
                continue
            digest = got[0]
            support = sum(
                self.committee.stake(x.origin)
                for x in frontier
                if digest in x.header.parents
            )
            if support >= validity:
                return got[1]
        return None

    def order_dag(self, leader: Certificate) -> List[Certificate]:
        """DFS flatten with linear-scan parent resolution."""
        state = self.state
        ordered: List[Certificate] = []
        already_ordered = set()
        buffer = [leader]
        while buffer:
            x = buffer.pop()
            ordered.append(x)
            for parent in sorted(x.header.parents):
                found = None
                for digest, certificate in state.dag.get(x.round - 1, {}).values():
                    if digest == parent:
                        found = (digest, certificate)
                        break
                if found is None:
                    continue  # already ordered or GC'd up to here
                digest, certificate = found
                skip = digest in already_ordered
                skip |= (
                    state.last_committed.get(certificate.origin, -1)
                    >= certificate.round
                )
                if not skip:
                    buffer.append(certificate)
                    already_ordered.add(digest)
        ordered = [
            x
            for x in ordered
            if x.round + self.gc_depth >= state.last_committed_round
        ]
        ordered.sort(key=lambda x: x.round)  # stable: prettier sequence
        return ordered
