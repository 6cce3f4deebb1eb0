"""The lower-depth commit rule's frozen dict-walk oracle.

A commit-rule CHANGE (not a rewrite) needs its own oracle: the lowdepth
rule (``consensus/tusk.py::LowDepthTusk``) deliberately produces a
DIFFERENT commit sequence than Tusk — leaders commit on direct 2f+1
support one round earlier than the classic two-round pattern — so the
r06 ``GoldenTusk`` cannot judge it.  This module freezes the reference
walk for the NEW sequence, written in the same deliberately-naive style
as ``golden.py`` (linear parent scans, per-hop ``linked()`` BFS,
from-scratch support rescans, per-certificate GC sweep) so the live
indexed implementation and its oracle share no optimized code.

The decision rule (Mysticeti's direct-decision insight, arXiv:2310.14821,
instantiated over this repo's even-round leader schedule):

- **direct commit** — the leader of even round L is committed the moment
  the local DAG holds round-(L+1) certificates citing it with ≥ 2f+1
  stake (the classic rule waits for a round-(L+3) certificate and only
  f+1 support).  2f+1 *direct* support is what makes the lower depth
  safe across nodes: any later certificate's 2f+1 parents at L+1
  intersect the support set in f+1 certificates, so EVERY certificate at
  round ≥ L+2 — in particular every later committed anchor — is linked
  to L, and a node that decides L indirectly (below) orders it exactly
  where a direct committer did.
- **indirect decision** — when an anchor commits, every earlier
  undecided leader is ordered by the same linked-chain walk as the
  classic rule (``order_leaders`` with its frontier reset): linked
  leaders join the chain oldest-first, unlinked leaders are skipped —
  deterministically, because certificates only reach the commit rule
  causally complete (Core delivers ancestors first), so linkage is a
  property of the DAG, not of arrival order.

Checkpoints written under this rule carry their own magic (``NCKLD1``):
a frontier snapshot is only meaningful to the rule that produced the
frontier, so a cross-rule restore must refuse, not reinterpret.

Do not optimize this file.  Its only job is to stay what it is.
"""

from __future__ import annotations

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


class GoldenLowDepthState:
    """Consensus state — dict-DAG only, ``golden.py`` shape."""

    def __init__(self, genesis_certs: List[Certificate]) -> None:
        gen = {c.origin: (c.digest(), c) for c in genesis_certs}
        self.last_committed_round: Round = 0
        self.last_committed: Dict[PublicKey, Round] = {
            name: cert.round for name, (_, cert) in gen.items()
        }
        self.dag: Dag = {0: gen}

    _CKPT_MAGIC = b"NCKLD1"

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


class GoldenLowDepthTusk:
    """The lower-depth commit rule: feed certificates, get ordered commit
    batches one round earlier than the classic walk."""

    commit_rule = "lowdepth"

    def __init__(
        self, committee: Committee, gc_depth: Round, fixed_coin: bool = False
    ) -> None:
        self.committee = committee
        self.gc_depth = gc_depth
        self.fixed_coin = fixed_coin
        self.state = GoldenLowDepthState(genesis(committee))
        self._sorted_keys = sorted(committee.authorities.keys())

    def leader(self, round: Round, dag: Dag) -> Optional[Tuple[Digest, Certificate]]:
        coin = 0 if self.fixed_coin else round
        name = self._sorted_keys[coin % len(self._sorted_keys)]
        return dag.get(round, {}).get(name)

    def _leader_name(self, round_: Round) -> PublicKey:
        coin = 0 if self.fixed_coin else round_
        return self._sorted_keys[coin % len(self._sorted_keys)]

    def insert_certificate(self, certificate: Certificate) -> None:
        self.state.dag.setdefault(certificate.round, {})[
            certificate.origin
        ] = (certificate.digest(), certificate)

    def process_certificate(self, certificate: Certificate) -> List[Certificate]:
        state = self.state
        round = certificate.round
        self.insert_certificate(certificate)

        # Which leader can this arrival have affected?  A round-(L+1)
        # certificate adds direct support for the round-L leader; the
        # round-L leader itself arriving (possibly after its supporters)
        # makes already-present support countable.  Any other arrival
        # changes no leader's direct support and cannot trigger.
        if round % 2 == 1:
            leader_round = round - 1
        elif certificate.origin == self._leader_name(round):
            leader_round = round
        else:
            return []
        if leader_round < 2 or leader_round <= state.last_committed_round:
            return []
        got = self.leader(leader_round, state.dag)
        if got is None:
            return []
        leader_digest, leader = got

        # DIRECT commit gate: 2f+1 stake among the children (round
        # leader_round+1 certificates citing the leader), recomputed from
        # scratch over the whole child round.  2f+1 — not the classic
        # f+1 — is what guarantees every later anchor links to this
        # leader (module docstring), which is what makes committing
        # without the classic round-(L+3) trigger certificate safe.
        stake = sum(
            self.committee.stake(cert.origin)
            for _, cert in state.dag.get(leader_round + 1, {}).values()
            if leader_digest in cert.header.parents
        )
        if stake < self.committee.quorum_threshold():
            return []

        # INDIRECT decision path: identical to the classic walk — every
        # earlier uncommitted leader linked to the new anchor's chain
        # joins it (oldest first), unlinked leaders are skipped for good.
        sequence: List[Certificate] = []
        for past_leader in reversed(self.order_leaders(leader)):
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
            got = self.leader(r, state.dag)
            if got is None:
                continue
            _, prev_leader = got
            if self.linked(leader, prev_leader, state.dag):
                to_commit.append(prev_leader)
                leader = prev_leader
        return to_commit

    def linked(
        self, leader: Certificate, prev_leader: Certificate, dag: Dag
    ) -> bool:
        """Round-by-round BFS with per-hop list-membership checks."""
        parents = [leader]
        for r in range(leader.round - 1, prev_leader.round - 1, -1):
            parents = [
                certificate
                for digest, certificate in dag.get(r, {}).values()
                if any(digest in x.header.parents for x in parents)
            ]
        return any(x is prev_leader or x == prev_leader for x in parents)

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
