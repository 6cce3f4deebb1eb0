"""The r06 dict-walk Tusk, kept verbatim as a test/bench oracle.

This module is a frozen copy of the pre-index commit rule
(narwhal_tpu/consensus/tusk.py as of PR 3): every parent lookup in
``order_dag`` is a linear scan over a round's certificates, ``linked()``
does per-hop list-membership checks, leader support is recomputed from
scratch on every odd-round arrival, and ``State.update`` sweeps the whole
DAG once per committed certificate.  Slow — and *known correct*: it is
the implementation the reference scenarios (consensus_tests.rs) were
golden-tested against for six rounds.

The live ``Tusk`` rebuilt around indexed, incremental state (PR 4) must
stay certificate-for-certificate equivalent to THIS walk; the discipline
follows the "Reusable Formal Verification of DAG-based Consensus
Protocols" observation (PAPERS.md) that every commit-rule rewrite needs
an unchanged oracle to diff against.  Consumers:

- tests/test_tusk_equivalence.py replays recorded certificate streams
  (multi-leader burst, gc-window wrap, checkpoint restore, fuzz) through
  both implementations and asserts byte-identical commit sequences;
- bench_consensus.py's commit-burst phase uses it as the "before" arm of
  the indexed-walk speedup table (artifacts/consensus_bench_r09.json).

Do not optimize this file.  Its only job is to stay what it was.
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


class GoldenState:
    """Consensus state (reference lib.rs:19-62) — dict-DAG only."""

    def __init__(self, genesis_certs: List[Certificate]) -> None:
        gen = {c.origin: (c.digest(), c) for c in genesis_certs}
        self.last_committed_round: Round = 0
        self.last_committed: Dict[PublicKey, Round] = {
            name: cert.round for name, (_, cert) in gen.items()
        }
        self.dag: Dag = {0: gen}

    _CKPT_MAGIC = b"NCKPT1"

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
        """Record a commit and garbage-collect the DAG window — the
        per-certificate full-DAG sweep the indexed State batches away."""
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


class GoldenTusk:
    """The r06 commit rule: feed certificates, get ordered commit batches."""

    def __init__(
        self, committee: Committee, gc_depth: Round, fixed_coin: bool = False
    ) -> None:
        self.committee = committee
        self.gc_depth = gc_depth
        self.fixed_coin = fixed_coin
        self.state = GoldenState(genesis(committee))
        self._sorted_keys = sorted(committee.authorities.keys())

    def leader(self, round: Round, dag: Dag) -> Optional[Tuple[Digest, Certificate]]:
        coin = 0 if self.fixed_coin else round
        name = self._sorted_keys[coin % len(self._sorted_keys)]
        return dag.get(round, {}).get(name)

    def insert_certificate(self, certificate: Certificate) -> None:
        self.state.dag.setdefault(certificate.round, {})[
            certificate.origin
        ] = (certificate.digest(), certificate)

    def process_certificate(self, certificate: Certificate) -> List[Certificate]:
        state = self.state
        round = certificate.round
        self.insert_certificate(certificate)

        r = round - 1
        if r % 2 != 0 or r < 4:
            return []
        leader_round = r - 2
        if leader_round <= state.last_committed_round:
            return []
        got = self.leader(leader_round, state.dag)
        if got is None:
            return []
        leader_digest, leader = got

        # f+1 support, recomputed from scratch over all of round r-1.
        stake = sum(
            self.committee.stake(cert.origin)
            for _, cert in state.dag.get(r - 1, {}).values()
            if leader_digest in cert.header.parents
        )
        if stake < self.committee.validity_threshold():
            return []

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
