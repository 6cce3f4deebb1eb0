"""Stake-weighted aggregation of votes and certificates.

Reference primary/src/aggregators.rs (85 LoC).  Both emit exactly once at
2f+1 stake (weight reset to 0 on quorum, aggregators.rs:38,74), and both
reject authority reuse.
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..config import Committee
from ..crypto import Digest, PublicKey, aggregate_votes
from ..crypto.aggregate import scheme as cert_sig_scheme
from .errors import AuthorityReuse
from .messages import Certificate, Header, Vote


class VotesAggregator:
    """Aggregates votes for our current header into a certificate."""

    def __init__(self) -> None:
        self.weight = 0
        self.votes = []
        self.used: Set[PublicKey] = set()

    def append(
        self, vote: Vote, committee: Committee, header: Header
    ) -> Optional[Certificate]:
        if vote.author in self.used:
            raise AuthorityReuse(repr(vote.author))
        self.used.add(vote.author)
        self.votes.append((vote.author, vote.signature))
        self.weight += committee.stake(vote.author)
        if self.weight >= committee.quorum_threshold():
            self.weight = 0  # ensures quorum is only reached once
            if cert_sig_scheme() == "halfagg":
                # Fold the quorum into ONE aggregate at assembly time
                # (ROADMAP item 2): every vote signed this certificate's
                # digest, so the digest the aggregate binds is known
                # before the votes are attached.
                certificate = Certificate(header=header)
                signers, agg = aggregate_votes(
                    bytes(certificate.digest()), self.votes
                )
                certificate.agg_signers = signers
                certificate.agg = agg
                return certificate
            return Certificate(header=header, votes=list(self.votes))
        return None


class CertificatesAggregator:
    """Aggregates certificates per round; emits the parent list that lets the
    proposer advance — the round-advance trigger."""

    def __init__(self) -> None:
        self.weight = 0
        self.certificates: List[Digest] = []
        self.used: Set[PublicKey] = set()

    def append(
        self, certificate: Certificate, committee: Committee
    ) -> Optional[List[Digest]]:
        origin = certificate.origin
        if origin in self.used:
            return None
        self.used.add(origin)
        self.certificates.append(certificate.digest())
        self.weight += committee.stake(origin)
        if self.weight >= committee.quorum_threshold():
            self.weight = 0  # ensures quorum is only reached once
            out, self.certificates = self.certificates, []
            return out
        return None
