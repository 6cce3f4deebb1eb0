"""DAG error model (reference primary/src/error.rs, 59 LoC)."""

from __future__ import annotations


class DagError(Exception):
    pass


class InvalidSignature(DagError):
    pass


class InvalidHeaderId(DagError):
    pass


class UnknownAuthority(DagError):
    pass


class AuthorityReuse(DagError):
    pass


class MalformedHeader(DagError):
    pass


class HeaderRequiresQuorum(DagError):
    pass


class CertificateRequiresQuorum(DagError):
    pass


class UnexpectedVote(DagError):
    pass


class TooOld(DagError):
    """Message round is below the garbage-collection horizon; logged at
    debug level and dropped (reference core.rs:392-398)."""
