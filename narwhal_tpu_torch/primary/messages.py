"""Protocol messages of the DAG: Header, Vote, Certificate.

Reference primary/src/messages.rs (256 LoC).  Deterministic hashing rules
(SHA-512/32B over canonical field bytes, maps/sets iterated sorted — BTreeMap
semantics):
- Header.id   = H(author ‖ round_le64 ‖ {digest ‖ worker_id_le32}* ‖ parents*)
  (messages.rs:70-84)
- Vote digest = H(header_id ‖ round_le64 ‖ origin)              (messages.rs:145-153)
- Certificate digest = H(header_id ‖ round_le64 ‖ origin)       (messages.rs:226-234)

Vote digest and certificate digest coincide by construction: every vote signs
exactly the digest of the certificate it will be folded into, which is what
makes quorum verification a single batched check over one message — the TPU
vmap target (SURVEY.md §3.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..config import Committee, WorkerId
from ..crypto import (
    AggregateSignature,
    Digest,
    PublicKey,
    Signature,
    digest32,
    verify,
    verify_aggregate,
    verify_batch,
)
from ..crypto.aggregate import SCHEMES, SchemeMismatch, scheme as cert_sig_scheme
from ..messages import Round, read_key_ref, skip_key_ref, write_key_ref
from ..network import wirev2
from ..utils.serde import Reader, Writer
from .errors import (
    AuthorityReuse,
    CertificateRequiresQuorum,
    InvalidHeaderId,
    InvalidSignature,
    UnknownAuthority,
)

# --- Header ------------------------------------------------------------------


@dataclass
class Header:
    author: PublicKey
    round: Round
    payload: Dict[Digest, WorkerId]
    parents: Set[Digest]
    id: Digest = field(default_factory=Digest.zero)
    signature: Signature = field(default_factory=Signature.default)

    @classmethod
    async def new(cls, author, round, payload, parents, signature_service) -> "Header":
        header = cls(author=author, round=round, payload=payload, parents=set(parents))
        header.id = header.compute_digest()
        header.signature = await signature_service.request_signature(
            header.id, site="header"
        )
        return header

    def compute_digest(self) -> Digest:
        w = Writer()
        w.raw(self.author)
        w.u64(self.round)
        for digest in sorted(self.payload):
            w.raw(digest)
            w.u32(self.payload[digest])
        for parent in sorted(self.parents):
            w.raw(parent)
        return digest32(w.finish())

    def verify_structure(self, committee: Committee) -> None:
        """All non-crypto checks of verify() (reference messages.rs:48-63)."""
        if self.id != self.compute_digest():
            raise InvalidHeaderId(f"header {self.id!r} id mismatch")
        if committee.stake(self.author) <= 0:
            raise UnknownAuthority(repr(self.author))

    def signature_claims(self) -> List[Tuple[bytes, PublicKey, Signature]]:
        """(message, key, signature) triples this message's validity rests
        on — the unit the Core accumulates into one batched device verify
        (SURVEY.md §7 'accumulate → batch-verify → replay')."""
        return [(bytes(self.id), self.author, self.signature)]

    def verify(self, committee: Committee) -> None:
        """Reference messages.rs:48-67."""
        self.verify_structure(committee)
        if not verify(
            bytes(self.id), self.author, self.signature, site="header"
        ):
            raise InvalidSignature(f"header {self.id!r}")

    def encode(self, w: Writer) -> None:
        # Wire v2 (NARWHAL_WIRE_V2, the default): committee-index key
        # refs and varint rounds/counts — the header's only raw 32-byte
        # material is its digests, which the per-connection dictionary
        # then back-references.  The legacy body is the =0 A/B arm.
        # Hashing preimages (compute_digest) are NOT touched by either:
        # ids are flag-invariant.
        if wirev2.enabled():
            write_key_ref(w, self.author)
            w.uvarint(self.round)
            w.uvarint(len(self.payload))
            for digest in sorted(self.payload):
                w.raw(digest)
                w.uvarint(self.payload[digest])
            w.uvarint(len(self.parents))
        else:
            w.raw(self.author)
            w.u64(self.round)
            w.u32(len(self.payload))
            for digest in sorted(self.payload):
                w.raw(digest)
                w.u32(self.payload[digest])
            w.u32(len(self.parents))
        for parent in sorted(self.parents):
            w.raw(parent)
        w.raw(self.id)
        w.raw(self.signature)

    @classmethod
    def decode(cls, r: Reader) -> "Header":
        if wirev2.enabled():
            author = read_key_ref(r)
            round = r.uvarint()
            payload = {}
            for _ in range(r.uvarint()):
                d = Digest(r.raw(32))
                payload[d] = r.uvarint()
            n_parents = r.uvarint()
        else:
            author = PublicKey(r.raw(32))
            round = r.u64()
            payload = {}
            for _ in range(r.u32()):
                d = Digest(r.raw(32))
                payload[d] = r.u32()
            n_parents = r.u32()
        parents = {Digest(r.raw(32)) for _ in range(n_parents)}
        id_ = Digest(r.raw(32))
        signature = Signature(r.raw(64))
        return cls(author, round, payload, parents, id_, signature)

    def __repr__(self) -> str:
        return f"{self.id!r}: B{self.round}({self.author!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Header) and self.id == other.id

    def __hash__(self) -> int:
        return hash(self.id)


# --- Vote --------------------------------------------------------------------


@dataclass
class Vote:
    id: Digest  # header id being voted for
    round: Round
    origin: PublicKey  # header author
    author: PublicKey  # voter
    signature: Signature = field(default_factory=Signature.default)

    @classmethod
    async def new(cls, header: Header, author: PublicKey, signature_service) -> "Vote":
        vote = cls(id=header.id, round=header.round, origin=header.author, author=author)
        vote.signature = await signature_service.request_signature(
            vote.digest(), site="vote"
        )
        return vote

    def digest(self) -> Digest:
        w = Writer()
        w.raw(self.id)
        w.u64(self.round)
        w.raw(self.origin)
        return digest32(w.finish())

    def verify_structure(self, committee: Committee) -> None:
        if committee.stake(self.author) <= 0:
            raise UnknownAuthority(repr(self.author))

    def signature_claims(self) -> List[Tuple[bytes, PublicKey, Signature]]:
        return [(bytes(self.digest()), self.author, self.signature)]

    def verify(self, committee: Committee) -> None:
        self.verify_structure(committee)
        if not verify(
            bytes(self.digest()), self.author, self.signature, site="vote"
        ):
            raise InvalidSignature(f"vote by {self.author!r}")

    def encode(self, w: Writer) -> None:
        w.raw(self.id)
        if wirev2.enabled():
            w.uvarint(self.round)
            write_key_ref(w, self.origin)
            write_key_ref(w, self.author)
        else:
            w.u64(self.round)
            w.raw(self.origin)
            w.raw(self.author)
        w.raw(self.signature)

    @classmethod
    def decode(cls, r: Reader) -> "Vote":
        if wirev2.enabled():
            return cls(
                Digest(r.raw(32)),
                r.uvarint(),
                read_key_ref(r),
                read_key_ref(r),
                Signature(r.raw(64)),
            )
        return cls(
            Digest(r.raw(32)),
            r.u64(),
            PublicKey(r.raw(32)),
            PublicKey(r.raw(32)),
            Signature(r.raw(64)),
        )

    def __repr__(self) -> str:
        return f"{self.digest()!r}: V{self.round}({self.author!r}, {self.id!r})"


# --- Certificate -------------------------------------------------------------


# Certificate wire scheme byte (first byte after the embedded header):
# which certificate-signature scheme the votes section is encoded under.
# Voteless (genesis) certificates always write 0 — they carry no
# signature material, so they are scheme-neutral.  An unknown byte or a
# scheme-bearing byte that differs from this process's scheme refuses
# loudly at decode (SchemeMismatch — the checkpoint-magic pattern):
# silently parsing the other scheme's bytes would misread signature
# material, and a pre-scheme stored certificate misreads its vote count
# as an unknown scheme byte, which is exactly the loud refusal we want.
CERT_SCHEME_INDIVIDUAL = 0
CERT_SCHEME_HALFAGG = 1


@dataclass
class Certificate:
    header: Header
    votes: List[Tuple[PublicKey, Signature]] = field(default_factory=list)
    # --cert-sig-scheme halfagg: the sorted signer quorum plus ONE
    # half-aggregated blob instead of 2f+1 (name, sig) pairs.  Exactly
    # one of votes / (agg_signers, agg) is populated on a non-genesis
    # certificate; genesis has neither.
    agg_signers: List[PublicKey] = field(default_factory=list)
    agg: Optional[AggregateSignature] = None

    @property
    def round(self) -> Round:
        return self.header.round

    @property
    def origin(self) -> PublicKey:
        return self.header.author

    @property
    def scheme(self) -> str:
        """The scheme this certificate's signature material is under
        ("individual" for genesis: no material, scheme-neutral)."""
        return "halfagg" if self.agg is not None else "individual"

    def voters(self) -> List[PublicKey]:
        """The authorities whose signatures back this certificate,
        scheme-independent — the stake/reuse checks run over this."""
        if self.agg is not None:
            return list(self.agg_signers)
        return [name for name, _ in self.votes]

    def digest(self) -> Digest:
        # Memoized: H(header_id ‖ round ‖ origin) never changes after
        # construction (votes do not participate), and the commit path
        # asks for it ~10× per certificate per node — at committee scale
        # the recomputation was a measured top-10 cost.
        d = getattr(self, "_digest", None)
        if d is None:
            w = Writer()
            w.raw(self.header.id)
            w.u64(self.round)
            w.raw(self.origin)
            d = self._digest = digest32(w.finish())
        return d

    def verify_structure(self, committee: Committee) -> None:
        """Quorum + reuse + authority checks (reference messages.rs:189-213,
        everything before the batched signature verification)."""
        if self in genesis(committee):
            return
        self.header.verify_structure(committee)
        if self.agg is not None and len(self.agg) != 32 * (
            len(self.agg_signers) + 1
        ):
            # Signer list and blob width must agree BEFORE stake math: a
            # blob carrying more commitments than named signers (or
            # fewer) is malformed, not merely unverifiable.
            raise InvalidSignature(
                f"certificate {self.digest()!r}: aggregate width "
                f"{len(self.agg)} does not match "
                f"{len(self.agg_signers)} signers"
            )
        weight = 0
        used = set()
        for name in self.voters():
            if name in used:
                raise AuthorityReuse(repr(name))
            stake = committee.stake(name)
            if stake <= 0:
                raise UnknownAuthority(repr(name))
            used.add(name)
            weight += stake
        if weight < committee.quorum_threshold():
            raise CertificateRequiresQuorum(repr(self.digest()))

    def signature_claims(self) -> List[Tuple[bytes, PublicKey, Signature]]:
        """Header signature + this certificate's vote material over its
        digest.  ``individual``: 2f+2 claims joining the Core's
        accumulated device batch.  ``halfagg``: exactly TWO claims — the
        header signature plus one aggregate claim (signer tuple +
        AggregateSignature in the key/sig slots), which the backend seam
        prices as ONE verify op at the ``certificate_agg`` site."""
        if self.agg is not None:
            return self.header.signature_claims() + [
                (bytes(self.digest()), tuple(self.agg_signers), self.agg)
            ]
        if not self.votes:  # genesis
            return []
        d = bytes(self.digest())
        return self.header.signature_claims() + [
            (d, name, sig) for name, sig in self.votes
        ]

    def verify(self, committee: Committee) -> None:
        """Quorum + batched signature check (reference messages.rs:189-215).
        The batched call is the #1 crypto hot loop — the TPU backend verifies
        all 2f+1 signatures in one device dispatch; under ``halfagg`` the
        whole quorum is ONE aggregate equation instead."""
        if self in genesis(committee):
            return
        self.verify_structure(committee)
        self.header.verify(committee)
        if self.agg is not None:
            if not verify_aggregate(
                bytes(self.digest()), self.agg_signers, self.agg
            ):
                raise InvalidSignature(f"certificate {self.digest()!r}")
            return
        if not verify_batch(
            self.digest(),
            [n for n, _ in self.votes],
            [s for _, s in self.votes],
            site="certificate",
        ):
            raise InvalidSignature(f"certificate {self.digest()!r}")

    def encode(self, w: Writer) -> None:
        self.header.encode(w)
        # Scheme-versioned votes section (CERT_SCHEME_* rationale above).
        # individual/v2: vote pubkeys ride as committee indices — ~1 byte
        # instead of 32 per vote, 64-byte signatures remain.  halfagg:
        # the signer refs plus ONE 32·(q+1) aggregate blob (length
        # implied by the signer count) — the ROADMAP item 2 collapse.
        if self.agg is not None:
            w.u8(CERT_SCHEME_HALFAGG)
            if wirev2.enabled():
                w.uvarint(len(self.agg_signers))
                for name in self.agg_signers:
                    write_key_ref(w, name)
            else:
                w.u32(len(self.agg_signers))
                for name in self.agg_signers:
                    w.raw(name)
            w.raw(self.agg)
            return
        w.u8(CERT_SCHEME_INDIVIDUAL)
        if wirev2.enabled():
            w.uvarint(len(self.votes))
            for name, sig in self.votes:
                write_key_ref(w, name)
                w.raw(sig)
        else:
            w.u32(len(self.votes))
            for name, sig in self.votes:
                w.raw(name)
                w.raw(sig)

    @classmethod
    def decode(cls, r: Reader) -> "Certificate":
        header = Header.decode(r)
        scheme_byte = r.u8()
        if scheme_byte not in (CERT_SCHEME_INDIVIDUAL, CERT_SCHEME_HALFAGG):
            raise ValueError(
                f"unknown certificate scheme byte {scheme_byte} (known "
                f"schemes: {SCHEMES}; a pre-scheme store must be wiped or "
                "replayed by the version that wrote it)"
            )
        ours = cert_sig_scheme()
        if scheme_byte == CERT_SCHEME_HALFAGG:
            if ours != "halfagg":
                raise SchemeMismatch(
                    "certificate was encoded under cert-sig scheme "
                    f"'halfagg' but this node runs {ours!r}; refusing to "
                    "decode — run the whole committee (and its stores) "
                    "under one --cert-sig-scheme"
                )
            if wirev2.enabled():
                n = r.uvarint()
                signers = [read_key_ref(r) for _ in range(n)]
            else:
                n = r.u32()
                signers = [PublicKey(r.raw(32)) for _ in range(n)]
            if n == 0:
                raise ValueError("halfagg certificate with zero signers")
            agg = AggregateSignature(r.raw(32 * (n + 1)))
            return cls(header, agg_signers=signers, agg=agg)
        votes = []
        if wirev2.enabled():
            for _ in range(r.uvarint()):
                votes.append((read_key_ref(r), Signature(r.raw(64))))
        else:
            for _ in range(r.u32()):
                votes.append((PublicKey(r.raw(32)), Signature(r.raw(64))))
        if votes and ours != "individual":
            raise SchemeMismatch(
                "certificate carries individually-signed votes but this "
                f"node runs cert-sig scheme {ours!r}; refusing to decode "
                "— run the whole committee (and its stores) under one "
                "--cert-sig-scheme"
            )
        return cls(header, votes)

    def serialize(self) -> bytes:
        # Memoized like digest(): the same certificate is re-serialized
        # for the store write, the audit insert, and helper re-serves.
        # Votes are final by the time anything serializes a certificate
        # (the aggregator builds the object once, complete).
        wire = getattr(self, "_wire", None)
        if wire is None:
            w = Writer()
            self.encode(w)
            wire = self._wire = w.finish()
        return wire

    @classmethod
    def deserialize(cls, data: bytes) -> "Certificate":
        # Same single-process memo as decode_primary_message: the
        # dependency checks deserialize a header's ~N stored parents on
        # every process_header, and in a simulated committee the same
        # stored bytes recur across all N nodes.
        if _DECODE_CACHE_ON:
            key = (b"C", data)
            cert = _DECODE_CACHE.get(key)
            if cert is not None:
                return cert
            cert = cls._deserialize(data)
            if len(_DECODE_CACHE) >= _DECODE_CACHE_CAP:
                _DECODE_CACHE.clear()
            _DECODE_CACHE[key] = cert
            return cert
        return cls._deserialize(data)

    @classmethod
    def _deserialize(cls, data: bytes) -> "Certificate":
        r = Reader(data)
        cert = cls.decode(r)
        r.expect_done()
        return cert

    def __repr__(self) -> str:
        return f"{self.digest()!r}: C{self.round}({self.origin!r}, {self.header.id!r})"

    def __eq__(self, other) -> bool:
        # Round and origin MUST participate: genesis certificates have a
        # zero header id and no votes, so id+votes alone would let a forged
        # non-zero-round certificate compare equal to genesis and skip
        # verification entirely (reference messages.rs:249-256 compares
        # round() and origin() for exactly this reason).
        return (
            isinstance(other, Certificate)
            and self.header == other.header
            and self.round == other.round
            and self.origin == other.origin
            and self.votes == other.votes
            # Aggregate material participates for the same reason votes
            # do: a forged voteless-but-aggregated certificate must not
            # compare equal to genesis and skip verification.
            and self.agg_signers == other.agg_signers
            and self.agg == other.agg
        )


_GENESIS_CACHE: "weakref.WeakKeyDictionary[Committee, List[Certificate]]" = None  # type: ignore


def genesis(committee: Committee) -> List[Certificate]:
    """One unsigned certificate per authority at round 0
    (reference messages.rs:175-187).  Memoized per committee object:
    ``Certificate.verify_structure`` consults this list for EVERY
    certificate sanitized, and rebuilding N certificates (each hashing
    its header) per call was a measured top-5 cost of a simulated N=20
    committee.  Callers treat the result as immutable."""
    global _GENESIS_CACHE
    if _GENESIS_CACHE is None:
        import weakref

        _GENESIS_CACHE = weakref.WeakKeyDictionary()
    cached = _GENESIS_CACHE.get(committee)
    if cached is None:
        cached = _GENESIS_CACHE[committee] = [
            Certificate(
                header=Header(
                    author=name, round=0, payload={}, parents=set()
                )
            )
            for name in committee.authorities
        ]
    return cached


# --- primary ↔ primary wire frames ------------------------------------------

PM_HEADER = 0
PM_VOTE = 1
PM_CERTIFICATE = 2
PM_CERTIFICATES_REQUEST = 3

# Wire-type names for the goodput ledger (see narwhal_tpu/messages.py
# frame_classifier): the primary↔primary plane's tag space.
PRIMARY_FRAME_TYPES = {
    PM_HEADER: "header",
    PM_VOTE: "vote",
    PM_CERTIFICATE: "certificate",
    PM_CERTIFICATES_REQUEST: "cert_request",
}


def encode_primary_message(obj) -> bytes:
    w = Writer()
    if isinstance(obj, Header):
        w.u8(PM_HEADER)
        obj.encode(w)
    elif isinstance(obj, Vote):
        w.u8(PM_VOTE)
        obj.encode(w)
    elif isinstance(obj, Certificate):
        w.u8(PM_CERTIFICATE)
        obj.encode(w)
    else:
        raise TypeError(type(obj))
    return w.finish()


def encode_certificates_request(digests: List[Digest], requestor: PublicKey) -> bytes:
    w = Writer()
    w.u8(PM_CERTIFICATES_REQUEST)
    if wirev2.enabled():
        w.uvarint(len(digests))
        for d in digests:
            w.raw(d)
        write_key_ref(w, requestor)
    else:
        w.u32(len(digests))
        for d in digests:
            w.raw(d)
        w.raw(requestor)
    return w.finish()


# Frame-decode memo for single-process committees (the simulation
# harness): a broadcast header/certificate frame arrives at N-1 in-process
# receivers (and again via helper re-serves), and each arrival would
# repeat the full field-by-field parse — the measured #1 wall cost of an
# N=20 sim round.  Decoded messages are treated immutably everywhere
# (receivers never write into a decoded Header/Certificate; aggregators
# build their own state), so sharing one decoded object per distinct
# frame is safe.  OFF by default: a multi-process node sees each frame
# once and the memo would only hold dead objects.
_DECODE_CACHE: dict = {}  # bytes frame → decoded tuple; (b"C", bytes) → Certificate
_DECODE_CACHE_CAP = 16_384
_DECODE_CACHE_ON = False


def set_decode_cache(enabled: bool) -> None:
    """Enable/disable the frame-decode memo (simulation harness only);
    disabling also drops the cached objects."""
    global _DECODE_CACHE_ON
    _DECODE_CACHE_ON = bool(enabled)
    _DECODE_CACHE.clear()


def decode_primary_message(data: bytes):
    """Returns ("header", Header) | ("vote", Vote) | ("certificate", Certificate)
    | ("certificates_request", digests, requestor)."""
    if _DECODE_CACHE_ON:
        out = _DECODE_CACHE.get(data)
        if out is not None:
            return out
        out = _decode_primary_message(data)
        if len(_DECODE_CACHE) >= _DECODE_CACHE_CAP:
            _DECODE_CACHE.clear()  # wholesale: entries age together
        _DECODE_CACHE[data] = out
        return out
    return _decode_primary_message(data)


def _decode_primary_message(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == PM_HEADER:
        out = ("header", Header.decode(r))
    elif tag == PM_VOTE:
        out = ("vote", Vote.decode(r))
    elif tag == PM_CERTIFICATE:
        out = ("certificate", Certificate.decode(r))
    elif tag == PM_CERTIFICATES_REQUEST:
        if wirev2.enabled():
            digests = [Digest(r.raw(32)) for _ in range(r.uvarint())]
            requestor = read_key_ref(r)
        else:
            digests = [Digest(r.raw(32)) for _ in range(r.u32())]
            requestor = PublicKey(r.raw(32))
        out = ("certificates_request", digests, requestor)
    else:
        raise ValueError(f"unknown PrimaryMessage tag {tag}")
    r.expect_done()
    return out


# --- wire-v2 digest-span walkers (primary plane) -----------------------------
#
# Offsets of the 32-byte dictionary material in each v2-encoded frame,
# for the per-connection reference compression (wirev2.register_spans;
# best-effort by contract — a parse error means "no spans", never
# corruption).  This is where the cert-broadcast repetition pays off: a
# round's certificate re-carries its header's parents/payload digests
# and id, all of which the same connection just shipped in the header
# frame.


def _header_body_spans(r: Reader, spans: List[int]) -> None:
    skip_key_ref(r, spans)  # author (literal only for unknown keys)
    r.uvarint()  # round
    for _ in range(r.uvarint()):  # payload
        spans.append(r.tell())
        r.raw(32)
        r.uvarint()
    for _ in range(r.uvarint()):  # parents
        spans.append(r.tell())
        r.raw(32)
    spans.append(r.tell())  # id
    r.raw(32)
    r.raw(64)  # signature: not dictionary material


def _header_spans(data: bytes) -> List[int]:
    r = Reader(data)
    r.u8()
    spans: List[int] = []
    _header_body_spans(r, spans)
    return spans


def _vote_spans(data: bytes) -> List[int]:
    r = Reader(data)
    r.u8()
    spans = [r.tell()]  # header id
    r.raw(32)
    r.uvarint()  # round
    skip_key_ref(r, spans)  # origin
    skip_key_ref(r, spans)  # author
    return spans


def _certificate_spans(data: bytes) -> List[int]:
    r = Reader(data)
    r.u8()
    spans: List[int] = []
    _header_body_spans(r, spans)
    scheme_byte = r.u8()
    if scheme_byte == CERT_SCHEME_HALFAGG:
        n = r.uvarint()
        for _ in range(n):  # signer refs
            skip_key_ref(r, spans)
        r.raw(32 * (n + 1))  # aggregate blob: nonces never repeat
    else:
        for _ in range(r.uvarint()):  # votes
            skip_key_ref(r, spans)
            r.raw(64)
    return spans


# cert_request frames ride SimpleSender (header_waiter), whose
# connections stay on legacy framing — no walker registered for them.
wirev2.register_spans("header", _header_spans)
wirev2.register_spans("vote", _vote_spans)
wirev2.register_spans("certificate", _certificate_spans)
