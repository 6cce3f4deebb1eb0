"""ed25519 half-aggregation of certificate vote quorums (ROADMAP item 2).

A certificate at N=20 is 63% raw signature bytes (974 of 1546 B/frame,
artifacts/wire_n20_r19.json) and costs 2f+1 ed25519 verifications to
sanitize.  This module implements the ``halfagg`` certificate-signature
scheme (``NARWHAL_CERT_SIG_SCHEME`` / ``node run --cert-sig-scheme``):
the 2f+1 vote signatures over ONE digest are folded at
certificate-assembly time into a single aggregate blob that verifies
with ONE multi-exponentiation equation.

The construction is non-interactive half-aggregation of Schnorr/EdDSA
signatures (Chalkias–Garillot–Kondi–Nikolaenko, CT-RSA 2021): given
votes ``(Rᵢ, sᵢ)`` over message ``m`` under keys ``Aᵢ``, keep every
nonce commitment ``Rᵢ`` and replace the n scalar halves with one
random-linear combination

    s̄ = Σ zᵢ·sᵢ  (mod L),   zᵢ = H(domain ‖ m ‖ A₁‖R₁‖…‖Aₙ‖Rₙ ‖ i)

verified by the single equation

    s̄·B  ==  Σ zᵢ·Rᵢ + Σ (zᵢ·hᵢ mod L)·Aᵢ,   hᵢ = H(Rᵢ‖Aᵢ... (RFC 8032)

computed as one shared-window multiexp (``_ed25519_py.multi_scalar_mul``).

**Size honesty.**  The blob is ``32·(n+1)`` bytes — the n commitments
``Rᵢ`` CANNOT be dropped (each challenge ``hᵢ`` hashes its own ``Rᵢ``),
and CGKN prove this is essentially optimal for non-interactive EdDSA
aggregation.  So ``halfagg`` halves certificate signature bytes
(974 → 558 at N=20, fraction 0.63 → ~0.49); a CONSTANT-size aggregate
requires either pairings (BLS — a dependency the project does not
take on and a different key type) or 2-round interactive signing
(MuSig2/FROST — impossible here: votes are produced independently by
peers that don't yet know the final signer subset).  The
aspiration of ``cert_sig_bytes_fraction ≤ 0.25`` prices that
pairing-based endgame; the measured half-agg numbers are recorded
as-is in the gate artifacts.

Sim-MAC mode (``keys.set_sim_mac``): the deterministic sim replaces
ed25519 with a keyed hash, and the aggregate analog keeps the exact
wire size — per-voter ``macᵢ[:32]`` plus one 32-byte closing binder —
so sim wire captures price ``halfagg`` frames byte-exactly while a
forged vote MAC still reads as invalid.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from .. import metrics
from ..utils.env import env_str
from . import _ed25519_py
from .keys import PublicKey, Signature, sim_mac_enabled, _sim_mac

__all__ = [
    "SCHEMES",
    "AggregateSignature",
    "SchemeMismatch",
    "aggregate_votes",
    "cert_sig_wire_bytes",
    "resolve_scheme",
    "scheme",
    "set_scheme",
    "verify_halfagg",
]

# The selectable certificate-signature schemes and their wire bytes
# (scheme byte 0/1 in the Certificate encoding, see primary/messages.py).
# Like the commit rules, a mixed committee is not supported: frames and
# checkpoints carry the scheme and refuse loudly on mismatch.
SCHEMES = ("individual", "halfagg")

_DOMAIN = b"NARWHAL-ED25519-HALFAGG-v1"
_SIM_DOMAIN = b"NARWHAL-SIMAGG-v1"

_L = _ed25519_py.L


class SchemeMismatch(ValueError):
    """Material produced under one cert-sig scheme was offered to a node
    running the other.  Deliberately loud (the CheckpointRuleMismatch
    pattern): silently parsing the other scheme's bytes would either
    misread signature material or re-verify history the store cannot
    replay — the operator flipped the flag on a live committee/store and
    must be told."""


def resolve_scheme(explicit: Optional[str] = None) -> str:
    """Effective scheme: the explicit (CLI) value wins, else the
    NARWHAL_CERT_SIG_SCHEME env knob, else ``individual``.  Garbage
    raises — a bench arm must never silently measure the wrong scheme
    (the resolve_commit_rule precedent)."""
    name = explicit if explicit is not None else env_str("NARWHAL_CERT_SIG_SCHEME")
    name = (name or "individual").strip().lower()
    if name not in SCHEMES:
        raise ValueError(
            f"unknown cert-sig scheme {name!r}; expected one of {SCHEMES}"
        )
    return name


_SCHEME_OVERRIDE: Optional[str] = None
_SCHEME_CACHE: Optional[str] = None


def scheme() -> str:
    """The process-wide certificate-signature scheme
    (``NARWHAL_CERT_SIG_SCHEME``, default ``individual``).  Read once
    per process — the scheme must not change under live certificates —
    unless a test/harness overrides it via :func:`set_scheme`."""
    global _SCHEME_CACHE
    if _SCHEME_OVERRIDE is not None:
        return _SCHEME_OVERRIDE
    if _SCHEME_CACHE is None:
        _SCHEME_CACHE = resolve_scheme()
    return _SCHEME_CACHE


def set_scheme(value: Optional[str]) -> None:
    """Test/A-B override: a scheme name forces the arm, None re-reads
    the environment on next use."""
    global _SCHEME_OVERRIDE, _SCHEME_CACHE
    if value is not None and value not in SCHEMES:
        raise ValueError(
            f"unknown cert-sig scheme {value!r}; expected one of {SCHEMES}"
        )
    _SCHEME_OVERRIDE = value
    _SCHEME_CACHE = None


def scheme_override() -> Optional[str]:
    """The current override (None = following the environment) — for
    harnesses that scope a temporary arm switch without clobbering an
    outer one (the wirev2.enabled_override pattern)."""
    return _SCHEME_OVERRIDE


# Which scheme this process runs, for the bench summary's scheme-aware
# signature-byte arithmetic and the A/B artifact's arm labelling
# (the wire.format_version gauge pattern).
metrics.gauge_fn(
    "crypto.cert_sig_scheme", lambda: float(SCHEMES.index(scheme()))
)


class AggregateSignature(bytes):
    """``32·(n+1)`` bytes: the n vote nonce commitments ``Rᵢ`` in signer
    order, then the 32-byte aggregated scalar ``s̄`` (sim-MAC mode: n
    truncated MACs then the closing binder — same widths)."""

    __slots__ = ()

    def __new__(cls, b: bytes) -> "AggregateSignature":
        if len(b) < 64 or len(b) % 32:
            raise ValueError(
                "AggregateSignature must be 32*(n+1) bytes for n >= 1 "
                f"signers, got {len(b)}"
            )
        return super().__new__(cls, b)

    @property
    def n_signers(self) -> int:
        return len(self) // 32 - 1


def _coefficients(message: bytes, publics: Sequence[bytes], rs: Sequence[bytes]) -> List[int]:
    """The random-oracle weights zᵢ.  Every zᵢ binds the FULL transcript
    (message, all keys, all commitments) plus its own index, so no
    signer can bias its own weight after seeing the others' — the
    rogue-key/wrong-subset resistance of the scheme lives here."""
    pre = hashlib.sha512()
    pre.update(_DOMAIN)
    pre.update(len(publics).to_bytes(2, "little"))
    pre.update(message)
    for a, r in zip(publics, rs):
        pre.update(a)
        pre.update(r)
    seed = pre.digest()
    return [
        int.from_bytes(
            hashlib.sha512(seed + i.to_bytes(2, "little")).digest(), "little"
        )
        % _L
        for i in range(len(publics))
    ]


def _sim_closing(message: bytes, publics: Sequence[bytes], macs: Sequence[bytes]) -> bytes:
    h = hashlib.sha512()
    h.update(_SIM_DOMAIN)
    h.update(message)
    for a, m in zip(publics, macs):
        h.update(a)
        h.update(m)
    return h.digest()[:32]


def aggregate_votes(
    digest: bytes, votes: Sequence[Tuple[PublicKey, Signature]]
) -> Tuple[List[PublicKey], AggregateSignature]:
    """Fold a quorum of votes over one certificate digest into
    ``(signers, aggregate)``.  Signers are sorted by key (the canonical
    committee order) so the aggregate — and the coefficients bound into
    it — are independent of vote arrival order; duplicates raise."""
    if not votes:
        raise ValueError("aggregate_votes: empty vote set")
    ordered = sorted(votes, key=lambda nv: bytes(nv[0]))
    signers = [name for name, _ in ordered]
    if len(set(signers)) != len(signers):
        raise ValueError("aggregate_votes: duplicate signer")
    publics = [bytes(name) for name in signers]
    message = bytes(digest)
    if sim_mac_enabled():
        macs = [bytes(sig) for _, sig in ordered]
        blob = b"".join(m[:32] for m in macs) + _sim_closing(
            message, publics, macs
        )
        return signers, AggregateSignature(blob)
    rs = [bytes(sig)[:32] for _, sig in ordered]
    zs = _coefficients(message, publics, rs)
    s_bar = 0
    for (_, sig), z in zip(ordered, zs):
        s = int.from_bytes(bytes(sig)[32:], "little")
        if s >= _L:
            raise ValueError("aggregate_votes: non-canonical scalar in vote")
        s_bar = (s_bar + z * s) % _L
    blob = b"".join(rs) + s_bar.to_bytes(32, "little")
    return signers, AggregateSignature(blob)


def verify_halfagg(
    message: bytes, publics: Sequence[bytes], blob: bytes
) -> bool:
    """ONE boolean for the whole quorum.  Strict on structure: exact
    blob width for the signer count, canonical s̄ < L, decompressible
    keys and commitments, no duplicate signers — a truncated, padded or
    bit-flipped aggregate is invalid, never a crash."""
    n = len(publics)
    if n == 0 or len(blob) != 32 * (n + 1):
        return False
    publics = [bytes(p) for p in publics]
    if any(len(p) != 32 for p in publics) or len(set(publics)) != n:
        return False
    message = bytes(message)
    if sim_mac_enabled():
        macs = [_sim_mac(p, message) for p in publics]
        for i, mac in enumerate(macs):
            if blob[32 * i : 32 * i + 32] != mac[:32]:
                return False
        return blob[32 * n :] == _sim_closing(message, publics, macs)
    e = _ed25519_py
    s_bar = int.from_bytes(blob[32 * n :], "little")
    if s_bar >= _L:
        return False
    rs = [blob[32 * i : 32 * i + 32] for i in range(n)]
    pairs = []
    for p_enc, r_enc in zip(publics, rs):
        a = e._point_decompress(p_enc)
        r = e._point_decompress(r_enc)
        if a is None or r is None:
            return False
        pairs.append((a, r))
    zs = _coefficients(message, publics, rs)
    terms = []
    for (a, r), z, p_enc, r_enc in zip(pairs, zs, publics, rs):
        h = e._sha512_mod_l(r_enc + p_enc + message)
        terms.append((z, r))
        terms.append((z * h % _L, a))
    return e._point_equal(
        e._point_mul_base(s_bar), e.multi_scalar_mul(terms)
    )


def cert_sig_wire_bytes(
    scheme_name: str, quorum: int, wire_version: int = 2
) -> int:
    """Signature material per certificate frame under a scheme — the
    formula the bench's wire summary derives `cert_sig_bytes_per_cert`
    from (replacing the hardcoded 96·q+64): header signature (64) plus,
    per scheme,

    - ``individual``: q × (key ref + 64-byte vote signature)
    - ``halfagg``:    q key refs + the 32·(q+1) aggregate blob

    Key refs are 1 byte under wire v2 (committee index) and 32 raw bytes
    under the legacy format."""
    if scheme_name not in SCHEMES:
        raise ValueError(
            f"unknown cert-sig scheme {scheme_name!r}; expected one of {SCHEMES}"
        )
    ref = 1 if wire_version == 2 else 32
    if scheme_name == "halfagg":
        return quorum * ref + 32 * (quorum + 1) + 64
    return quorum * (ref + 64) + 64
