"""ed25519 keys and signatures (CPU reference implementation).

Mirrors reference crypto/src/lib.rs:64-220: `PublicKey`/`SecretKey` newtypes
with base64 serialization, deterministic keygen from a seeded RNG for test
fixtures, and 64-byte signatures.  The CPU implementation rides the
`cryptography` package (OpenSSL ed25519) when installed and falls back to
the dependency-free pure-Python RFC 8032 signer (`_ed25519_py`) otherwise —
same keys, signatures, and verify semantics, just slower per call.  The
batched CUDA verifier lives in `narwhal_tpu_torch.ops.ed25519` behind
`crypto.backend`.
"""

from __future__ import annotations

import base64
import os
from typing import Optional

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.exceptions import InvalidSignature

    _HAVE_OPENSSL = True
except ImportError:  # minimal install: pure-Python fallback
    _HAVE_OPENSSL = False
    import warnings

    # Loud, once, at import: the fallback is correct but ~1000× slower and
    # NOT constant-time (Python big-int scalar muls branch on secret
    # nibbles).  A production image must ship the `cryptography` wheel —
    # this downgrade should be a deliberate choice, never a silent
    # accident of an incomplete build.
    warnings.warn(
        "narwhal_tpu_torch.crypto: the `cryptography` package is not installed; "
        "falling back to the pure-Python ed25519 signer (slow, "
        "non-constant-time — fine for tests/benches, NOT for production "
        "keys)",
        RuntimeWarning,
        stacklevel=2,
    )

import hashlib as _hashlib
import time as _time

from .. import metrics as _metrics
from . import _ed25519_py
from .digest import Digest

# -- simulation MAC mode ------------------------------------------------------
#
# The deterministic simulation harness (narwhal_tpu/sim) replaces ed25519
# sign/verify with a keyed hash: sig = SHA-512(public_key ‖ message)[:64].
# Protocol-visible semantics are preserved — a signature only verifies
# against the key it was minted under, so the wrong_key Byzantine
# behavior still reads as invalid, twins stay validly signed, and every
# frame keeps its real wire size — but one op costs ~2 µs instead of the
# ~1-4 ms of the pure-Python fallback, which is what lets an N=20/50
# committee execute 60 virtual seconds in single-digit wall seconds.
# NOT a signature scheme (anyone holding the public key can forge);
# never enabled outside the sim harness, which brackets every run with
# set_sim_mac(True/False).

_SIM_MAC = False


def set_sim_mac(enabled: bool) -> None:
    global _SIM_MAC
    _SIM_MAC = bool(enabled)


def sim_mac_enabled() -> bool:
    return _SIM_MAC


def _sim_mac(public: bytes, message: bytes) -> bytes:
    return _hashlib.sha512(bytes(public) + bytes(message)).digest()[:64]

# Crypto-cost ledger, signing side: op counts and wall time per call
# site ("header" / "vote" via SignatureService, "other" for direct
# callers).  Memoized like the verify-side instruments in backend.py.
_sign_instruments_cache: dict = {}


def _sign_instruments(site: str):
    inst = _sign_instruments_cache.get(site)
    if inst is None:
        inst = _sign_instruments_cache[site] = (
            _metrics.counter(f"crypto.sign.ops.{site}"),
            _metrics.histogram(f"crypto.sign.seconds.{site}"),
        )
    return inst


class PublicKey(bytes):
    """32-byte ed25519 public key."""

    __slots__ = ()

    def __new__(cls, b: bytes) -> "PublicKey":
        if len(b) != 32:
            raise ValueError(f"PublicKey must be 32 bytes, got {len(b)}")
        return super().__new__(cls, b)

    @classmethod
    def default(cls) -> "PublicKey":
        return cls(bytes(32))

    def encode_base64(self) -> str:
        return base64.b64encode(self).decode()

    @classmethod
    def decode_base64(cls, s: str) -> "PublicKey":
        return cls(base64.b64decode(s))

    def __repr__(self) -> str:
        return self.encode_base64()[:16]


class SecretKey(bytes):
    """32-byte ed25519 secret seed."""

    __slots__ = ()

    def __new__(cls, b: bytes) -> "SecretKey":
        if len(b) != 32:
            raise ValueError(f"SecretKey must be 32 bytes, got {len(b)}")
        return super().__new__(cls, b)

    def encode_base64(self) -> str:
        return base64.b64encode(self).decode()

    @classmethod
    def decode_base64(cls, s: str) -> "SecretKey":
        return cls(base64.b64decode(s))


class Signature(bytes):
    """64-byte ed25519 signature (R || S)."""

    __slots__ = ()

    def __new__(cls, b: bytes) -> "Signature":
        if len(b) != 64:
            raise ValueError(f"Signature must be 64 bytes, got {len(b)}")
        return super().__new__(cls, b)

    @classmethod
    def default(cls) -> "Signature":
        # An all-zero signature (never valid); used for unsigned placeholders
        # the way the reference uses Signature::default() in tests.
        return cls(bytes(64))

    def encode_base64(self) -> str:
        return base64.b64encode(self).decode()


class KeyPair:
    """An ed25519 identity: public name + secret seed.

    Reference config/src/lib.rs:249-271 (KeyPair with JSON import/export).
    """

    __slots__ = ("name", "secret", "_sk", "_py_expanded")

    def __init__(self, name: PublicKey, secret: SecretKey) -> None:
        self.name = name
        self.secret = secret
        if _HAVE_OPENSSL:
            self._sk = Ed25519PrivateKey.from_private_bytes(secret)
        else:
            self._sk = None
            # Cache the expanded scalar/prefix: repeated fallback signing
            # then costs one base multiplication per call, not two.
            a, prefix = _ed25519_py._secret_expand(bytes(secret))
            self._py_expanded = (a, prefix, bytes(name))

    @classmethod
    def generate(cls, rng_seed: Optional[bytes] = None) -> "KeyPair":
        """Generate a keypair; pass a 32-byte seed for deterministic fixtures
        (the reference tests seed StdRng with [0;32],
        reference primary/src/tests/common.rs:29-32)."""
        if rng_seed is None:
            seed = os.urandom(32)
        elif len(rng_seed) != 32:
            raise ValueError("seed must be 32 bytes")
        else:
            seed = rng_seed
        if _HAVE_OPENSSL:
            sk = Ed25519PrivateKey.from_private_bytes(seed)
            pk = sk.public_key().public_bytes_raw()
        else:
            pk = _ed25519_py.secret_to_public(seed)
        return cls(PublicKey(pk), SecretKey(seed))

    def sign(self, digest: Digest, site: str = "other") -> Signature:
        ops, secs = _sign_instruments(site)
        t0 = _time.perf_counter()
        try:
            if _SIM_MAC:
                return Signature(_sim_mac(self.name, bytes(digest)))
            if self._sk is not None:
                return Signature(self._sk.sign(bytes(digest)))
            a, prefix, pub = self._py_expanded
            return Signature(
                _ed25519_py.sign_expanded(a, prefix, pub, bytes(digest))
            )
        finally:
            ops.inc()
            secs.observe(_time.perf_counter() - t0)

    # --- JSON file import/export (reference config/src/lib.rs:28-56) ---

    def to_json(self) -> dict:
        return {"name": self.name.encode_base64(), "secret": self.secret.encode_base64()}

    @classmethod
    def from_json(cls, obj: dict) -> "KeyPair":
        return cls(
            PublicKey.decode_base64(obj["name"]),
            SecretKey.decode_base64(obj["secret"]),
        )


def cpu_verify(message: bytes, key: PublicKey, signature: Signature) -> bool:
    """Single strict-ish verification via OpenSSL (pure-Python RFC 8032
    fallback when the `cryptography` package is absent)."""
    if _SIM_MAC:
        return _sim_mac(key, message) == bytes(signature)
    if not _HAVE_OPENSSL:
        return _ed25519_py.verify(bytes(key), bytes(message), bytes(signature))
    try:
        Ed25519PublicKey.from_public_bytes(bytes(key)).verify(
            bytes(signature), bytes(message)
        )
        return True
    except (InvalidSignature, ValueError):
        return False
