"""32-byte digest newtype and the canonical protocol hash.

The reference hashes every protocol message with SHA-512 truncated to 32
bytes (reference worker/src/processor.rs:35, primary/src/messages.rs:70-84).
This framework keeps the 32-byte digest shape but uses **SHA-256**: the
per-batch digest is the worker data plane's hot hash (~100 MB/s of batch
bytes at the reference's local config), SHA-256 has hardware support
(SHA-NI / dedicated units) giving ~2.3× the SHA-512 throughput on the host
cores this runs on, and our canonical serde already makes digests
non-wire-compatible with the Rust reference, so SHA-512 bit-parity buys
nothing.  Security properties (256-bit collision-resistant hash) are
equivalent for the protocol's use.
"""

from __future__ import annotations

import base64
import hashlib

DIGEST_LEN = 32


class Digest(bytes):
    """32-byte content digest. Subclasses bytes: hashable, ordered, compact."""

    __slots__ = ()

    def __new__(cls, b: bytes) -> "Digest":
        if len(b) != DIGEST_LEN:
            raise ValueError(f"Digest must be {DIGEST_LEN} bytes, got {len(b)}")
        return super().__new__(cls, b)

    @classmethod
    def zero(cls) -> "Digest":
        return cls(bytes(DIGEST_LEN))

    def __repr__(self) -> str:  # short base64 like the reference's Debug impl
        return base64.b64encode(self).decode()[:16]


def digest32(data: bytes) -> Digest:
    """The protocol-wide 32-byte hash (see module docstring for why this is
    SHA-256 under the reference-parity name)."""
    return Digest(hashlib.sha256(data).digest())
