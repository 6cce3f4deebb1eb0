"""What a run leaves on disk, read back in plain Python.

- A store (``<store>/store.log``) is a sequence of records
  ``<u32 key length><u32 value length><key><value>`` (little endian); a
  later record of the same key replaces the earlier one, and a torn tail
  is ignored.
- A worker stores each batch under its digest, SHA-256 of the batch's
  bytes: ``u8 0, u32 count, count × (u32 length, transaction)``.
- A primary stores headers, certificates and empty payload markers; a
  certificate is stored under its digest.  The certificate encoding is
  the wire-v2 one (the node's default): a header (author as a committee
  index + 1, round, payload and parents as LEB128 counts, 32-byte
  digests, the header id and its signature), a scheme byte 0, then the
  votes (LEB128 count, each a committee index + 1 and a signature).
  Committee indices count the authorities sorted by their key bytes.
- Digests print in logs as the first 16 characters of their base64.
"""

from __future__ import annotations

import base64
import hashlib
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_REC = struct.Struct("<II")


def short(digest: bytes) -> str:
    """A digest as the node's logs print it."""
    return base64.b64encode(digest).decode()[:16]


def read_store(path: str) -> List[Tuple[bytes, bytes]]:
    """The records of a store log in the order they were written."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos + _REC.size <= len(data):
        klen, vlen = _REC.unpack_from(data, pos)
        end = pos + _REC.size + klen + vlen
        if end > len(data):
            break
        k = data[pos + _REC.size:pos + _REC.size + klen]
        out.append((k, data[pos + _REC.size + klen:end]))
        pos = end
    return out


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("short record")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def uvarint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")

    def done(self) -> bool:
        return self.pos == len(self.data)


def decode_batch(value: bytes) -> List[bytes]:
    """A worker's stored batch as its list of transactions."""
    r = _Reader(value)
    if r.u8() != 0:
        raise ValueError("not a batch")
    txs = [r.take(r.u32()) for _ in range(r.u32())]
    if not r.done():
        raise ValueError("trailing bytes after a batch")
    return txs


def encode_batch(txs: List[bytes]) -> bytes:
    out = bytearray(b"\x00") + struct.pack("<I", len(txs))
    for tx in txs:
        out += struct.pack("<I", len(tx)) + tx
    return bytes(out)


@dataclass
class Cert:
    """A certificate as stored, with what the reference works out again."""

    author: bytes
    round: int
    payload: Dict[bytes, int]
    parents: List[bytes]
    header_id: bytes
    header_sig: bytes
    votes: List[Tuple[bytes, bytes]] = field(default_factory=list)

    def computed_header_id(self) -> bytes:
        out = bytearray(self.author) + struct.pack("<Q", self.round)
        for d in sorted(self.payload):
            out += d + struct.pack("<I", self.payload[d])
        for p in sorted(self.parents):
            out += p
        return hashlib.sha256(bytes(out)).digest()

    def digest(self) -> bytes:
        """H(header id ‖ round ‖ origin): what every vote signs."""
        return hashlib.sha256(self.header_id + struct.pack("<Q", self.round)
                              + self.author).digest()


def _key_ref(r: _Reader, keys: List[bytes]) -> bytes:
    v = r.uvarint()
    if v == 0:
        return r.take(32)
    if v > len(keys):
        raise ValueError("key index outside the committee")
    return keys[v - 1]


def decode_certificate(value: bytes, keys: List[bytes]) -> Cert:
    """A stored certificate; ``keys`` is the committee sorted by bytes."""
    r = _Reader(value)
    author = _key_ref(r, keys)
    rnd = r.uvarint()
    payload = {}
    for _ in range(r.uvarint()):
        d = r.take(32)
        payload[d] = r.uvarint()
    n_parents = r.uvarint()
    parents = [r.take(32) for _ in range(n_parents)]
    header_id, header_sig = r.take(32), r.take(64)
    if r.u8() != 0:
        raise ValueError("not an individually signed certificate")
    votes = [(_key_ref(r, keys), r.take(64)) for _ in range(r.uvarint())]
    if not r.done():
        raise ValueError("trailing bytes after a certificate")
    return Cert(author, rnd, payload, parents, header_id, header_sig, votes)


def stored_certificates(path: str, keys: List[bytes]) -> List[Cert]:
    """The certificates of a primary's store in the order it first wrote
    them, which is the order its Core handed them to consensus: a record
    whose value decodes as a certificate stored under that certificate's
    digest."""
    out, seen = [], set()
    for key, value in read_store(path):
        if len(key) != 32 or len(value) < 140 or key in seen:
            continue
        try:
            cert = decode_certificate(value, keys)
        except (ValueError, IndexError):
            continue
        if cert.votes and cert.digest() == key:
            seen.add(key)
            out.append(cert)
    return out


def genesis(keys: List[bytes]) -> List[Cert]:
    """Round 0: one unsigned certificate an authority, whose header id is
    all zeros (the node never hashes the genesis headers)."""
    return [Cert(k, 0, {}, [], bytes(32), bytes(64)) for k in keys]


def sample_id(tx: bytes) -> Optional[int]:
    """The id a sample transaction carries (byte 0 is 0), else None."""
    if len(tx) >= 9 and tx[0] == 0:
        return int.from_bytes(tx[1:9], "little")
    return None
