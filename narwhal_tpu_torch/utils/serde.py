"""Deterministic binary codec for protocol messages.

The reference serializes every protocol message with bincode (little-endian,
u64 length prefixes) — e.g. reference primary/src/core.rs:129 — and hashes
messages over a field-by-field byte encoding (reference
primary/src/messages.rs:70-84).  We use one deterministic codec for both
purposes: fixed-width little-endian integers, u32 length prefixes (cheaper
than bincode's u64 and sufficient: frames are < 4 GiB), and sorted maps/sets
(BTreeMap/BTreeSet semantics) so that encoding is canonical.
"""

from __future__ import annotations

import struct

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def write_uvarint(buf: bytearray, v: int) -> None:
    """LEB128 into an existing buffer — the one encoder loop shared by
    :meth:`Writer.uvarint` and the wire-v2 op stream builder."""
    if v < 0:
        raise ValueError("uvarint: negative value")
    while v >= 0x80:
        buf.append((v & 0x7F) | 0x80)
        v >>= 7
    buf.append(v)


class Writer:
    """Append-only byte sink."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def u8(self, v: int) -> "Writer":
        self._buf += _U8.pack(v)
        return self

    def u32(self, v: int) -> "Writer":
        self._buf += _U32.pack(v)
        return self

    def u64(self, v: int) -> "Writer":
        self._buf += _U64.pack(v)
        return self

    def uvarint(self, v: int) -> "Writer":
        """Unsigned LEB128 — the wire-v2 width for rounds, counts and
        lengths: protocol integers are tiny (rounds grow by one, counts
        are committee-sized) so the fixed u32/u64 widths of the legacy
        encoding are mostly zero bytes."""
        write_uvarint(self._buf, v)
        return self

    def raw(self, b: bytes) -> "Writer":
        """Fixed-size field; caller guarantees the width (e.g. 32-byte digest)."""
        self._buf += b
        return self

    def bytes(self, b: bytes) -> "Writer":
        """Variable-size field: u32 length prefix + payload."""
        self._buf += _U32.pack(len(b))
        self._buf += b
        return self

    def finish(self) -> bytes:
        return bytes(self._buf)


class Reader:
    """Sequential decoder over a byte buffer."""

    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._pos = 0

    def _take(self, n: int) -> bytes:
        p = self._pos
        if p + n > len(self._buf):
            raise ValueError("serde: buffer underrun")
        self._pos = p + n
        return self._buf[p : p + n]

    def u8(self) -> int:
        return _U8.unpack(self._take(1))[0]

    def u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self._take(8))[0]

    def uvarint(self) -> int:
        """Unsigned LEB128, capped at 64 bits so a hostile frame cannot
        make the decoder build an unbounded integer."""
        result = 0
        shift = 0
        while True:
            b = self._take(1)[0]
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7
            if shift > 63:
                raise ValueError("serde: uvarint exceeds 64 bits")

    def tell(self) -> int:
        """Current decode offset (the wire-v2 digest-span walkers read
        this to record field positions while parsing)."""
        return self._pos

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def bytes(self) -> bytes:
        n = self.u32()
        return self._take(n)

    def done(self) -> bool:
        return self._pos == len(self._buf)

    def expect_done(self) -> None:
        if not self.done():
            raise ValueError(
                f"serde: {len(self._buf) - self._pos} trailing bytes after decode"
            )
