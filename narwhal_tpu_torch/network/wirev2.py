"""Wire-format v2: the per-connection compression layer of the goodput
overhaul (ROADMAP item 5).

A wire ledger measured goodput_ratio 0.24 — three of every four
wire bytes were protocol overhead — and a profile found the
one-syscall-per-frame socket path costing as much committee CPU as the
ed25519 fallback itself.  Wire v2 attacks both, behind ONE flag
(``NARWHAL_WIRE_V2``, default on; ``=0`` is the byte-identical legacy
arm the paired A/B runs against):

- **frame coalescing** lives in ReliableSender/Receiver (one
  ``writer.write`` + one ``drain()`` per wakeup; ACK replies batch the
  same way) — this module only carries the shared flag;
- **digest-reference compression** (this module): a per-connection
  sender/receiver dictionary replaces repeated 32-byte digest/key spans
  with small back-references.  The sender decides which spans are
  dictionary material (schema-registered walkers, see
  :func:`register_spans`) and tells the receiver explicitly via ADD ops,
  so the decoder needs NO schema: decode is a pure, lossless transform
  whatever the walkers said.  Dictionaries are connection state — reset
  on reconnect on both sides, so a retransmitted frame re-encodes
  against a fresh dictionary and stale references cannot survive a
  connection flap;
- **transparent residual deflate**: after digest patching, large
  residuals (batch frames — 98.8% of all measured wire bytes) are
  deflate-compressed when that actually shrinks them, with a raw
  escape so incompressible payloads cost one tag byte, never an
  expansion.

Compressed-frame anatomy (the payload of one length-delimited frame on
a negotiated v2 connection)::

    0xF2 | uvarint n_ops | (uvarint gap, uvarint ref)* | residual
    0xF3 | uvarint n_ops | (uvarint gap, uvarint ref)* | deflate(residual)

``gap`` is the count of residual bytes copied before the op; ``ref=0``
is ADD (the next 32 residual bytes are a span — insert into the
dictionary on both sides), ``ref>=1`` references the dictionary entry
of age ``ref-1`` (0 = most recently added).  Anything malformed — bad
tag, out-of-range reference, truncated ops, oversized inflate — is a
typed :class:`~narwhal_tpu.network.framing.FrameError`: the receiver
counts it into ``wire.in.*`` and kills the connection (a corrupt
reference means the dictionaries may have diverged; reconnect resets
both sides).

Version negotiation is the first frame of a connection: a v2 sender
writes :data:`HELLO` before anything else; a v2 receiver that sees it
switches that connection to v2 decode (and never dispatches it).  The
flag is committee-wide — mixed-version committees are not supported
(README "Wire format v2").  SimpleSender connections never send HELLO
and stay on legacy framing; the in-memory sim transport moves frames
without a byte layer, so only the compact message encodings (the other
half of wire v2, in the ``messages`` modules) apply there.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional

from .. import metrics
from ..utils.env import env_flag
from ..utils.serde import write_uvarint as _uvarint
from .framing import MAX_FRAME, FrameError

# First frame of every v2 ReliableSender connection.  0xF1 collides with
# no plane's tag space (all real tags are < 0x10), so a legacy receiver
# classifies it "unknown" and drops it — visible, not corrupting.
HELLO = b"\xf1NW2\x01"

TAG_PLAIN = 0xF2
TAG_DEFLATE = 0xF3

# Dictionary capacity per connection direction.  Bounded so a long-lived
# connection cannot grow without limit; 512 spans cover several rounds
# of parents/payload digests and the whole committee's keys at N=50.
DICT_CAP = 512

# Residuals below this skip the deflate attempt: control frames are
# already compact post-patching and zlib's header would eat the gain.
_DEFLATE_MIN = 1024
_DEFLATE_LEVEL = 1

_m_dict_hits = metrics.counter("net.wirev2.dict_hits")
_m_deflated = metrics.counter("net.wirev2.deflated_frames")

# Which wire format this process speaks, for the bench summary's
# format-aware arithmetic (cert signature fraction) and the A/B
# artifact's arm labelling.
metrics.gauge_fn(
    "wire.format_version", lambda: 2.0 if enabled() else 1.0
)

_ENABLED_OVERRIDE: Optional[bool] = None
_ENABLED_CACHE: Optional[bool] = None


def enabled() -> bool:
    """The process-wide wire-v2 flag (``NARWHAL_WIRE_V2``, default on).
    Read once per process — the format must not change under live
    connections — unless a test overrides it via :func:`set_enabled`."""
    global _ENABLED_CACHE
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    if _ENABLED_CACHE is None:
        _ENABLED_CACHE = env_flag("NARWHAL_WIRE_V2")
    return _ENABLED_CACHE


def set_enabled(value: Optional[bool]) -> None:
    """Test/A-B override: True/False forces the arm, None re-reads the
    environment on next use."""
    global _ENABLED_OVERRIDE, _ENABLED_CACHE
    _ENABLED_OVERRIDE = value
    _ENABLED_CACHE = None


def enabled_override() -> Optional[bool]:
    """The current override (None = following the environment) — for
    callers that need to scope a temporary arm switch without
    clobbering an outer override (the audit replay's arm sniffing)."""
    return _ENABLED_OVERRIDE


class DigestDict:
    """One connection direction's bounded span dictionary.

    Insertion-ordered ring of ``cap`` 32-byte spans, oldest evicted.
    References are AGES (0 = most recently added): both sides apply
    identical ADDs in identical frame order over an ordered byte stream,
    so ages agree at every decode instant without any agreement
    protocol.  Encoder and decoder share this one class so the two
    sides' eviction arithmetic can never drift.
    """

    __slots__ = ("cap", "slots", "serial_of", "count")

    def __init__(self, cap: int = DICT_CAP) -> None:
        self.cap = cap
        self.slots: List[bytes] = []  # ring, slot = serial % cap
        self.serial_of: Dict[bytes, int] = {}  # span -> insertion serial
        self.count = 0  # total inserts ever

    def add(self, span: bytes) -> None:
        slot = self.count % self.cap
        if self.count >= self.cap:
            evicted = self.slots[slot]
            if self.serial_of.get(evicted) == self.count - self.cap:
                del self.serial_of[evicted]
            self.slots[slot] = span
        else:
            self.slots.append(span)
        self.serial_of[span] = self.count
        self.count += 1

    def ref_for(self, span: bytes) -> Optional[int]:
        """Age of ``span`` if it is still resident, else None."""
        serial = self.serial_of.get(span)
        if serial is None:
            return None
        age = self.count - 1 - serial
        return age if age < self.cap else None

    def get(self, age: int) -> bytes:
        """The span of ``age``; FrameError on an out-of-range reference
        (the typed corrupt-frame signal the receiver counts)."""
        if age < 0 or age >= min(self.count, self.cap):
            raise FrameError(
                f"digest reference age {age} outside dictionary "
                f"({min(self.count, self.cap)} entries)"
            )
        return self.slots[(self.count - 1 - age) % self.cap]


# --- span registry -----------------------------------------------------------
#
# msg_type (the wire-ledger label the sender already passes) -> walker
# returning the byte offsets of the frame's 32-byte dictionary-material
# spans (digests, public keys).  Registered by the messages modules next
# to their encoders.  Walkers are best-effort: compression correctness
# NEVER depends on them (ADD/REF ops are explicit in the wire format) —
# a wrong or failing walker only costs compression ratio, so any parse
# error degrades to "no spans".

_SPAN_FNS: Dict[str, Callable[[bytes], List[int]]] = {}


def register_spans(msg_type: str, fn: Callable[[bytes], List[int]]) -> None:
    _SPAN_FNS[msg_type] = fn


def spans_for(msg_type: str, data: bytes) -> List[int]:
    fn = _SPAN_FNS.get(msg_type)
    if fn is None:
        return []
    try:
        spans = fn(data)
    except Exception:
        return []
    # Sanitize: sorted, in-bounds, non-overlapping — compress() trusts
    # this shape.
    out: List[int] = []
    last_end = 0
    for off in sorted(spans):
        if off < last_end or off + 32 > len(data):
            continue
        out.append(off)
        last_end = off + 32
    return out


def _read_uvarint(data: bytes, pos: int) -> tuple:
    result = 0
    shift = 0
    n = len(data)
    while True:
        if pos >= n:
            raise FrameError("truncated varint in compressed frame")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise FrameError("oversized varint in compressed frame")


# Deflate memo for span-free frames (their compressed form is
# connection-independent): a batch broadcast deflates once, not once per
# peer.  Bounded FIFO — broadcast fan-out reuses entries within
# microseconds, so a small cap suffices.
_DEFLATE_MEMO: Dict[bytes, bytes] = {}
_DEFLATE_MEMO_CAP = 64


def _deflate(residual: bytes) -> Optional[bytes]:
    """Deflated residual when that actually helps, else None."""
    if len(residual) < _DEFLATE_MIN:
        return None
    packed = zlib.compress(residual, _DEFLATE_LEVEL)
    # Require a real win (>= 1/8 saved): borderline frames keep the raw
    # path so the receiver never inflates for nothing.
    if len(packed) + (len(residual) >> 3) >= len(residual):
        return None
    return packed


def compress(data: bytes, msg_type: str, enc: DigestDict) -> bytes:
    """One frame -> its v2 compressed payload, updating ``enc`` exactly
    as the receiver's dictionary will be updated on decode."""
    spans = spans_for(msg_type, data)
    if not spans:
        memo = _DEFLATE_MEMO.get(data)
        if memo is not None:
            return memo
    ops = bytearray()
    residual = bytearray()
    pos = 0
    n_ops = 0
    for off in spans:
        span = data[off:off + 32]
        ref = enc.ref_for(span)
        _uvarint(ops, off - pos)
        residual += data[pos:off]
        if ref is not None:
            _uvarint(ops, ref + 1)
            _m_dict_hits.inc()
        else:
            ops.append(0)
            residual += span
            enc.add(span)
        pos = off + 32
        n_ops += 1
    residual += data[pos:]
    packed = _deflate(bytes(residual))
    head = bytearray()
    if packed is not None:
        head.append(TAG_DEFLATE)
        _uvarint(head, n_ops)
        out = bytes(head) + bytes(ops) + packed
        _m_deflated.inc()
    else:
        head.append(TAG_PLAIN)
        _uvarint(head, n_ops)
        out = bytes(head) + bytes(ops) + bytes(residual)
    if not spans:
        if len(_DEFLATE_MEMO) >= _DEFLATE_MEMO_CAP:
            _DEFLATE_MEMO.clear()
        _DEFLATE_MEMO[data] = out
    return out


def decompress(payload: bytes, dec: DigestDict) -> bytes:
    """One v2 compressed payload -> the original frame bytes, updating
    ``dec``.  Raises FrameError on anything malformed."""
    if not payload:
        raise FrameError("empty v2 frame")
    tag = payload[0]
    if tag not in (TAG_PLAIN, TAG_DEFLATE):
        raise FrameError(f"bad v2 frame tag 0x{tag:02x}")
    n_ops, pos = _read_uvarint(payload, 1)
    if n_ops > MAX_FRAME // 32:
        raise FrameError(f"v2 frame claims {n_ops} ops")
    ops = []
    for _ in range(n_ops):
        gap, pos = _read_uvarint(payload, pos)
        ref, pos = _read_uvarint(payload, pos)
        ops.append((gap, ref))
    residual = payload[pos:]
    if tag == TAG_DEFLATE:
        d = zlib.decompressobj()
        try:
            residual = d.decompress(residual, MAX_FRAME + 1)
        except zlib.error as e:
            raise FrameError(f"corrupt deflate residual: {e}") from None
        if len(residual) > MAX_FRAME or d.unconsumed_tail:
            raise FrameError("inflated residual exceeds frame cap")
    out = bytearray()
    rpos = 0
    for gap, ref in ops:
        if rpos + gap > len(residual):
            raise FrameError("gap overruns residual")
        out += residual[rpos:rpos + gap]
        rpos += gap
        if ref == 0:  # ADD: next 32 residual bytes are the span
            if rpos + 32 > len(residual):
                raise FrameError("ADD op overruns residual")
            span = bytes(residual[rpos:rpos + 32])
            rpos += 32
            out += span
            dec.add(span)
        else:
            out += dec.get(ref - 1)
        if len(out) > MAX_FRAME:
            raise FrameError("decompressed frame exceeds cap")
    out += residual[rpos:]
    if len(out) > MAX_FRAME:
        raise FrameError("decompressed frame exceeds cap")
    return bytes(out)
