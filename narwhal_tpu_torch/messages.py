"""Wire messages of the worker plane and the worker↔primary LAN plane.

Reference enums: `WorkerMessage` (worker/src/worker.rs:36-40),
`PrimaryWorkerMessage` (primary/src/primary.rs:41-47), `WorkerPrimaryMessage`
(primary/src/primary.rs:50-56).  Each plane has its own socket, so tag spaces
are independent.  Encoding: u8 tag + canonical serde body.

The primary↔primary plane (Header/Vote/Certificate) lives in
narwhal_tpu.primary.messages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .crypto import Digest, PublicKey
from .network import wirev2
from .utils.serde import Reader, Writer

Transaction = bytes
Batch = List[Transaction]
Round = int
WorkerId = int


# --- wire-v2 codec context ----------------------------------------------------
#
# The committee roster is the one piece of shared state both ends of
# every connection provably hold (it IS the deployment), so wire v2
# encodes public keys as committee indices: a varint key-ref where 0
# escapes to a literal 32-byte key (unknown/Byzantine-minted keys — the
# wrong_key fault arm — still encode; they just don't compress) and
# v >= 1 names committee member v-1 in sorted-key order, which is
# identical across processes loading the same committee file.  Installed
# at node boot (Primary.spawn / Worker.spawn); encoders fall back to
# literals when no committee is installed, so unit-test roundtrips work
# without one.

_WIRE_KEYS: List[PublicKey] = []
_WIRE_INDEX: Dict[PublicKey, int] = {}


def set_wire_committee(committee) -> None:
    """Install the committee roster as the wire-v2 key-index space."""
    global _WIRE_KEYS, _WIRE_INDEX
    _WIRE_KEYS = [PublicKey(name) for name in sorted(committee.authorities)]
    _WIRE_INDEX = {k: i for i, k in enumerate(_WIRE_KEYS)}


def write_key_ref(w: Writer, key: PublicKey) -> None:
    i = _WIRE_INDEX.get(key)
    if i is None:
        w.uvarint(0)
        w.raw(key)
    else:
        w.uvarint(i + 1)


def read_key_ref(r: Reader) -> PublicKey:
    v = r.uvarint()
    if v == 0:
        return PublicKey(r.raw(32))
    try:
        return _WIRE_KEYS[v - 1]
    except IndexError:
        raise ValueError(
            f"wire key index {v - 1} outside committee "
            f"({len(_WIRE_KEYS)} keys installed)"
        ) from None


def skip_key_ref(r: Reader, spans: List[int]) -> None:
    """Span-walker helper: step over one key-ref, recording a literal
    key's offset as dictionary material."""
    if r.uvarint() == 0:
        spans.append(r.tell())
        r.raw(32)


# --- worker ↔ worker ---------------------------------------------------------

WORKER_BATCH = 0
WORKER_BATCH_REQUEST = 1


def encode_batch(batch: Batch) -> bytes:
    """WorkerMessage::Batch — THE hot serialization path (≈500 kB frames)."""
    w = Writer()
    w.u8(WORKER_BATCH)
    w.u32(len(batch))
    for tx in batch:
        w.bytes(tx)
    return w.finish()


def decode_batch_body(r: Reader) -> Batch:
    n = r.u32()
    return [r.bytes() for _ in range(n)]


def encode_batch_request(digests: List[Digest], requestor: PublicKey) -> bytes:
    w = Writer()
    w.u8(WORKER_BATCH_REQUEST)
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


def decode_worker_message(data: bytes):
    """Returns ("batch", Batch) | ("batch_request", digests, requestor)."""
    r = Reader(data)
    tag = r.u8()
    if tag == WORKER_BATCH:
        batch = decode_batch_body(r)
        r.expect_done()
        return ("batch", batch)
    if tag == WORKER_BATCH_REQUEST:
        if wirev2.enabled():
            n = r.uvarint()
            digests = [Digest(r.raw(32)) for _ in range(n)]
            requestor = read_key_ref(r)
        else:
            n = r.u32()
            digests = [Digest(r.raw(32)) for _ in range(n)]
            requestor = PublicKey(r.raw(32))
        r.expect_done()
        return ("batch_request", digests, requestor)
    raise ValueError(f"unknown WorkerMessage tag {tag}")


# --- primary → worker (LAN) --------------------------------------------------

PW_SYNCHRONIZE = 0
PW_CLEANUP = 1


def encode_synchronize(digests: List[Digest], target: PublicKey) -> bytes:
    w = Writer()
    w.u8(PW_SYNCHRONIZE)
    if wirev2.enabled():
        w.uvarint(len(digests))
        for d in digests:
            w.raw(d)
        write_key_ref(w, target)
    else:
        w.u32(len(digests))
        for d in digests:
            w.raw(d)
        w.raw(target)
    return w.finish()


def encode_cleanup(round: Round) -> bytes:
    w = Writer().u8(PW_CLEANUP)
    if wirev2.enabled():
        w.uvarint(round)
    else:
        w.u64(round)
    return w.finish()


def decode_primary_worker_message(data: bytes):
    """Returns ("synchronize", digests, target) | ("cleanup", round)."""
    r = Reader(data)
    tag = r.u8()
    v2 = wirev2.enabled()
    if tag == PW_SYNCHRONIZE:
        if v2:
            n = r.uvarint()
            digests = [Digest(r.raw(32)) for _ in range(n)]
            target = read_key_ref(r)
        else:
            n = r.u32()
            digests = [Digest(r.raw(32)) for _ in range(n)]
            target = PublicKey(r.raw(32))
        r.expect_done()
        return ("synchronize", digests, target)
    if tag == PW_CLEANUP:
        rnd = r.uvarint() if v2 else r.u64()
        r.expect_done()
        return ("cleanup", rnd)
    raise ValueError(f"unknown PrimaryWorkerMessage tag {tag}")


# --- worker → primary (LAN) --------------------------------------------------

WP_OUR_BATCH = 0
WP_OTHERS_BATCH = 1


@dataclass(frozen=True)
class BatchDigestMessage:
    digest: Digest
    worker_id: WorkerId
    ours: bool


def encode_batch_digest(digest: Digest, worker_id: WorkerId, ours: bool) -> bytes:
    w = Writer()
    w.u8(WP_OUR_BATCH if ours else WP_OTHERS_BATCH)
    w.raw(digest)
    if wirev2.enabled():
        w.uvarint(worker_id)
    else:
        w.u32(worker_id)
    return w.finish()


def decode_worker_primary_message(data: bytes) -> BatchDigestMessage:
    r = Reader(data)
    tag = r.u8()
    if tag not in (WP_OUR_BATCH, WP_OTHERS_BATCH):
        raise ValueError(f"unknown WorkerPrimaryMessage tag {tag}")
    digest = Digest(r.raw(32))
    worker_id = r.uvarint() if wirev2.enabled() else r.u32()
    r.expect_done()
    return BatchDigestMessage(digest, worker_id, tag == WP_OUR_BATCH)


# --- wire-type classification (wire-goodput ledger) --------------------------
#
# Each plane has its own socket and an independent u8 tag space, so a
# frame's message type is (plane, first byte).  The receivers hand their
# plane's classifier to network.Receiver, which accounts every inbound
# frame per type in the metrics WireLedger; senders pass the type
# explicitly at the call site that just encoded the message.  One shared
# name space across planes (a "batch" is a batch whichever socket carried
# it) so the bench's wire section aggregates cleanly.

WORKER_FRAME_TYPES = {
    WORKER_BATCH: "batch",
    WORKER_BATCH_REQUEST: "batch_request",
}

PRIMARY_WORKER_FRAME_TYPES = {
    PW_SYNCHRONIZE: "synchronize",
    PW_CLEANUP: "cleanup",
}

WORKER_PRIMARY_FRAME_TYPES = {
    WP_OUR_BATCH: "batch_digest",
    WP_OTHERS_BATCH: "batch_digest",
}


def frame_classifier(tag_map):
    """A ``bytes -> type-name`` classifier over one plane's tag space
    (unknown/empty frames classify as "unknown", never raise — the
    ledger must account garbage too, the handler rejects it later)."""

    def classify(data: bytes) -> str:
        if not data:
            return "unknown"
        return tag_map.get(data[0], "unknown")

    return classify


# NOTE on span walkers: only the primary↔primary message types register
# wire-v2 digest-span walkers (see primary/messages.py) — theirs is the
# traffic that rides ReliableSender, where per-connection dictionary
# compression runs.  Of this module's types, `batch` also rides
# ReliableSender but deliberately registers no walker (its payload is
# transaction data, owned by the residual-deflate path), and the rest
# (batch_request, synchronize, cleanup, batch_digest) ride SimpleSender,
# whose connections stay on legacy framing: coalesced for the syscall
# win, never dictionary-compressed — walkers here would be dead code.
