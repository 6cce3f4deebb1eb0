"""At-least-once sender with per-message delivery futures.

Reference network/src/reliable_sender.rs (248 LoC): every `send` returns a
`CancelHandler` — a future that resolves when the peer ACKs the message.
Un-ACKed messages are retransmitted across reconnects with exponential
backoff (200 ms ×2, capped 60 s; reliable_sender.rs:119,141-181), and the
caller abandons delivery by cancelling the future (dropping the handler,
reliable_sender.rs:193-197).  Quorum counting (QuorumWaiter, vote gathering)
is built directly on these futures.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import logging
import random
import weakref
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .. import metrics
from ..faults import netem as _netem
from ..utils.clock import wall_now
from ..utils.env import env_raw
from ..utils.tasks import spawn
from . import transport as _transport
from . import wirev2
from .clocksync import parse_ack, record_ack_sample
from .framing import (
    MAX_FRAME,
    STREAM_LIMIT,
    frame,
    parse_address,
    read_frame,
    sample_peers,
    tune_writer,
    write_frame,
)

log = logging.getLogger("narwhal.network")

_BACKOFF_START = 0.2
_BACKOFF_CAP_DEFAULT = 60.0

# How long connect failures against a NEVER-connected peer stay off the
# health gauge (boot stagger ≠ dead validator; see _Connection).  Well
# past any observed committee boot spread — wait_for_boot's own deadline
# is 60 s — and short enough that a validator already dead at our start
# is still named within the first minute.
_NEVER_CONNECTED_GRACE_S = 45.0


@functools.lru_cache(maxsize=8)
def _parse_backoff_cap(raw: str) -> float:
    # Memoized per raw value: backoff_cap() runs once per reconnect
    # attempt per peer, and a misconfigured value must not warn at retry
    # frequency forever.
    try:
        return max(_BACKOFF_START, float(raw))
    except ValueError:
        log.warning(
            "NARWHAL_NET_BACKOFF_MAX_S=%r is not a number; using %s s",
            raw, _BACKOFF_CAP_DEFAULT,
        )
        return _BACKOFF_CAP_DEFAULT


def backoff_cap() -> float:
    """Reconnect-backoff ceiling in seconds, env-tunable via
    ``NARWHAL_NET_BACKOFF_MAX_S``.  A 60 s ceiling is right for a dead
    peer but wrong for a short partition: every sender that backed off to
    the cap takes up to a minute to notice the heal.  Fault scenarios
    (and latency-sensitive deployments) lower it."""
    raw = env_raw("NARWHAL_NET_BACKOFF_MAX_S")
    if raw is None:
        return _BACKOFF_CAP_DEFAULT
    return _parse_backoff_cap(raw)


def next_backoff(
    delay: float,
    cap: Optional[float] = None,
    rng: random.Random = random,  # type: ignore[assignment]
) -> Tuple[float, float]:
    """One step of the reconnect schedule: ``(sleep_s, next_delay)``.

    The sleep is the current delay with 50-100% jitter applied — without
    it, every peer partitioned at the same instant retries in lockstep
    and thundering-herds the healed peer's accept queue forever (their
    backoff clocks stay phase-locked).  The next delay doubles toward the
    cap; the cap bounds the delay BEFORE jitter, so the worst-case sleep
    is exactly ``cap``."""
    cap = backoff_cap() if cap is None else cap
    delay = min(delay, cap)
    sleep = delay * (0.5 + 0.5 * rng.random())
    return sleep, min(delay * 2, cap)

class _Msg:
    """One queued message, across its whole delivery lifecycle (buffer →
    pending → possibly re-buffered after a lost connection).

    ``accounted`` tracks whether a COMPLETED write of this frame has
    already been charged to the wire ledger's per-type first-transmission
    counters: the first completed write is the protocol's cost, every
    later completed write is a retransmission (separate counters, so
    per-type protocol bytes are never inflated by link flaps — and a
    frame whose first write attempt died mid-stream still gets exactly
    one first-transmission count when it finally lands).  ``t0`` is the
    write timestamp while pending, for the per-peer ACK-RTT histogram;
    ``t0_wall`` is the same instant on the wall clock, paired with the
    peer's stamped ACK for the clock-offset estimator (clocksync).
    """

    __slots__ = ("data", "fut", "msg_type", "accounted", "t0", "t0_wall")

    def __init__(self, data: bytes, fut: asyncio.Future, msg_type: str):
        self.data = data
        self.fut = fut
        self.msg_type = msg_type
        self.accounted = False
        self.t0 = 0.0
        self.t0_wall = 0.0

# Counters are shared by every ReliableSender in the process (one registry
# per process); the per-peer detail below disaggregates when needed.
_m_frames = metrics.counter("net.reliable.frames_sent")
_m_bytes = metrics.counter("net.reliable.bytes_sent")
_m_retrans = metrics.counter("net.reliable.retransmissions")
_m_connect_fail = metrics.counter("net.reliable.connect_failures")
_m_acks = metrics.counter("net.reliable.acks_received")

# Wire-v2 coalescing instruments: one `flush` = one writer.write +
# drain() covering every frame the per-connection buffer held at wakeup
# (the Store.flush_deferred pattern applied to the socket).  The
# histogram is the acceptance series — mean frames_per_flush > 1 IS the
# syscall batching, measured, not inferred.
_m_flushes = metrics.counter("wire.out.flushes")
_h_frames_per_flush = metrics.histogram("wire.out.frames_per_flush")

# One flush is bounded so a deep backlog cannot turn into an unbounded
# buffered write (latency + memory): past this many payload bytes the
# loop writes, drains, and immediately continues on the remainder.
_FLUSH_MAX_BYTES = 1 << 20

# Worst-case growth of a v2 container over its raw frame (tag + op
# stream for every span a walker could legitimately yield); messages
# within this distance of MAX_FRAME are refused on the v2 path rather
# than risking a frame the receiver's cap would reject.
_V2_HEADROOM = 64 * 1024

# Live senders, for snapshot-time gauges: total un-ACKed backlog and how
# many peer connections are currently in reconnect backoff.  WeakSet so a
# closed sender's state stops being reported once collected.
_SENDERS: "weakref.WeakSet[ReliableSender]" = weakref.WeakSet()


def _connections():
    for sender in _SENDERS:
        yield from sender._connections.values()


metrics.gauge_fn(
    "net.reliable.pending_acks",
    lambda: sum(len(c.pending) + len(c.buffer) for c in _connections()),
)
metrics.gauge_fn(
    "net.reliable.peers_backing_off",
    lambda: sum(1 for c in _connections() if c.backing_off),
)
metrics.detail_fn(
    "net.reliable.pending_by_peer",
    lambda: {
        c.address: len(c.pending) + len(c.buffer)
        for c in _connections()
        if c.pending or c.buffer
    },
)


def _peer_instruments(address: str):
    """Per-peer instruments, memoized by name in the process registry so
    every sender talking to the same peer shares them.  These are what
    lets a health rule (or a human) name WHICH validator is slow:

    - ``net.reliable.peer.rtt_seconds.<addr>`` — ACK round-trip
      histogram (write → ACK, so it includes the peer's validation);
    - ``net.reliable.peer.retransmissions.<addr>`` — counter;
    - ``net.reliable.peer.consecutive_failures.<addr>`` — gauge, reset
      to 0 on a successful connect and reported only once the peer has
      accepted at least one connection or the boot-grace window has
      passed (boot-stagger must not read as a dead validator; the
      peer_unreachable rule's input);
    - ``net.reliable.peer.backing_off.<addr>`` — 0/1 gauge.
    """
    return (
        metrics.histogram(f"net.reliable.peer.rtt_seconds.{address}"),
        metrics.counter(f"net.reliable.peer.retransmissions.{address}"),
        metrics.gauge(f"net.reliable.peer.consecutive_failures.{address}"),
        metrics.gauge(f"net.reliable.peer.backing_off.{address}"),
    )


class _Connection:
    """Owns the channel to one peer: buffered retransmission until ACK.

    Invariants that delivery semantics rest on:
    - an item sits in exactly one of `buffer` (not yet written this
      connection) or `pending` (written, awaiting ACK) until its future is
      resolved or cancelled;
    - the peer ACKs frames in order, so each ACK consumes exactly one
      `pending` entry (cancelled entries included — their frame was written).
    """

    def __init__(self, address: str) -> None:
        self.address = address
        self.buffer: Deque[_Msg] = collections.deque()
        self.pending: Deque[_Msg] = collections.deque()
        self.wakeup = asyncio.Event()
        self.backing_off = False  # reconnect backoff state (metrics gauge)
        self.failures = 0  # consecutive connect failures (health rule input)
        # Whether this peer has EVER accepted a connection: failures are
        # reported to the health plane only after it has (or after the
        # boot-grace window below) — a committee boots staggered, and a
        # peer that simply hasn't bound its socket yet is
        # indistinguishable from our own early start.  Without the gate,
        # a slow boot under a low reconnect-backoff cap crosses the
        # peer_unreachable threshold and the latched FIRING event poisons
        # the run's anomaly record (caught by a fuzzed scenario's CLEAN
        # control arm firing peer_unreachable at boot).  A peer that dies
        # later was necessarily connected once, so real deaths still fire
        # within one evaluation interval.
        self.ever_connected = False
        self.created = asyncio.get_running_loop().time()
        (
            self._m_rtt,
            self._m_peer_retrans,
            self._g_failures,
            self._g_backoff,
        ) = _peer_instruments(address)
        self.task = spawn(self._keep_alive(), name="reliable-sender-conn")

    def push(self, data: bytes, fut: asyncio.Future, msg_type: str) -> None:
        self.buffer.append(_Msg(data, fut, msg_type))
        self.wakeup.set()

    def abort_all(self) -> None:
        """Fail every outstanding delivery (sender shutdown)."""
        for item in list(self.pending) + list(self.buffer):
            if not item.fut.done():
                item.fut.cancel()
        self.pending.clear()
        self.buffer.clear()

    def _requeue_pending(self) -> None:
        """Move un-ACKed items back to the front of the buffer, oldest first,
        dropping messages whose caller gave up (cancelled future)."""
        while self.pending:
            item = self.pending.pop()
            if not item.fut.cancelled():
                self.buffer.appendleft(item)
                # Written once, un-ACKed, will be written again: that is a
                # retransmission, the signal a flapping/slow peer leaves.
                _m_retrans.inc()
                self._m_peer_retrans.inc()

    async def _keep_alive(self) -> None:
        host, port = parse_address(self.address)
        delay = _BACKOFF_START
        try:
            while True:
                try:
                    # Fault-injection partition shim: a partitioned peer
                    # fails exactly like a dead host, through the same
                    # backoff/health accounting below.
                    if _netem.blocked(self.address):
                        raise OSError("netem: partitioned from peer")
                    reader, writer = await asyncio.open_connection(
                        host, port, limit=STREAM_LIMIT
                    )
                    tune_writer(writer)
                    reader, writer = _netem.wrap(self.address, reader, writer)
                except OSError as e:
                    log.debug("ReliableSender: cannot reach %s: %s", self.address, e)
                    _m_connect_fail.inc()
                    self.backing_off = True
                    self.failures += 1
                    # Boot-grace only, never a permanent blind spot: a
                    # peer that is ALREADY dead when this process starts
                    # (e.g. we restarted while it stayed down) was never
                    # connected, yet must still be reported once the
                    # stagger window has safely passed.
                    if self.ever_connected or (
                        asyncio.get_running_loop().time() - self.created
                        > _NEVER_CONNECTED_GRACE_S
                    ):
                        self._g_failures.set(self.failures)
                    self._g_backoff.set(1)
                    sleep_s, delay = next_backoff(delay)
                    await asyncio.sleep(sleep_s)
                    continue
                delay = _BACKOFF_START
                self.backing_off = False
                self.ever_connected = True
                self.failures = 0
                self._g_failures.set(0)
                self._g_backoff.set(0)
                try:
                    await self._exchange(reader, writer)
                except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
                    log.debug("ReliableSender: lost %s: %s", self.address, e)
                finally:
                    writer.close()
                    self._requeue_pending()
        finally:
            self._requeue_pending()

    async def _exchange(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Pipeline writes from the buffer; match ACK frames FIFO."""

        loop = asyncio.get_running_loop()
        v2 = wirev2.enabled()

        async def write_loop() -> None:
            # Wire v2: announce the format, then speak compressed frames
            # against a dictionary that lives and dies with THIS
            # connection (reconnect = fresh dictionaries on both sides,
            # so retransmitted frames re-encode and stale references
            # cannot survive a flap).  The HELLO is not a protocol
            # message: never in `pending`, never ACKed.
            enc_dict = None
            if v2:
                enc_dict = wirev2.DigestDict()
                writer.write(frame(wirev2.HELLO))
                await writer.drain()
                _m_bytes.inc(len(wirev2.HELLO))
                metrics.wire_account(
                    "out", "wire_hello", self.address, len(wirev2.HELLO)
                )
            while True:
                while self.buffer:
                    if not v2:
                        # Legacy arm: byte- and syscall-identical to the
                        # pre-v2 sender (one write_frame + drain per
                        # message) — the paired A/B's baseline.
                        item = self.buffer.popleft()
                        if item.fut.cancelled():
                            continue
                        # Into `pending` BEFORE the await: if the write
                        # (or this task) dies mid-frame, reconnect
                        # retransmits it rather than losing the message
                        # and wedging its future.
                        item.t0 = loop.time()
                        item.t0_wall = wall_now()
                        self.pending.append(item)
                        # lint: allow-interleave(_requeue_pending only runs after _exchange's finally has cancelled AND awaited this task — "let cancellation unwind so neither loop touches the deques after we return" — so the buffer/pending writes it performs can never interleave with this suspended frame write; read_loop only popleft()s entries this loop appended before the suspension, which is exactly the ACK-FIFO contract)
                        await write_frame(writer, item.data)
                        # Counted after the write returns (same
                        # convention as SimpleSender): a frame lost to a
                        # mid-write disconnect is not "sent" — its
                        # rewrite after reconnect is.
                        _m_frames.inc()
                        _m_bytes.inc(len(item.data))
                        metrics.wire_account(
                            "out", item.msg_type, self.address,
                            len(item.data), retransmit=item.accounted,
                        )
                        item.accounted = True
                        continue
                    # v2: drain the WHOLE buffer into one multi-frame
                    # write + a single drain().  Everything is staged in
                    # `pending` before the await, and NOTHING is
                    # accounted until the drain returns: a flush that
                    # dies mid-stream charges zero first-transmission
                    # bytes, and the eventual rewrite of each frame is
                    # its (single) first transmission — the _Msg
                    # accounting rules hold exactly, per frame, inside a
                    # coalesced flush.
                    blob = bytearray()
                    wrote = []
                    while self.buffer and len(blob) < _FLUSH_MAX_BYTES:
                        item = self.buffer.popleft()
                        if item.fut.cancelled():
                            continue
                        if len(item.data) > MAX_FRAME - _V2_HEADROOM:
                            # An incompressible payload hugging the cap
                            # could grow past MAX_FRAME under the
                            # container overhead; the receiver would
                            # reject it, killing the connection and
                            # retransmitting the same poison frame
                            # forever.  Rejected BEFORE compress() so
                            # the dictionary is never mutated by a
                            # frame the receiver won't see.
                            if not item.fut.done():
                                item.fut.set_exception(
                                    ValueError(
                                        f"message of {len(item.data)} "
                                        "bytes cannot ride a v2 frame "
                                        "within MAX_FRAME"
                                    )
                                )
                            continue
                        payload = wirev2.compress(
                            item.data, item.msg_type, enc_dict
                        )
                        item.t0 = loop.time()
                        item.t0_wall = wall_now()
                        self.pending.append(item)
                        blob += frame(payload)
                        wrote.append((item, len(payload)))
                    if not wrote:
                        continue
                    writer.write(bytes(blob))
                    await writer.drain()
                    _m_flushes.inc()
                    _h_frames_per_flush.observe(len(wrote))
                    for item, nbytes in wrote:
                        _m_frames.inc()
                        _m_bytes.inc(nbytes)
                        metrics.wire_account(
                            "out", item.msg_type, self.address, nbytes,
                            retransmit=item.accounted,
                            raw_nbytes=len(item.data),
                        )
                        item.accounted = True
                self.wakeup.clear()
                await self.wakeup.wait()
                if v2:
                    # Micro-batch: one zero-delay yield before draining.
                    # Everything already scheduled in this event-loop
                    # pass (a burst being processed, a broadcast loop,
                    # peers' frames just read) gets to push into the
                    # buffer first, so the burst leaves as ONE flush.
                    # Costs one ready-queue rotation — no timer, no
                    # measurable latency — and is the difference between
                    # frames_per_flush ~1 and the batched regime under
                    # load.
                    await asyncio.sleep(0)

        async def read_loop() -> None:
            while True:
                ack = await read_frame(reader)
                _m_acks.inc()
                # Exactly one pending entry per ACK frame — the peer ACKs
                # everything we wrote, including since-cancelled messages.
                if self.pending:
                    item = self.pending.popleft()
                    self._m_rtt.observe(loop.time() - item.t0)
                    # Stamped ACK → one NTP-style offset sample for this
                    # peer (legacy bare b"Ack" parses to None: mixed
                    # committees degrade to RTT-only, never fail).
                    t_peer = parse_ack(ack)
                    if t_peer is not None and item.t0_wall:
                        record_ack_sample(
                            self.address, item.t0_wall, wall_now(), t_peer
                        )
                    if not item.fut.done():
                        item.fut.set_result(ack)

        w = asyncio.get_running_loop().create_task(write_loop())
        r = asyncio.get_running_loop().create_task(read_loop())
        try:
            done, _ = await asyncio.wait({w, r}, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                exc = t.exception()
                if exc is not None:
                    raise exc
        finally:
            for t in (w, r):
                t.cancel()
            # Let cancellation unwind so neither loop touches the deques
            # after we return.
            await asyncio.gather(w, r, return_exceptions=True)


class ReliableSender:
    def __new__(cls):
        # Transport seam: see SimpleSender.__new__ — an installed
        # in-memory transport provides the drop-in counterpart (same
        # future-per-send delivery contract, resolved with the peer's
        # ACK) so every call site keeps writing `ReliableSender()`.
        sim = _transport.active()
        if sim is not None and cls is ReliableSender:
            return sim.reliable_sender()
        return super().__new__(cls)

    def __init__(self) -> None:
        self._connections: Dict[str, _Connection] = {}
        _SENDERS.add(self)

    def _connection(self, address: str) -> _Connection:
        conn = self._connections.get(address)
        if conn is None or conn.task.done():
            conn = _Connection(address)
            self._connections[address] = conn
        return conn

    def send(
        self, address: str, data: bytes, msg_type: str = "other"
    ) -> asyncio.Future:
        """Queue `data` for delivery; the returned future resolves with the
        peer's ACK payload.  Cancel it to abandon delivery.  ``msg_type``
        labels the frame in the wire-goodput ledger (the caller just
        encoded the message, so it knows; see metrics.WireLedger)."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        if len(data) > MAX_FRAME:
            fut.set_exception(
                ValueError(f"message of {len(data)} bytes exceeds MAX_FRAME")
            )
            return fut
        self._connection(address).push(data, fut, msg_type)
        return fut

    def broadcast(
        self, addresses: Sequence[str], data: bytes, msg_type: str = "other"
    ) -> List[asyncio.Future]:
        return [self.send(addr, data, msg_type) for addr in addresses]

    def lucky_broadcast(
        self,
        addresses: Sequence[str],
        data: bytes,
        nodes: int,
        msg_type: str = "other",
    ) -> List[asyncio.Future]:
        """Send to `nodes` random peers (reference reliable_sender.rs:91-100)."""
        return self.broadcast(sample_peers(addresses, nodes), data, msg_type)

    def close(self) -> None:
        for conn in self._connections.values():
            conn.task.cancel()
            conn.abort_all()
        self._connections.clear()
