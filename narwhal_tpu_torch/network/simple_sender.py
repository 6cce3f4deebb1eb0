"""Best-effort sender: one connection task per peer, drops on failure.

Reference network/src/simple_sender.rs (143 LoC): used for sync replies,
cleanup commands and helper responses — anything where the application-level
retry logic (timers + lucky_broadcast) already provides liveness.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Sequence

from .. import metrics
from ..faults import netem as _netem
from ..utils.tasks import spawn
from . import transport as _transport
from . import wirev2
from .framing import (
    STREAM_LIMIT,
    frame,
    parse_address,
    read_frame,
    sample_peers,
    tune_writer,
    write_frame,
)

log = logging.getLogger("narwhal.network")

_QUEUE_CAP = 1_000

_m_frames = metrics.counter("net.simple.frames_sent")
_m_bytes = metrics.counter("net.simple.bytes_sent")
_m_dropped = metrics.counter("net.simple.dropped")

# Shared with ReliableSender: one flush = one writer.write + drain()
# covering every message the per-peer queue held at wakeup.  The
# batch_digest plane (a worker's highest-frequency connection) rides
# this sender, so its syscall batching lands in the same acceptance
# series.
_m_flushes = metrics.counter("wire.out.flushes")
_h_frames_per_flush = metrics.histogram("wire.out.frames_per_flush")

# Flush bounds, frames AND bytes: a deep backlog (the queue holds up to
# 1000 messages, each up to ~500 KB batch frames on the worker Helper
# path) must not turn into one multi-hundred-MB buffered write — same
# rationale as ReliableSender's _FLUSH_MAX_BYTES.
_FLUSH_MAX_FRAMES = 256
_FLUSH_MAX_BYTES = 1 << 20


class _Peer:
    def __init__(self, address: str) -> None:
        self.address = address
        # One shared channel name for every peer: the depth gauge is
        # last-writer-wins across instances but high-water is monotone
        # and the counters aggregate — the same committee-aggregated
        # convention as the sim registry.
        self.queue: asyncio.Queue = metrics.InstrumentedQueue(
            _QUEUE_CAP, channel="net.simple_sender"
        )
        self.task = spawn(self._run(), name="simple-sender-peer")

    async def _run(self) -> None:
        host, port = parse_address(self.address)
        while True:
            data, msg_type = await self.queue.get()
            try:
                # Fault-injection partition shim: best-effort semantics —
                # a partitioned peer's message is a visible drop.
                if _netem.blocked(self.address):
                    raise OSError("netem: partitioned from peer")
                reader, writer = await asyncio.open_connection(
                    host, port, limit=STREAM_LIMIT
                )
                tune_writer(writer)
                reader, writer = _netem.wrap(self.address, reader, writer)
            except OSError as e:
                log.debug("SimpleSender: cannot reach %s: %s", self.address, e)
                _m_dropped.inc()
                continue  # drop this message; try fresh on the next one
            # Drain-and-discard replies (e.g. ACKs) so the peer's writes
            # don't stall; best-effort senders ignore response content.
            drain = spawn(self._drain(reader))
            batch = []
            try:
                while True:
                    if not wirev2.enabled():
                        # Legacy arm: one write_frame + drain per message,
                        # byte- and syscall-identical to the pre-v2 path.
                        await write_frame(writer, data)
                        # Counted only after the write succeeds; the
                        # failure path below counts the in-flight message
                        # as dropped (this sender's whole contract is
                        # visible loss).
                        _m_frames.inc()
                        _m_bytes.inc(len(data))
                        metrics.wire_account(
                            "out", msg_type, self.address, len(data)
                        )
                        data, msg_type = await self.queue.get()
                        continue
                    # v2: one zero-delay yield (anything scheduled this
                    # loop pass gets to enqueue), then drain the whole
                    # queue into ONE write + drain().
                    await asyncio.sleep(0)
                    batch = [(data, msg_type)]
                    nbytes = len(data)
                    while (
                        len(batch) < _FLUSH_MAX_FRAMES
                        and nbytes < _FLUSH_MAX_BYTES
                    ):
                        try:
                            item = self.queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        batch.append(item)
                        nbytes += len(item[0])
                    writer.write(b"".join(frame(d) for d, _ in batch))
                    await writer.drain()
                    _m_flushes.inc()
                    _h_frames_per_flush.observe(len(batch))
                    for d, t in batch:
                        _m_frames.inc()
                        _m_bytes.inc(len(d))
                        metrics.wire_account("out", t, self.address, len(d))
                    batch = []
                    data, msg_type = await self.queue.get()
            except (ConnectionError, OSError) as e:
                # Every message of a failed coalesced flush is a visible
                # drop, exactly like the single in-flight message was.
                _m_dropped.inc(max(1, len(batch)))
                log.debug("SimpleSender: lost %s: %s", self.address, e)
            finally:
                drain.cancel()
                writer.close()

    @staticmethod
    async def _drain(reader: asyncio.StreamReader) -> None:
        try:
            while True:
                await read_frame(reader)
        except Exception:
            pass


class SimpleSender:
    def __new__(cls):
        # Transport seam: under an installed in-memory transport
        # (deterministic simulation) construction yields the sim
        # counterpart — call sites keep writing `SimpleSender()` and the
        # swap happens here, exactly like Receiver.spawn.  Subclasses
        # (none today) would build the TCP sender as written.
        sim = _transport.active()
        if sim is not None and cls is SimpleSender:
            return sim.simple_sender()
        return super().__new__(cls)

    def __init__(self) -> None:
        self._peers: Dict[str, _Peer] = {}

    def send(
        self, address: str, data: bytes, msg_type: str = "other"
    ) -> None:
        """``msg_type`` labels the frame in the wire-goodput ledger (the
        caller just encoded the message, so it knows)."""
        peer = self._peers.get(address)
        if peer is None or peer.task.done():
            peer = _Peer(address)
            self._peers[address] = peer
        try:
            peer.queue.put_nowait((data, msg_type))
        except asyncio.QueueFull:
            _m_dropped.inc()
            log.warning("SimpleSender: queue full for %s; dropping", address)

    def broadcast(
        self, addresses: Sequence[str], data: bytes, msg_type: str = "other"
    ) -> None:
        for addr in addresses:
            self.send(addr, data, msg_type)

    def lucky_broadcast(
        self,
        addresses: Sequence[str],
        data: bytes,
        nodes: int,
        msg_type: str = "other",
    ) -> None:
        """Send to `nodes` random peers (reference simple_sender.rs:76-85)."""
        self.broadcast(sample_peers(addresses, nodes), data, msg_type)

    def close(self) -> None:
        for peer in self._peers.values():
            peer.task.cancel()
        self._peers.clear()
