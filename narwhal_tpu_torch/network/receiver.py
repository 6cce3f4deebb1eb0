"""TCP server: accept loop, one task per inbound connection, frames
dispatched to a `MessageHandler` which may write replies/ACKs back on the
same socket (reference network/src/receiver.rs:18-47).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Protocol

from .. import metrics
from ..utils.env import env_flag
from ..utils.tasks import spawn
from . import transport as _transport
from . import wirev2
from .framing import (
    STREAM_LIMIT,
    FrameError,
    frame,
    parse_address,
    read_frame,
    tune_writer,
    write_frame,
)

log = logging.getLogger("narwhal.network")

_m_frames_in = metrics.counter("net.recv.frames")
_m_bytes_in = metrics.counter("net.recv.bytes")
_m_bad_frames = metrics.counter("net.recv.bad_frames")

# ACK-coalescing instruments (wire v2): replies written during one burst
# of buffered inbound frames leave in ONE transport.write instead of one
# syscall per ACK — votes and ACKs stop riding one syscall each.
_m_ack_flushes = metrics.counter("wire.out.ack_flushes")
_h_acks_per_flush = metrics.histogram("wire.out.acks_per_flush")

# Backpressure floor for the coalesced reply path: replies are tiny, so
# drain() (which can suspend the dispatch loop) is only awaited once
# this much is buffered un-drained — a peer that stops reading ACKs
# still bounds our buffer, without paying a drain per reply.
_ACK_DRAIN_BYTES = 256 * 1024


class Writer:
    """Reply channel handed to the handler: writes frames back to the peer.

    Under wire v2 (``coalesce=True``) replies are buffered and flushed
    with one ``transport.write`` per event-loop turn: a burst of inbound
    frames dispatched back-to-back (the reader's buffer already held
    them) accumulates its ACKs and the scheduled flush fires when the
    loop next idles — the receiver-side mirror of the sender's
    frame-coalescing.  The legacy arm keeps the one-write-plus-drain-
    per-reply path byte- and syscall-identical."""

    __slots__ = ("_writer", "_buf", "_replies", "_scheduled", "_coalesce",
                 "_undrained")

    def __init__(
        self, writer: asyncio.StreamWriter, coalesce: bool = False
    ) -> None:
        self._writer = writer
        self._coalesce = coalesce
        self._buf = bytearray()
        self._replies = 0
        self._scheduled = False
        self._undrained = 0

    async def send(self, data: bytes) -> None:
        if not self._coalesce:
            await write_frame(self._writer, data)
            return
        self._buf += frame(data)
        self._replies += 1
        if not self._scheduled:
            self._scheduled = True
            asyncio.get_running_loop().call_soon(self.flush)
        if self._undrained >= _ACK_DRAIN_BYTES:
            self.flush()
            self._undrained = 0
            await self._writer.drain()

    def flush(self) -> None:
        self._scheduled = False
        if not self._buf:
            return
        if self._writer.is_closing():
            self._buf.clear()
            self._replies = 0
            return
        _m_ack_flushes.inc()
        _h_acks_per_flush.observe(self._replies)
        self._undrained += len(self._buf)
        self._writer.write(bytes(self._buf))
        self._buf.clear()
        self._replies = 0


class MessageHandler(Protocol):
    async def dispatch(self, writer: Writer, message: bytes) -> None: ...


class Receiver:
    """Binds `address` and dispatches every inbound frame to `handler`.

    ``classify`` (optional, ``bytes -> type-name``) is the plane's frame
    classifier (messages.frame_classifier over the plane's tag space):
    when present, every inbound frame is ALSO accounted per message type
    in the wire-goodput ledger — the receiver side of the sender/receiver
    reconciliation the bench's ``wire`` section reports.  Without it,
    frames are accounted under the "unframed" type so inbound totals
    still cover every byte."""

    def __init__(
        self, address: str, handler: MessageHandler, classify=None
    ) -> None:
        self.address = address
        self.handler = handler
        self.classify = classify
        self._server: asyncio.AbstractServer | None = None
        self._connections: set = set()
        self._closing = False

    @classmethod
    async def spawn(
        cls, address: str, handler: MessageHandler, classify=None
    ) -> "Receiver":
        # Transport seam: an installed in-memory transport (deterministic
        # simulation) owns every listener in the process — same handler
        # contract, frames arrive from seeded in-process queues instead
        # of sockets.
        sim = _transport.active()
        if sim is not None:
            return sim.spawn_receiver(address, handler, classify)
        self = cls(address, handler, classify)
        host, port = parse_address(address)
        # NARWHAL_BIND_ANY=1: listen on 0.0.0.0 with the committee port
        # instead of the advertised IP.  Multi-host deployments need this
        # whenever the reachable address is not on a local interface
        # (NAT'd/cloud public IPs); the reference node rewrites its listen
        # IP to 0.0.0.0 unconditionally (primary.rs:97-104).
        if env_flag("NARWHAL_BIND_ANY"):
            host = "0.0.0.0"
        self._server = await asyncio.start_server(
            self._on_connection, host, port, limit=STREAM_LIMIT
        )
        log.debug("Listening on %s", address)
        return self

    def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        # Synchronous accept callback: register the handler task BEFORE any
        # await, so shutdown() can never miss a just-accepted connection
        # (Python ≥3.12 Server.wait_closed() blocks on every live handler).
        if self._closing:
            writer.close()
            return
        task = spawn(self._handle(reader, writer))
        self._connections.add(task)
        task.add_done_callback(self._connections.discard)

    @property
    def port(self) -> int:
        """Actual bound port (useful when spawned with port 0)."""
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        # Per-peer attribution is the source IP only: the source port is
        # ephemeral, so peers are indistinguishable on localhost — the
        # outbound side (which knows the dialed address) carries the
        # precise per-peer split.
        peer_ip = peer[0] if isinstance(peer, tuple) else str(peer)
        tune_writer(writer)
        v2_capable = wirev2.enabled()
        w = Writer(writer, coalesce=v2_capable)
        # Per-connection wire-v2 state: a connection speaks v2 only after
        # its first frame is the sender's HELLO (ReliableSender does;
        # SimpleSender and legacy peers never do, and their raw frames
        # keep working on the same listener).  The decode dictionary is
        # connection state — a reconnect is a new connection, so stale
        # back-references cannot survive a flap by construction.
        v2_conn = False
        dec_dict = None
        first = True
        try:
            while True:
                message = await read_frame(reader)
                if first:
                    first = False
                    if v2_capable and message == wirev2.HELLO:
                        v2_conn = True
                        dec_dict = wirev2.DigestDict()
                        _m_frames_in.inc()
                        _m_bytes_in.inc(len(message))
                        metrics.wire_account(
                            "in", "wire_hello", peer_ip, len(message)
                        )
                        continue
                wire_len = len(message)
                if v2_conn:
                    try:
                        message = wirev2.decompress(message, dec_dict)
                    except FrameError:
                        # Typed into the ledger (the `frame_error` row of
                        # wire.in.*), then the connection dies: a corrupt
                        # or out-of-range reference means the dictionaries
                        # may have diverged, and only a reconnect (which
                        # resets both) is safe.
                        metrics.wire_account(
                            "in", "frame_error", peer_ip, wire_len
                        )
                        raise
                _m_frames_in.inc()
                _m_bytes_in.inc(wire_len)
                metrics.wire_account(
                    "in",
                    self.classify(message) if self.classify else "unframed",
                    peer_ip,
                    wire_len,
                    raw_nbytes=len(message),
                )
                await self.handler.dispatch(w, message)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # peer closed
        except FrameError as e:
            _m_bad_frames.inc()
            log.warning("Bad frame from %s: %s", peer, e)
        except Exception:
            log.exception("Handler error for peer %s", peer)
        finally:
            w.flush()  # any coalesced replies still buffered
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def shutdown(self) -> None:
        if self._server is not None:
            self._closing = True
            self._server.close()
            for task in list(self._connections):
                task.cancel()
            await asyncio.gather(*self._connections, return_exceptions=True)
            self._connections.clear()
            await self._server.wait_closed()
            self._server = None
