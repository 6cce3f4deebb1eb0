"""In-memory transport: the network plane of the simulation harness.

Installed behind ``narwhal_tpu/network/transport.py`` (the seam every
``Receiver.spawn`` / ``SimpleSender()`` / ``ReliableSender()`` /
BatchMaker client-socket bind consults), so a whole committee's traffic
— primaries, workers, clients — routes through seeded in-process queues
on ONE event loop.  Semantics mirror the TCP classes and the
``faults/netem.py`` emulator they normally compose with:

- **per-pair shaping** re-uses the netem ``Shape`` (latency + jitter +
  loss) and partition-window vocabulary, compiled by
  :func:`compile_wan` from the same ``WanSpec`` the socketed
  fault_bench compiles — but a shaped delay becomes a virtual-time
  ``call_later``, never a real sleep, so a 120 ms WAN RTT costs
  microseconds of wall time under the virtual clock;
- **loss and partitions surface as the real recovery paths**: the
  reliable channel counts a retransmission and re-offers after the
  jittered exponential backoff (``next_backoff`` — the exact reconnect
  schedule of the TCP sender), the simple channel drops visibly, and an
  unreachable peer ticks the same per-peer failure gauges the
  ``peer_unreachable`` health rule consumes, with the same
  never-connected boot grace;
- **ordering** matches TCP: frames of one (sender, destination) channel
  deliver in send order (jitter never reorders within a channel), and
  each receiver processes one channel's frames sequentially while
  channels proceed independently (the per-connection task of the real
  Receiver).

Every stochastic draw comes from a ``random.Random`` seeded from the
scenario seed and the (src, dst) pair, so the same (seed, spec) replays
byte-for-byte.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import random
import zlib
from typing import Deque, Dict, List, Optional, Tuple

from .. import metrics
from ..faults.netem import Shape, resolve_wan_plane
from ..network.clocksync import parse_ack, record_ack_sample
from ..network.framing import MAX_FRAME, parse_address
from ..network.reliable_sender import (
    _BACKOFF_START,
    _NEVER_CONNECTED_GRACE_S,
    _peer_instruments,
    next_backoff,
)
from ..utils.clock import current_skew, wall_now
from ..utils.tasks import spawn

_m_frames = metrics.counter("net.sim.frames_delivered")
_m_bytes = metrics.counter("net.sim.bytes_delivered")
_m_dropped = metrics.counter("net.sim.dropped")
_m_lost = metrics.counter("net.sim.emulated_losses")
_m_retrans = metrics.counter("net.sim.retransmissions")


def compile_wan(scenario, committee, names) -> Dict[str, dict]:
    """The shared scenario wan-plane resolution
    (``faults/netem.py::resolve_wan_plane`` — one compilation for both
    the socketed and simulated harnesses), with partition peer lists
    turned into sets for this transport's per-frame membership checks."""
    table = resolve_wan_plane(scenario, committee, names)
    for entry in table.values():
        for part in entry["partitions"]:
            part["peers"] = set(part["peers"])
    return table


class SimTransport:
    """One committee's in-memory network (install via
    ``narwhal_tpu.network.transport.install``).

    ``wan_table`` is :func:`compile_wan` output; ``backoff_cap_s`` is the
    scenario's reconnect-backoff ceiling (the NARWHAL_NET_BACKOFF_MAX_S
    knob, injected instead of read from the environment so in-process
    runs never mutate ``os.environ``)."""

    def __init__(
        self,
        seed: int,
        wan_table: Optional[Dict[str, dict]] = None,
        backoff_cap_s: float = 60.0,
    ) -> None:
        self.seed = seed
        self.wan = wan_table or {}
        self.backoff_cap_s = max(_BACKOFF_START, float(backoff_cap_s))
        self.listeners: Dict[str, "_SimReceiver"] = {}
        self.tx_servers: Dict[str, "_SimTxServer"] = {}
        self.down: set = set()  # addresses of crashed authorities
        self.start_time: Optional[float] = None  # virtual anchor
        self._booting = ""  # label of the node being spawned
        self._serial = 0  # per-sender seed discriminator

    # -- harness hooks --------------------------------------------------------

    def anchor(self, now: float) -> None:
        """Anchor the partition-window clock (virtual launch instant)."""
        self.start_time = now

    class _NodeScope:
        def __init__(self, tr: "SimTransport", label: str) -> None:
            self.tr, self.label = tr, label

        def __enter__(self):
            self._prev = self.tr._booting
            self.tr._booting = self.label
            return self.tr

        def __exit__(self, *exc):
            self.tr._booting = self._prev

    def node(self, label: str) -> "_NodeScope":
        """Scope sender construction to ``label`` — every sender built
        inside carries that source identity for per-pair shaping."""
        return self._NodeScope(self, label)

    def set_down(self, addresses) -> None:
        """Crash: the addresses stop accepting AND established channels
        start failing (SIGKILL analog; listeners are dropped by the
        node's own shutdown)."""
        self.down.update(addresses)

    def set_up(self, addresses) -> None:
        self.down.difference_update(addresses)

    # -- seam surface (network/transport.py contract) -------------------------

    def spawn_receiver(self, address: str, handler, classify=None):
        receiver = _SimReceiver(self, address, handler, classify)
        self.listeners[address] = receiver
        return receiver

    def simple_sender(self) -> "_SimSimpleSender":
        self._serial += 1
        return _SimSimpleSender(self, self._booting, self._serial)

    def reliable_sender(self) -> "_SimReliableSender":
        self._serial += 1
        return _SimReliableSender(self, self._booting, self._serial)

    def create_tx_server(self, address: str, protocol_factory):
        server = _SimTxServer(self, address, protocol_factory)
        self.tx_servers[address] = server
        return server

    def open_tx_connection(self, address: str) -> "_SimTxConnection":
        """Harness-side client ingress: a connection into the worker's
        transaction plane (raises like a refused connect when the
        address is down or unbound)."""
        server = self.tx_servers.get(address)
        if server is None or address in self.down:
            raise OSError(f"sim: no tx listener on {address}")
        return server.connect()

    # -- shaping --------------------------------------------------------------

    def pair_rng(self, src: str, dst: str, serial: int) -> random.Random:
        return random.Random(
            self.seed
            ^ zlib.crc32(src.encode())
            ^ (zlib.crc32(dst.encode()) << 1)
            ^ (serial << 17)
        )

    def shape_for(self, src: str, dst: str) -> Optional[Shape]:
        entry = self.wan.get(src)
        if not entry:
            return None
        fallback = None
        for r in entry["rules"]:
            d = r.get("dst", "*")
            if d == dst:
                return Shape(
                    latency_ms=float(r.get("latency_ms", 0.0)),
                    jitter_ms=float(r.get("jitter_ms", 0.0)),
                    loss=float(r.get("loss", 0.0)),
                )
            if d == "*":
                fallback = r
        if fallback is not None:
            return Shape(
                latency_ms=float(fallback.get("latency_ms", 0.0)),
                jitter_ms=float(fallback.get("jitter_ms", 0.0)),
                loss=float(fallback.get("loss", 0.0)),
            )
        return None

    def partitioned(self, src: str, dst: str, now: float) -> bool:
        entry = self.wan.get(src)
        if not entry or self.start_time is None:
            return False
        t = now - self.start_time
        for w in entry["partitions"]:
            if dst in w["peers"] and t >= w["from_s"] and (
                w["until_s"] is None or t < w["until_s"]
            ):
                return True
        return False

    def unreachable(self, src: str, dst: str, now: float) -> bool:
        """Connect-time failure: dead/crashed/unbound peer or an open
        partition window — the shapes a TCP connect() would refuse."""
        return (
            dst in self.down
            or dst not in self.listeners
            or self.partitioned(src, dst, now)
        )

    def arrive(
        self,
        dst: str,
        chan_key: Tuple,
        data: bytes,
        msg_type: str,
        reply_cb,
    ) -> None:
        """Hand one frame to its listener NOW.  The listener is resolved
        at arrival time: a frame in flight when its destination crashes
        is lost with the crash."""
        listener = self.listeners.get(dst)
        if listener is None or dst in self.down:
            _m_dropped.inc()
            return
        _m_frames.inc()
        _m_bytes.inc(len(data))
        listener.enqueue(chan_key, data, msg_type, reply_cb)

    def schedule(self, due: float, fire) -> None:
        """Run ``fire`` at virtual ``due``, quantized to a 1 ms arrival
        grid: per-pair jitter draws otherwise give every frame its own
        due instant, and every distinct instant costs one full loop tick
        (clock jump + selector poll) — the measured #1 cost of a shaped
        N=20 run.  Callers that need ordering keep their own FIFO and
        let ``fire`` release the queue HEAD, so arrival order within a
        channel never depends on timer tie-breaking.  Zero-delay fires
        run synchronously: callers are sender tasks, already decoupled
        from dispatch by the receiver's channel queue."""
        loop = asyncio.get_running_loop()
        due = -(-due * 1000 // 1) / 1000
        delay = due - loop.time()
        if delay <= 0:
            fire()
        else:
            loop.call_later(delay, fire)

    async def shutdown(self) -> None:
        """Tear down every channel/listener task (end of run)."""
        for server in list(self.tx_servers.values()):
            server.close()
        for receiver in list(self.listeners.values()):
            await receiver.shutdown()
        self.listeners.clear()
        self.tx_servers.clear()


# -- receiver -----------------------------------------------------------------


class _SimWriter:
    """Reply channel handed to handlers: first reply resolves the
    sender-side delivery future (the ACK payload); extra replies are
    drained-and-discarded like the TCP senders do."""

    __slots__ = ("_reply",)

    def __init__(self, reply_cb) -> None:
        self._reply = reply_cb

    async def send(self, data: bytes) -> None:
        cb, self._reply = self._reply, None
        if cb is not None:
            cb(data)


class _SimReceiver:
    """Address-bound listener: one dispatch task per channel (the
    per-connection task of the real Receiver), frames processed in
    delivery order within a channel."""

    def __init__(self, transport, address, handler, classify) -> None:
        self.transport = transport
        self.address = address
        self.handler = handler
        self.classify = classify
        self._channels: Dict[Tuple, Tuple[Deque, asyncio.Event, asyncio.Task]] = {}
        self._closed = False
        # The receiver is constructed inside its node's boot scope, but
        # channel tasks are spawned lazily from the SENDER's context
        # (enqueue fires in the sending channel's task or a timer).
        # Capture the boot context so handlers — which stamp ACKs with
        # wall_now() — run under THIS node's injected clock skew, not
        # whichever sender happened to deliver the first frame.
        self._ctx = contextvars.copy_context()

    @property
    def port(self) -> int:
        return parse_address(self.address)[1]

    def enqueue(self, chan_key, data, msg_type, reply_cb) -> None:
        if self._closed:
            _m_dropped.inc()
            return
        chan = self._channels.get(chan_key)
        if chan is None:
            q: Deque = collections.deque()
            ev = asyncio.Event()
            task = self._ctx.run(
                spawn, self._chan_loop(q, ev), name="sim-recv-chan"
            )
            chan = self._channels[chan_key] = (q, ev, task)
        q, ev, _ = chan
        q.append((data, msg_type, reply_cb))
        ev.set()

    async def _chan_loop(self, q: Deque, ev: asyncio.Event) -> None:
        while True:
            while not q:
                ev.clear()
                await ev.wait()
            data, msg_type, reply_cb = q.popleft()
            metrics.wire_account(
                "in",
                self.classify(data) if self.classify else "unframed",
                "sim",
                len(data),
            )
            try:
                await self.handler.dispatch(_SimWriter(reply_cb), data)
            except asyncio.CancelledError:
                raise
            except Exception:
                import logging

                logging.getLogger("narwhal.sim").exception(
                    "Handler error on %s", self.address
                )

    async def shutdown(self) -> None:
        self._closed = True
        self.transport.listeners.pop(self.address, None)
        tasks = [t for (_, _, t) in self._channels.values()]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._channels.clear()


# -- senders ------------------------------------------------------------------


class _SimMsg:
    __slots__ = ("data", "fut", "msg_type", "accounted")

    def __init__(self, data, fut, msg_type) -> None:
        self.data = data
        self.fut = fut
        self.msg_type = msg_type
        self.accounted = False


class _SimRelChannel:
    """One reliable (src → dst) channel: queued messages survive
    unreachability and loss through the real jittered-exponential
    backoff schedule, per-peer health instruments tick exactly like the
    TCP sender's, and each delivery future resolves with the peer's ACK
    payload."""

    def __init__(self, transport, src: str, dst: str, serial: int) -> None:
        self.transport = transport
        self.src = src
        self.dst = dst
        self.queue: Deque[_SimMsg] = collections.deque()
        self.wakeup = asyncio.Event()
        self.rng = transport.pair_rng(src, dst, serial)
        self.delay = _BACKOFF_START
        self.backing_off = False
        self.failures = 0
        self.ever_connected = False
        self.last_due = 0.0
        # Frames "on the wire": released strictly FIFO by the timers
        # schedule() arms (each fire pops the head, so channel order is
        # independent of timer tie-breaking on the quantized grid).
        self._inflight: Deque = collections.deque()
        loop = asyncio.get_running_loop()
        self.created = loop.time()
        # The channel is created from the sending node's task context;
        # remember its skew so the ACK-receive stamp can be re-expressed
        # on the SENDER's clock (the _acked callback runs in the
        # receiver's channel-loop context).
        self.src_skew = current_skew()
        (
            self._m_rtt,
            self._m_peer_retrans,
            self._g_failures,
            self._g_backoff,
        ) = _peer_instruments(dst)
        self.task = spawn(self._run(), name="sim-reliable-chan")

    def push(self, msg: _SimMsg) -> None:
        self.queue.append(msg)
        self.wakeup.set()

    async def _run(self) -> None:
        transport = self.transport
        loop = asyncio.get_running_loop()
        shape = transport.shape_for(self.src, self.dst)
        while True:
            while not self.queue:
                self.wakeup.clear()
                await self.wakeup.wait()
            msg = self.queue[0]
            if msg.fut.cancelled():
                self.queue.popleft()
                continue
            now = loop.time()
            if transport.unreachable(self.src, self.dst, now):
                # Same failure accounting as _Connection._keep_alive,
                # including the never-connected boot grace.
                self.backing_off = True
                self.failures += 1
                if self.ever_connected or (
                    now - self.created > _NEVER_CONNECTED_GRACE_S
                ):
                    self._g_failures.set(self.failures)
                self._g_backoff.set(1)
                sleep_s, self.delay = next_backoff(
                    self.delay, cap=transport.backoff_cap_s, rng=self.rng
                )
                await asyncio.sleep(sleep_s)
                continue
            if self.backing_off or not self.ever_connected:
                self.delay = _BACKOFF_START
                self.backing_off = False
                self.ever_connected = True
                self.failures = 0
                self._g_failures.set(0)
                self._g_backoff.set(0)
            if shape is not None and shape.loss and (
                self.rng.random() < shape.loss
            ):
                # TCP loses segments, not messages: the frame will be
                # written again after a backoff window — a counted
                # retransmission, the signal a lossy link leaves.
                _m_lost.inc()
                _m_retrans.inc()
                self._m_peer_retrans.inc()
                retrans_wait, _ = next_backoff(
                    _BACKOFF_START, cap=transport.backoff_cap_s, rng=self.rng
                )
                metrics.wire_account(
                    "out", msg.msg_type, self.dst, len(msg.data),
                    retransmit=msg.accounted,
                )
                msg.accounted = True
                await asyncio.sleep(retrans_wait)
                continue
            self.queue.popleft()
            delay_s = shape.delay_s(self.rng) if shape is not None else 0.0
            due = max(now + delay_s, self.last_due)
            self.last_due = due
            t0 = now
            t0_wall = wall_now()  # sender context: carries src skew
            fut = msg.fut

            def _acked(
                payload: bytes, fut=fut, t0=t0, t0_wall=t0_wall
            ) -> None:
                self._m_rtt.observe(loop.time() - t0)
                # Same piggyback offset sampling as the TCP read_loop,
                # with the receive stamp mapped back onto the sender's
                # clock (this callback fires in the receiver's context).
                t_peer = parse_ack(payload)
                if t_peer is not None:
                    t_recv = wall_now() - current_skew() + self.src_skew
                    record_ack_sample(
                        self.dst, t0_wall, t_recv, t_peer, src=self.src
                    )
                if not fut.done():
                    fut.set_result(payload)

            metrics.wire_account(
                "out", msg.msg_type, self.dst, len(msg.data),
                retransmit=msg.accounted,
            )
            msg.accounted = True
            self._inflight.append((msg.data, msg.msg_type, _acked))
            transport.schedule(due, self._release)

    def _release(self) -> None:
        data, msg_type, acked = self._inflight.popleft()
        self.transport.arrive(self.dst, (id(self),), data, msg_type, acked)

    def abort_all(self) -> None:
        for msg in self.queue:
            if not msg.fut.done():
                msg.fut.cancel()
        self.queue.clear()


class _SimReliableSender:
    """Drop-in ReliableSender: ``send`` returns a future resolved with
    the peer's ACK payload; cancel abandons delivery."""

    def __init__(self, transport, src: str, serial: int) -> None:
        self.transport = transport
        self.src = src
        self._serial = serial
        self._channels: Dict[str, _SimRelChannel] = {}
        # Lucky-broadcast sampling draws from a seeded per-sender stream
        # (not the module RNG) so peer selection replays bit-identically
        # per (seed, spec).
        self._lucky_rng = transport.pair_rng(src, "lucky", serial)

    def _channel(self, address: str) -> _SimRelChannel:
        chan = self._channels.get(address)
        if chan is None or chan.task.done():
            chan = self._channels[address] = _SimRelChannel(
                self.transport, self.src, address, self._serial
            )
        return chan

    def send(
        self, address: str, data: bytes, msg_type: str = "other"
    ) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        if len(data) > MAX_FRAME:
            fut.set_exception(
                ValueError(f"message of {len(data)} bytes exceeds MAX_FRAME")
            )
            return fut
        self._channel(address).push(_SimMsg(data, fut, msg_type))
        return fut

    def broadcast(
        self, addresses, data: bytes, msg_type: str = "other"
    ) -> List[asyncio.Future]:
        return [self.send(addr, data, msg_type) for addr in addresses]

    def lucky_broadcast(
        self, addresses, data: bytes, nodes: int, msg_type: str = "other"
    ) -> List[asyncio.Future]:
        from ..network.framing import sample_peers

        return self.broadcast(
            sample_peers(addresses, nodes, rng=self._lucky_rng),
            data, msg_type,
        )

    def close(self) -> None:
        for chan in self._channels.values():
            chan.task.cancel()
            chan.abort_all()
        self._channels.clear()


class _SimSimpleSender:
    """Drop-in SimpleSender: best-effort, partitioned/lost frames are
    visible drops."""

    def __init__(self, transport, src: str, serial: int) -> None:
        self.transport = transport
        self.src = src
        self._serial = serial
        self._lucky_rng = transport.pair_rng(src, "lucky", serial)
        self._rngs: Dict[str, random.Random] = {}
        self._last_due: Dict[str, float] = {}
        self._inflight: Dict[str, Deque] = {}
        # shape_for is a linear rule scan; memoize per destination like
        # the reliable channel does (helper/sync re-serves ride this
        # sender, thousands of frames per shaped run).
        self._shapes: Dict[str, Optional[Shape]] = {}

    def send(
        self, address: str, data: bytes, msg_type: str = "other"
    ) -> None:
        transport = self.transport
        loop = asyncio.get_running_loop()
        now = loop.time()
        if transport.unreachable(self.src, address, now):
            _m_dropped.inc()
            return
        rng = self._rngs.get(address)
        if rng is None:
            rng = self._rngs[address] = transport.pair_rng(
                self.src, address, self._serial
            )
        if address in self._shapes:
            shape = self._shapes[address]
        else:
            shape = self._shapes[address] = transport.shape_for(
                self.src, address
            )
        if shape is not None and shape.loss and rng.random() < shape.loss:
            _m_lost.inc()
            _m_dropped.inc()
            return
        delay_s = shape.delay_s(rng) if shape is not None else 0.0
        due = max(now + delay_s, self._last_due.get(address, 0.0))
        self._last_due[address] = due
        metrics.wire_account("out", msg_type, address, len(data))
        inflight = self._inflight.get(address)
        if inflight is None:
            inflight = self._inflight[address] = collections.deque()
        inflight.append((data, msg_type))
        transport.schedule(
            due, lambda addr=address: self._release(addr)
        )

    def _release(self, address: str) -> None:
        data, msg_type = self._inflight[address].popleft()
        self.transport.arrive(
            address, (id(self), address), data, msg_type,
            lambda _payload: None,
        )

    def broadcast(self, addresses, data: bytes, msg_type: str = "other") -> None:
        for addr in addresses:
            self.send(addr, data, msg_type)

    def lucky_broadcast(
        self, addresses, data: bytes, nodes: int, msg_type: str = "other"
    ) -> None:
        from ..network.framing import sample_peers

        self.broadcast(
            sample_peers(addresses, nodes, rng=self._lucky_rng),
            data, msg_type,
        )

    def close(self) -> None:
        self._rngs.clear()
        self._last_due.clear()


# -- client-transaction ingress ----------------------------------------------


class _SimTxTransport:
    """Transport stand-in handed to _TxProtocol.connection_made."""

    __slots__ = ("closed", "paused")

    def __init__(self) -> None:
        self.closed = False
        self.paused = False

    def pause_reading(self) -> None:
        self.paused = True

    def resume_reading(self) -> None:
        self.paused = False

    def close(self) -> None:
        self.closed = True


class _SimTxConnection:
    """One in-memory client connection: ``write`` feeds raw stream bytes
    to the worker's tx protocol on the next loop tick (decoupled like a
    socket's data_received)."""

    def __init__(self, protocol) -> None:
        self.protocol = protocol
        self.transport = _SimTxTransport()
        protocol.connection_made(self.transport)

    def write(self, data: bytes) -> None:
        if self.transport.closed:
            return
        asyncio.get_running_loop().call_soon(self._feed, bytes(data))

    def _feed(self, data: bytes) -> None:
        if not self.transport.closed:
            self.protocol.data_received(data)

    def close(self) -> None:
        if not self.transport.closed:
            self.transport.closed = True
            self.protocol.connection_lost(None)


class _SimTxServer:
    """The BatchMaker-facing bind object (close() + a sockets attr for
    API compatibility)."""

    sockets: tuple = ()

    def __init__(self, transport, address, protocol_factory) -> None:
        self.transport = transport
        self.address = address
        self.protocol_factory = protocol_factory
        self.closed = False

    def connect(self) -> _SimTxConnection:
        if self.closed:
            raise OSError(f"sim: tx listener on {self.address} is closed")
        return _SimTxConnection(self.protocol_factory())

    def close(self) -> None:
        self.closed = True
        self.transport.tx_servers.pop(self.address, None)
