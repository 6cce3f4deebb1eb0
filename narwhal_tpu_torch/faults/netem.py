"""WAN emulation at the ``network/`` seam: latency, jitter, loss, partitions.

One ``NetEmulator`` per process, configured from a JSON file named by the
``NARWHAL_FAULT_NETEM`` env var (the per-node compilation of a scenario's
``wan`` plane, written by benchmark/fault_bench.py) and selected into by
``NARWHAL_FAULT_NODE``.  The network layer calls two hooks:

- :func:`blocked` — before every outbound connect; a partitioned peer's
  connect attempt fails like a dead host (OSError), so the sender runs its
  REAL reconnect-backoff path and the ``peer_unreachable`` health rule has
  the same signal a real partition leaves;
- :func:`wrap` — after every successful outbound connect; when a shaping
  rule matches the destination, the writer is replaced by a
  :class:`_ShapedWriter` that delays each frame by latency+jitter and
  surfaces emulated loss as a connection reset (TCP semantics: a lost
  segment stalls then kills the stream — it never silently drops one
  message), so ReliableSender retransmits and SimpleSender visibly drops.

Per-peer-pair shaping lives entirely on the initiating side, where the
destination identity is known.  ACK return legs ride the unwrapped
socket: one-way latency is emulated exactly, measured RTTs see the
outbound leg.

Every stochastic draw comes from one ``random.Random`` seeded from the
scenario seed and the node name, so a scenario replays identically under
the same ``NARWHAL_FAULT_SEED``.  With no env config the hooks are a
single ``is None`` check — zero cost for normal runs.
"""

from __future__ import annotations

import asyncio
import collections
import json
import random
import time
import zlib
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from ..utils.env import env_str
from ..utils.tasks import spawn


@dataclass(frozen=True)
class Shape:
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    loss: float = 0.0

    def delay_s(self, rng: random.Random) -> float:
        return (self.latency_ms + self.jitter_ms * rng.random()) / 1000.0

    def shaping(self) -> bool:
        return self.latency_ms > 0 or self.jitter_ms > 0 or self.loss > 0


@dataclass(frozen=True)
class PartitionWindow:
    peers: frozenset  # destination addresses cut off from this node
    from_s: float
    until_s: Optional[float]  # None = never heals


class NetEmulator:
    """Per-process shaping state.  ``start_ts`` anchors the partition
    windows (the runner stamps launch time so every node agrees on when
    a partition begins and heals)."""

    def __init__(
        self,
        rules: Dict[str, Shape],
        default: Optional[Shape],
        partitions: List[PartitionWindow],
        seed: int,
        node: str = "",
        start_ts: Optional[float] = None,
    ) -> None:
        self.rules = dict(rules)
        self.default = default
        self.partitions = list(partitions)
        self.start_ts = time.time() if start_ts is None else start_ts
        # One deterministic stream per (scenario seed, node): replaying a
        # scenario re-draws identical jitter/loss decisions.
        self.rng = random.Random(seed ^ zlib.crc32(node.encode()))

    @classmethod
    def load(cls, path: str, node: str) -> Optional["NetEmulator"]:
        with open(path) as f:
            cfg = json.load(f)
        entry = (cfg.get("nodes") or {}).get(node)
        if entry is None:
            return None  # this process is unshaped in the scenario
        rules: Dict[str, Shape] = {}
        default: Optional[Shape] = None
        for r in entry.get("rules", []):
            shape = Shape(
                latency_ms=float(r.get("latency_ms", 0.0)),
                jitter_ms=float(r.get("jitter_ms", 0.0)),
                loss=float(r.get("loss", 0.0)),
            )
            if r.get("dst", "*") == "*":
                default = shape
            else:
                rules[r["dst"]] = shape
        partitions = [
            PartitionWindow(
                peers=frozenset(p["peers"]),
                from_s=float(p["from_s"]),
                until_s=(
                    None if p.get("until_s") is None else float(p["until_s"])
                ),
            )
            for p in entry.get("partitions", [])
        ]
        return cls(
            rules,
            default,
            partitions,
            seed=int(cfg.get("seed", 0)),
            node=node,
            start_ts=cfg.get("start_ts"),
        )

    # -- hooks ----------------------------------------------------------------

    def shape_for(self, address: str) -> Optional[Shape]:
        shape = self.rules.get(address, self.default)
        return shape if shape is not None and shape.shaping() else None

    def blocked(self, address: str, now: Optional[float] = None) -> bool:
        if not self.partitions:
            return False
        t = (time.time() if now is None else now) - self.start_ts
        for w in self.partitions:
            if address in w.peers and t >= w.from_s and (
                w.until_s is None or t < w.until_s
            ):
                return True
        return False

    def wrap(
        self,
        address: str,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> Tuple[asyncio.StreamReader, "asyncio.StreamWriter"]:
        shape = self.shape_for(address)
        # A peer named in a pending or open partition window gets wrapped
        # even when unshaped: a partition must cut ESTABLISHED connections
        # too (the wrapper re-checks `blocked` on every drain), not just
        # refuse new ones.  Windows that have already healed for good are
        # ignored — post-heal reconnects must not pay the per-frame
        # queue-and-pump hop on the catch-up path.
        elapsed = time.time() - self.start_ts
        partitioned = any(
            address in w.peers
            and (w.until_s is None or elapsed < w.until_s)
            for w in self.partitions
        )
        if shape is None and not partitioned:
            return reader, writer
        return reader, _ShapedWriter(  # type: ignore[return-value]
            writer, shape or Shape(), self.rng, emu=self, address=address
        )


class _ShapedWriter:
    """StreamWriter stand-in that releases each drained frame after the
    shape's latency+jitter, in order, and surfaces emulated loss as a
    connection reset at drain time.

    ``write()`` only buffers; ``drain()`` seals the buffered bytes into one
    delivery unit (write_frame's prefix+payload pair stays atomic) and
    hands it to the pump task.  drain never exerts backpressure — the
    emulated pipe absorbs the bytes, like a WAN's bandwidth-delay product.
    """

    def __init__(
        self,
        writer: asyncio.StreamWriter,
        shape: Shape,
        rng: random.Random,
        emu: Optional["NetEmulator"] = None,
        address: str = "",
    ) -> None:
        self._w = writer
        self._shape = shape
        self._rng = rng
        self._emu = emu
        self._addr = address
        self._buf = bytearray()
        self._q: Deque[Tuple[float, bytes]] = collections.deque()
        self._wake = asyncio.Event()
        self._exc: Optional[BaseException] = None
        self._loop = asyncio.get_running_loop()
        self._task = spawn(self._pump(), name="netem-pump")

    def write(self, data: bytes) -> None:
        self._buf += data

    async def drain(self) -> None:
        if self._exc is not None:
            raise self._exc
        if self._emu is not None and self._emu.blocked(self._addr):
            # The partition window opened while this connection was up:
            # cut it like a real link failure.
            raise ConnectionResetError("netem: partitioned from peer")
        chunk = bytes(self._buf)
        self._buf.clear()
        if not chunk:
            return
        if self._shape.loss and self._rng.random() < self._shape.loss:
            # TCP loses segments, not messages: surface the loss as a dead
            # stream so the caller's real recovery path (reconnect +
            # retransmit, or visible drop) runs instead of a silent skip.
            raise ConnectionResetError("netem: emulated segment loss")
        self._q.append((self._loop.time() + self._shape.delay_s(self._rng), chunk))
        self._wake.set()

    async def _pump(self) -> None:
        try:
            while True:
                while not self._q:
                    self._wake.clear()
                    await self._wake.wait()
                due, chunk = self._q.popleft()
                now = self._loop.time()
                if due > now:
                    await asyncio.sleep(due - now)
                self._w.write(chunk)
                await self._w.drain()
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # surfaced on the caller's next drain
            self._exc = e

    def close(self) -> None:
        self._task.cancel()
        self._w.close()

    def is_closing(self) -> bool:
        return self._w.is_closing()

    async def wait_closed(self) -> None:
        await self._w.wait_closed()

    def get_extra_info(self, *args, **kwargs):
        return self._w.get_extra_info(*args, **kwargs)

    @property
    def transport(self):
        return self._w.transport


# -- scenario wan-plane resolution --------------------------------------------


def resolve_wan_plane(scenario, committee, names) -> Dict[str, dict]:
    """Resolve a scenario's ``wan`` plane (committee-wide defaults,
    per-directed-pair overrides, partition windows — see
    ``faults/spec.py::WanSpec``) into per-node-label shaping config:
    ``{label: {"rules": [{dst, latency_ms, jitter_ms, loss}],
    "partitions": [{"peers": [...], "from_s", "until_s"}]}}`` with
    destination ADDRESSES.  Intra-authority LAN traffic stays unshaped.
    The ONE compilation both fault harnesses consume:
    ``benchmark/fault_bench.py`` wraps it into the per-process config
    file this module loads, and ``narwhal_tpu/sim/transport.py`` feeds
    it to the in-memory transport — so the socketed and simulated WAN
    semantics can never drift apart."""
    wan = scenario.wan
    if wan is None:
        return {}
    nodes: Dict[str, dict] = {}

    def entry(label: str) -> dict:
        return nodes.setdefault(label, {"rules": [], "partitions": []})

    def wan_addresses(j: int) -> List[str]:
        auth = committee.authorities[names[j]]
        return [auth.primary.primary_to_primary] + [
            w.worker_to_worker for w in auth.workers.values()
        ]

    pair_shapes = {(p.src, p.dst): p for p in wan.pairs}
    for i in range(scenario.nodes):
        labels = [f"primary-{i}"] + [
            f"worker-{i}-{wid}" for wid in range(scenario.workers)
        ]
        for j in range(scenario.nodes):
            if j == i:
                continue  # intra-authority traffic stays LAN-fast
            p = pair_shapes.get((i, j))
            shape = {
                "latency_ms": p.latency_ms if p else wan.latency_ms,
                "jitter_ms": p.jitter_ms if p else wan.jitter_ms,
                "loss": p.loss if p else wan.loss,
            }
            if not any(shape.values()):
                continue
            for dst in wan_addresses(j):
                for label in labels:
                    entry(label)["rules"].append(dict(shape, dst=dst))
        for part in wan.partitions:
            group = set(part.group)
            cut = (
                [j for j in range(scenario.nodes) if j not in group]
                if i in group
                else list(group)
            )
            peers = [a for j in cut for a in wan_addresses(j)]
            if not peers:
                continue
            for label in labels:
                entry(label)["partitions"].append(
                    {
                        "peers": peers,
                        "from_s": part.from_s,
                        "until_s": part.until_s,
                    }
                )
    return nodes


# -- process-wide accessor -----------------------------------------------------

_EMULATOR: Optional[NetEmulator] = None
_LOADED = False


def emulator() -> Optional[NetEmulator]:
    """The process's emulator, lazily loaded from NARWHAL_FAULT_NETEM /
    NARWHAL_FAULT_NODE; None (the overwhelmingly common case) means every
    hook below is a no-op."""
    global _EMULATOR, _LOADED
    if not _LOADED:
        _LOADED = True
        path = env_str("NARWHAL_FAULT_NETEM")
        if path:
            _EMULATOR = NetEmulator.load(
                path, env_str("NARWHAL_FAULT_NODE")
            )
    return _EMULATOR


def install(emu: Optional[NetEmulator]) -> None:
    """Programmatic install (tests, in-process harnesses)."""
    global _EMULATOR, _LOADED
    _EMULATOR = emu
    _LOADED = True


def reset() -> None:
    """Forget any installed/loaded emulator; the next :func:`emulator`
    call re-reads the environment."""
    global _EMULATOR, _LOADED
    _EMULATOR = None
    _LOADED = False


def blocked(address: str) -> bool:
    emu = emulator()
    return emu is not None and emu.blocked(address)


def wrap(
    address: str,
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
    emu = emulator()
    if emu is None:
        return reader, writer
    return emu.wrap(address, reader, writer)

