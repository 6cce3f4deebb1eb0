"""Length-delimited framing: u32 little-endian length prefix + payload.

The reference uses tokio-util's LengthDelimitedCodec (4-byte prefix) over
TCP — reference network/src/receiver.rs:70, simple_sender.rs:107.
"""

from __future__ import annotations

import asyncio
import random
import struct

_LEN = struct.Struct("<I")

# Batches are ≤ ~500 kB; headers/certs are tiny. 32 MiB is a generous cap
# that still rejects garbage/hostile length prefixes.
MAX_FRAME = 32 * 1024 * 1024

# Stream buffer limit for every reader/writer that can carry batch frames.
# asyncio's default is 64 KiB, which turns each ~500 kB frame into ~8
# pause/resume event-loop round trips; when many node processes share few
# cores each round trip costs a scheduling quantum and the ACK RTT — and
# with it quorum throughput — collapses.  An 8 MiB window moves whole
# batches per wakeup.
STREAM_LIMIT = 8 * 1024 * 1024


def tune_writer(writer: "asyncio.StreamWriter") -> None:
    """Raise the transport's write high-water mark so large frames are
    buffered in one go instead of trickling out 64 KiB per drain cycle."""
    try:
        writer.transport.set_write_buffer_limits(high=STREAM_LIMIT)
    except (AttributeError, RuntimeError):  # non-socket transports (tests)
        pass


class FrameError(Exception):
    pass


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    hdr = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise FrameError(f"frame of {n} bytes exceeds cap {MAX_FRAME}")
    if n == 0:
        return b""
    return await reader.readexactly(n)


def frame(data: bytes) -> bytes:
    return _LEN.pack(len(data)) + data


async def write_frame(writer: asyncio.StreamWriter, data: bytes) -> None:
    if len(data) > MAX_FRAME:
        # Enforced on write too: an oversized frame would otherwise make the
        # receiver kill the connection and a reliable sender retransmit the
        # same poison frame in a hot loop.
        raise FrameError(f"refusing to send {len(data)}-byte frame (cap {MAX_FRAME})")
    writer.write(_LEN.pack(len(data)))
    writer.write(data)
    await writer.drain()


def parse_address(addr: str):
    host, _, port = addr.rpartition(":")
    return host, int(port)


def sample_peers(addresses, nodes: int, rng: random.Random = random):  # type: ignore[assignment]
    """Pick `nodes` distinct random peers for lucky_broadcast.  ``rng``
    is injectable (the sim transport passes its seeded per-sender stream
    so lucky sampling replays bit-identically per (seed, spec); socketed
    senders default to the module RNG)."""
    addrs = list(addresses)
    return rng.sample(addrs, min(nodes, len(addrs)))
