"""Open-loop benchmark load generator.

Reference node/src/benchmark_client.rs (158 LoC): send `rate` tx/s in
PRECISION(=20) bursts per second over one connection; the first tx of each
burst is a 'sample' (byte0=0 + u64 counter) logged for end-to-end latency
measurement, the rest are filler (byte0=1 + random u64), all zero-padded to
`size`.  Waits for all peer transaction sockets to accept before starting.

    python -m narwhal_tpu.node.benchmark_client 127.0.0.1:7001 \
        --size 512 --rate 50000 --nodes 127.0.0.1:7001 127.0.0.1:7006 ...
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import struct
import sys

from ..network.framing import parse_address

log = logging.getLogger("narwhal.client")

PRECISION = 20  # bursts per second
BURST_DURATION = 1.0 / PRECISION


async def wait_for(nodes) -> None:
    """Block until every node's transaction socket accepts."""
    log.info("Waiting for all nodes to be online...")
    for address in nodes:
        host, port = parse_address(address)
        while True:
            try:
                _, w = await asyncio.open_connection(host, port)
                w.close()
                break
            except OSError:
                await asyncio.sleep(0.1)


async def send_load(target: str, size: int, rate: int, sample_offset: int = 0) -> None:
    if size < 9:
        raise ValueError("Transaction size must be at least 9 bytes")
    burst = max(1, rate // PRECISION)
    host, port = parse_address(target)
    from ..network.framing import STREAM_LIMIT, tune_writer

    _, writer = await asyncio.open_connection(host, port, limit=STREAM_LIMIT)
    tune_writer(writer)
    log.info("Start sending transactions")
    log.info("Transactions size: %d B", size)
    log.info("Transactions rate: %d tx/s", rate)

    # The whole burst is ONE pre-framed buffer, patched in place and written
    # with a single syscall: at 50k tx/s the per-tx Python path would eat
    # the core the committee shares.  Layout per tx: [u32 len][flag][u64][pad].
    # Distinct offsets keep sample ids globally unique across clients so the
    # log parser's send→commit join is unambiguous.
    import numpy as np

    stride = 4 + size
    template = bytearray(
        struct.pack("<I", size) + b"\x01" + bytes(8) + bytes(size - 9)
    ) * burst
    template[4] = 0  # tx 0 of every burst is the sample (byte0 = 0)
    buf = np.frombuffer(template, dtype=np.uint8)
    # Byte positions of every tx's u64 field (offset 5 within its slot).
    u64_pos = (
        np.arange(burst)[:, None] * stride + 5 + np.arange(8)[None, :]
    ).ravel()
    filler_pos = u64_pos[8:]  # tx 0's u64 holds the sample counter
    rng = np.random.default_rng(sample_offset or None)

    counter = sample_offset
    loop = asyncio.get_running_loop()
    deadline = loop.time() + BURST_DURATION
    while True:
        template[5:13] = counter.to_bytes(8, "little")
        if burst > 1:
            buf[filler_pos] = rng.integers(
                0, 256, size=filler_pos.size, dtype=np.uint8
            )
        # Sample-send log BEFORE the write, so its timestamp excludes the
        # burst's own queueing (reference benchmark_client.rs:258-262).
        log.info("Sending sample transaction %d", counter)
        try:
            writer.write(bytes(template))
            await writer.drain()
        except OSError:
            # The worker's tx socket went away — at a bench window's end
            # the harness tears the committee down before the clients, and
            # on a loaded host this client can observe the closed socket
            # before its own SIGTERM lands.  An open-loop load generator
            # outliving its server is a normal shutdown, not an error (a
            # traceback here would hard-fail the log parser's error scan).
            log.info("Worker connection closed; stopping load")
            return
        counter += 1
        now = loop.time()
        if now > deadline:
            log.warning("Transaction rate too high for this client")
        else:
            await asyncio.sleep(deadline - now)
        deadline += BURST_DURATION


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Narwhal benchmark client")
    parser.add_argument("target", help="ip:port of the worker tx socket")
    parser.add_argument("--size", type=int, required=True)
    parser.add_argument("--rate", type=int, required=True)
    parser.add_argument("--nodes", nargs="*", default=[])
    parser.add_argument("--sample-offset", type=int, default=0)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s.%(msecs)03dZ %(levelname)s %(name)s %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
        stream=sys.stderr,
        force=True,
    )

    async def run() -> None:
        await wait_for(args.nodes or [args.target])
        await send_load(args.target, args.size, args.rate, args.sample_offset)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
