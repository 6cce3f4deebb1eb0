"""The open-loop load generator: one process, one connection per worker.

The benchmark's frozen copy of the port's benchmark client
(``node/benchmark_client.py``, itself the reference's
``benchmark_client.rs``): each connection sends ``bursts_per_s`` bursts a
second (the reference's 20), each burst one write of ``rate /
bursts_per_s`` length-prefixed transactions, and transaction 0 of each
burst is a sample (byte 0 is 0, then a u64 id).  What differs: every burst
has a due time, ``t0 + phase + k / bursts_per_s``, fixed before the first
send (the phases drawn from the seed), and the generator records each
sample's due and send times; filler bytes and the samples' bytes come
from the seed.

    python3 -m portbench.loadgen plan.json

The plan names the workers' transaction addresses, the rate a worker,
the bursts a second, the transaction size, the seed, the warm-up, window
and longest drain in seconds, and two output files: ``start`` (written once every connection
is open: ``t0`` and the window) and ``records`` (written at the end: one
row ``[worker, burst, due, sent]`` per sample).  SIGTERM or SIGINT stops
it cleanly, whenever it arrives; the harness sends it after the drain,
and the generator stops by itself only a minute after that.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import signal
import struct
import sys
import time

import numpy as np

from .reference.judge import sample_tx

OWN_END_S = 60.0  # past the longest drain: the harness's stop comes first

_stop = {"asked": False, "loop": None, "event": None}


def _on_signal(signum, frame) -> None:
    """SIGTERM or SIGINT: stop sending.  A plain handler, so that it also
    holds before the loop starts and after it has closed."""
    _stop["asked"] = True
    loop = _stop["loop"]
    if loop is not None and not loop.is_closed():
        loop.call_soon_threadsafe(_stop["event"].set)


def sample_id(worker: int, burst: int) -> int:
    return (worker << 32) | burst


def phases(seed: int, workers: int, bursts_per_s: int):
    rng = random.Random(seed)
    return [rng.random() / bursts_per_s for _ in range(workers)]


async def _connect(address: str, deadline: float):
    host, port = address.rsplit(":", 1)
    while True:
        try:
            return await asyncio.open_connection(host, int(port))
        except OSError:
            if time.time() > deadline:
                raise
            await asyncio.sleep(0.1)


async def _drive(w: int, writer, plan: dict, t0: float, phase: float,
                 stop: asyncio.Event, records: list) -> None:
    size, rate, per_s = plan["tx_size"], plan["rate"], plan["bursts_per_s"]
    burst = rate // per_s
    stride = 4 + size
    buf = bytearray((struct.pack("<I", size) + b"\x01" + bytes(size - 1)) * burst)
    view = np.frombuffer(buf, dtype=np.uint8).reshape(burst, stride)
    rng = np.random.default_rng([plan["seed"] % 2**64, w])
    end = t0 + plan["warmup_s"] + plan["window_s"] + plan["drain_cap_s"] + OWN_END_S
    k = 0
    while not stop.is_set():
        due = t0 + phase + k / per_s
        if due > end:
            break
        sid = sample_id(w, k)
        view[0, 4:] = np.frombuffer(sample_tx(plan["seed"], sid, size), dtype=np.uint8)
        if burst > 1:
            view[1:, 5:13] = rng.integers(0, 256, size=(burst - 1, 8), dtype=np.uint8)
        delay = due - time.time()
        if delay > 0:
            try:
                await asyncio.wait_for(stop.wait(), delay)
                break
            except asyncio.TimeoutError:
                pass
        sent = time.time()
        try:
            writer.write(bytes(buf))
            await writer.drain()
        except OSError as e:
            print(f"loadgen: worker {w} closed: {e}", file=sys.stderr, flush=True)
            break  # the worker went away: the run is ending
        records.append((w, k, due, sent))
        k += 1


async def _main(plan: dict) -> list:
    stop = asyncio.Event()
    _stop.update(loop=asyncio.get_running_loop(), event=stop)
    if _stop["asked"]:
        stop.set()
    deadline = time.time() + plan.get("connect_s", 60.0)
    conns = [await _connect(a, deadline) for a in plan["targets"]]
    t0 = time.time() + 0.25
    ph = phases(plan["seed"], len(conns), plan["bursts_per_s"])
    start = {"t0": t0, "phases": ph,
             "window": [t0 + plan["warmup_s"], t0 + plan["warmup_s"] + plan["window_s"]]}
    tmp = plan["start"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(start, f)
    os.replace(tmp, plan["start"])
    records: list = []
    await asyncio.gather(*(_drive(w, c[1], plan, t0, ph[w], stop, records)
                           for w, c in enumerate(conns)))
    for _, writer in conns:
        writer.close()
    return records


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        plan = json.load(f)
    if plan["rate"] % plan["bursts_per_s"]:
        raise SystemExit(f"rate {plan['rate']} is not a multiple of {plan['bursts_per_s']}")
    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)
    records = asyncio.run(_main(plan))
    print(f"loadgen: stopped after {len(records)} samples", file=sys.stderr, flush=True)
    np.save(plan["records"], np.array(records, dtype=np.float64).reshape(-1, 4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
