"""The port's ``worker/*`` against the JAX package's, on the CPU.

``tests/test_worker.py`` and ``tests/test_worker_hardening.py`` run again
on the port.  One seeded transaction stream, fed to both packages'
``BatchMaker`` over the same loopback socket traffic, seals the same
batch bytes, and both packages' ``Processor`` give those batches the same
digests, the same store records and the same primary messages."""

import asyncio
import logging
import random

import narwhal_tpu.config as jconfig
import narwhal_tpu.native as jnative
import narwhal_tpu.network.framing as jframing
import narwhal_tpu.store as jstore
import narwhal_tpu.worker.batch_maker as jbatch_maker
import narwhal_tpu.worker.processor as jprocessor
import narwhal_tpu_torch.config as tconfig
import narwhal_tpu_torch.native as tnative
import narwhal_tpu_torch.network.framing as tframing
import narwhal_tpu_torch.store as tstore
import narwhal_tpu_torch.worker.batch_maker as tbatch_maker
import narwhal_tpu_torch.worker.processor as tprocessor
from narwhal_tpu_torch.crypto import digest32 as tdigest32

from tests.common import committee
from tests.test_torch_tasks import mirror, package_state

MIRRORED_WORKER = mirror(globals(), "test_worker")
MIRRORED_HARDENING = mirror(globals(), "test_worker_hardening")


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED_WORKER) == 8
    assert len(MIRRORED_HARDENING) == 11


# -- parity -------------------------------------------------------------------

_PACKAGES = {
    "jax": (jconfig, jnative, jframing, jstore, jbatch_maker, jprocessor),
    "port": (tconfig, tnative, tframing, tstore, tbatch_maker, tprocessor),
}
# Ports 26200-26219 (one committee of 4, five ports an authority), bound by
# no other test; the two packages take them in turn.
_BASE_PORT = 26200
_BATCH_SIZE = 4_000


def _seeded_stream():
    """A client's transactions: every 10th a sample (byte0 = 0 and its
    u64 id), the rest filler, 9 to 512 bytes each."""
    rng = random.Random(20261017)
    txs = []
    for i in range(400):
        size = rng.randrange(9, 513)
        if i % 10 == 0:
            txs.append(b"\x00" + (1000 + i).to_bytes(8, "little") + bytes(size - 9))
        else:
            txs.append(b"\x01" + rng.randbytes(size - 1))
    return txs


def _sealed_count(native, txs) -> int:
    """Batches the stream seals by size alone (the tail stays open)."""
    batcher = native.make_batcher(_BATCH_SIZE)
    framer = native.make_framer(batcher)
    sealed = 0
    for tx in txs:
        ready = framer.feed(batcher, jframing.frame(tx))
        while ready:
            sealed += batcher.seal() is not None
            ready = framer.feed(batcher, b"")
    return sealed


async def _run_worker_path(pkg, txs, expected):
    config, native, framing, store_mod, batch_maker, processor = _PACKAGES[pkg]
    c = config.Committee.from_json(committee(base_port=_BASE_PORT).to_json())
    me = sorted(c.authorities)[0]
    sealed_q = asyncio.Queue()
    maker = batch_maker.BatchMaker(
        me, 0, c, batch_size=_BATCH_SIZE, max_batch_delay_ms=60_000,
        address=c.worker(me, 0).transactions, out_queue=sealed_q,
        benchmark=True)
    task = asyncio.ensure_future(maker.run())
    await maker.started.wait()
    host, port = framing.parse_address(maker.address)
    _, w = await asyncio.open_connection(host, port)
    for i in range(0, len(txs), 37):  # uneven socket writes
        w.write(b"".join(framing.frame(tx) for tx in txs[i:i + 37]))
        await w.drain()
    sealed = [await asyncio.wait_for(sealed_q.get(), 10) for _ in range(expected)]
    w.close()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    maker.sender.close()
    # Own batches (digest from the seal) and the same bytes as a peer's
    # batch (hashed on arrival), each through its own Processor.
    out = {}
    for own in (True, False):
        store = store_mod.Store()
        in_q, out_q = asyncio.Queue(), asyncio.Queue()
        proc = asyncio.ensure_future(
            processor.Processor(0, store, in_q, out_q, own_digests=own).run())
        for digest, serialized, _ in sealed:
            await in_q.put((digest, serialized) if own else serialized)
        msgs = [await asyncio.wait_for(out_q.get(), 10) for _ in sealed]
        proc.cancel()
        await asyncio.gather(proc, return_exceptions=True)
        out[own] = (msgs, {bytes(bytes(d)): store.read(bytes(d))
                           for d, _, _ in sealed})
        store.close()
    return ([(bytes(d), s) for d, s, _ in sealed], out)


def test_batch_maker_and_processor_match_the_reference(caplog):
    txs = _seeded_stream()
    expected = _sealed_count(jnative, txs)
    assert expected == _sealed_count(tnative, txs) >= 10
    results, lines = {}, {}
    for pkg in ("jax", "port"):
        caplog.clear()
        with package_state(), caplog.at_level(logging.INFO, logger="narwhal.worker"):
            results[pkg] = asyncio.run(asyncio.wait_for(
                _run_worker_path(pkg, txs, expected), 30))
        lines[pkg] = [r.getMessage() for r in caplog.records
                      if r.getMessage().startswith("Batch ")]
    want, got = results["jax"], results["port"]
    assert got[0] == want[0]  # sealed bytes and their digests
    assert got[1] == want[1]  # primary messages and store records
    assert all(bytes(tdigest32(s)) == d for d, s in got[0])
    # The benchmark lines the log parser reads, sample ids included.
    assert lines["port"] == lines["jax"] and len(lines["port"]) > expected
    sent = {int.from_bytes(tx[1:9], "little") for tx in txs if tx[0] == 0}
    seen = [int(ln.split()[-1]) for ln in lines["port"] if "sample tx" in ln]
    assert seen and set(seen) <= sent
