"""What the port records of a sample's path and of a node's waits, on the
CPU: the seal mark's sample ids, the commit stamp taken before the
``Committed`` line and before the downstream puts, the header and
certificate waiters' counters and the parked-header histogram, the boot's
phase gauges, and the sampling profiler armed only where something
exports the registry.

Port blocks: the batch maker 27100–27119, the header waiter
27120–27159, the worker processes 27160–27179, the primary 27180–27199;
no other test binds them."""

import asyncio
import logging
import os

import pytest

import chip_smoke
import tests.test_torch_tasks  # noqa: F401  (registers the tests._port_* copies)
from narwhal_tpu_torch import metrics, profiling
from narwhal_tpu_torch.consensus import Consensus
from narwhal_tpu_torch.crypto import Digest, digest32
from narwhal_tpu_torch.messages import encode_batch
from narwhal_tpu_torch.network import Receiver
from narwhal_tpu_torch.primary import header_waiter as hw_mod
from narwhal_tpu_torch.primary.certificate_waiter import CertificateWaiter
from narwhal_tpu_torch.primary.core import AtomicRound
from narwhal_tpu_torch.primary.header_waiter import HeaderWaiter
from narwhal_tpu_torch.primary.messages import Certificate, Header, genesis
from narwhal_tpu_torch.primary.synchronizer import payload_key
from narwhal_tpu_torch.store import Store
from narwhal_tpu_torch.worker.batch_maker import BatchMaker
from tests._port_common import (
    RecordingAckHandler,
    committee,
    filler_transaction,
    keys,
    make_certificate,
    make_header,
    transaction,
)


def _counter(name):
    return metrics.counter(name).value


def _hist(name):
    h = metrics.histogram(name)
    return h.count, h.sum


# ------------------------------------------------------------ the seal mark


def test_seal_mark_carries_exactly_the_batch_sample_ids(caplog):
    async def go():
        c = committee(base_port=27100)
        me = keys()[0].name
        receivers = [await Receiver.spawn(a.worker_to_worker, RecordingAckHandler())
                     for _, a in c.others_workers(me, 0)]
        out_q = asyncio.Queue()
        maker = BatchMaker(me, 0, c, batch_size=1_000_000, max_batch_delay_ms=50,
                           address=c.worker(me, 0).transactions, out_queue=out_q,
                           benchmark=True)
        task = asyncio.ensure_future(maker.run())
        await maker.started.wait()
        host, port = maker.address.rsplit(":", 1)
        _, w = await asyncio.open_connection(host, int(port))
        from narwhal_tpu_torch.network.framing import write_frame

        txs = [transaction(7), filler_transaction(), transaction(1 << 33 | 9),
               filler_transaction()]
        metrics.trace().entries.pop(bytes(digest32(encode_batch(txs))).hex(), None)
        for tx in txs:
            await write_frame(w, tx)
        digest, _, _ = await asyncio.wait_for(out_q.get(), 5)
        w.close()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        maker.sender.close()
        for r in receivers:
            await r.shutdown()
        return digest

    with caplog.at_level(logging.INFO):
        digest = asyncio.run(asyncio.wait_for(go(), 20))
    entry = metrics.trace().entries[bytes(digest).hex()]
    assert entry["samples"] == [7, 1 << 33 | 9]
    assert entry["txs"] == 4
    logged = [int(r.getMessage().rsplit(" ", 1)[1]) for r in caplog.records
              if "contains sample tx" in r.getMessage() and repr(digest) in r.getMessage()]
    assert logged == entry["samples"]


# ------------------------------------------------------------- the commit


def _certificates(c, rounds):
    """One certificate per authority a round, each with one batch of its
    own, each citing every certificate of the round before."""
    names = sorted(kp.name for kp in keys())
    parents = {x.digest() for x in genesis(c)}
    out = []
    for r in range(1, rounds + 1):
        nxt = set()
        for i, name in enumerate(names):
            cert = Certificate(header=Header(
                author=name, round=r, payload={Digest(bytes([r, i]) * 16): 0},
                parents=set(parents)))
            out.append(cert)
            nxt.add(cert.digest())
        parents = nxt
    return out


def test_commit_stamp_precedes_the_committed_line_and_the_downstream_puts(caplog):
    """The commit stamp is taken before each certificate's ``Committed``
    line, so not after the record's time; and it is there while the
    downstream put still waits on a full queue."""

    async def go():
        c = committee()
        rx, tx_primary, tx_output = asyncio.Queue(), asyncio.Queue(maxsize=1), asyncio.Queue()
        consensus = Consensus(c, 50, rx, tx_primary, tx_output, benchmark=True,
                              fixed_coin=True)
        task = asyncio.ensure_future(consensus.run())
        for cert in _certificates(c, 5):
            for digest in cert.header.payload:
                metrics.trace().entries.pop(bytes(digest).hex(), None)
            await rx.put(cert)
        loop = asyncio.get_running_loop()
        end = loop.time() + 10
        while sum("Committed" in r.getMessage() for r in caplog.records) < 2:
            assert loop.time() < end, "no two commits"
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        blocked = tx_primary.full() and not task.done()
        stamps = {k: dict(v) for k, v in metrics.trace().entries.items()}
        first = await tx_primary.get()
        second = await asyncio.wait_for(tx_primary.get(), 5)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        return blocked, stamps, [first, second]

    with caplog.at_level(logging.INFO, logger="narwhal.consensus"):
        blocked, stamps, committed = asyncio.run(asyncio.wait_for(go(), 20))
    assert blocked
    lines = {r.getMessage().rsplit(" -> ", 1)[1]: r.created for r in caplog.records
             if r.getMessage().startswith("Committed") and " -> " in r.getMessage()}
    for cert in committed:  # the second one's put was still waiting
        for digest in cert.header.payload:
            entry = stamps[bytes(digest).hex()]
            assert entry["walk_done"] <= entry["commit"] <= lines[repr(digest)]


# ------------------------------------------------------------- the waiters


def _header_waiter(c, name, store, rx, tx_core):
    return HeaderWaiter(name, c, store, AtomicRound(), gc_depth=50,
                        sync_retry_delay_ms=150, sync_retry_nodes=3,
                        rx_synchronizer=rx, tx_core=tx_core)


def test_header_waiter_counts_a_header_parked_on_parents_then_resumed(monkeypatch):
    monkeypatch.setattr(hw_mod, "TIMER_RESOLUTION", 0.05)

    async def go():
        c = committee(base_port=27120)
        kps = keys()
        receivers = [await Receiver.spawn(c.primary(kp.name).primary_to_primary,
                                          RecordingAckHandler()) for kp in kps[1:]]
        store, rx, tx_core = Store(), asyncio.Queue(), asyncio.Queue()
        waiter = _header_waiter(c, kps[0].name, store, rx, tx_core)
        task = asyncio.ensure_future(waiter.run())
        before = (_counter("primary.header_waiter.parked_parents"),
                  _counter("primary.header_waiter.retried_digests"),
                  _hist("primary.header_waiter.parked_seconds"))
        missing = Digest(bytes([7]) * 32)
        header = make_header(kps[1], round_=2, parents={missing}, c=c)
        await rx.put(("sync_parents", [missing], header))
        await asyncio.sleep(0.4)  # past sync_retry_delay: the timer asks again
        parked = _hist("primary.header_waiter.parked_seconds")
        store.write(bytes(missing), b"certificate")
        out = await asyncio.wait_for(tx_core.get(), 5)
        after = (_counter("primary.header_waiter.parked_parents"),
                 _counter("primary.header_waiter.retried_digests"),
                 _hist("primary.header_waiter.parked_seconds"))
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        waiter.sender.close()
        for r in receivers:
            await r.shutdown()
        return out.id == header.id, before, parked, after

    resumed, before, parked, after = asyncio.run(asyncio.wait_for(go(), 30))
    assert resumed
    assert after[0] - before[0] == 1
    assert after[1] - before[1] >= 1
    assert parked == before[2]  # nothing observed while it waits
    assert after[2][0] - before[2][0] == 1
    assert after[2][1] - before[2][1] >= 0.4


def test_header_waiter_counts_a_header_parked_on_batches_and_its_collection(monkeypatch):
    """Parked on a missing batch, then collected by the GC: counted and
    observed, and never resumed."""
    monkeypatch.setattr(hw_mod, "TIMER_RESOLUTION", 0.05)

    async def go():
        c = committee(base_port=27140)
        kps = keys()
        name = kps[0].name
        receiver = await Receiver.spawn(c.worker(name, 0).primary_to_worker,
                                        RecordingAckHandler())
        store, rx, tx_core = Store(), asyncio.Queue(), asyncio.Queue()
        consensus_round = AtomicRound()
        waiter = HeaderWaiter(name, c, store, consensus_round, gc_depth=5,
                              sync_retry_delay_ms=150, sync_retry_nodes=3,
                              rx_synchronizer=rx, tx_core=tx_core)
        task = asyncio.ensure_future(waiter.run())
        before = (_counter("primary.header_waiter.parked_batches"),
                  _hist("primary.header_waiter.parked_seconds"))
        digest = Digest(bytes([9]) * 32)
        header = make_header(kps[1], round_=2, c=c)
        await rx.put(("sync_batches", {digest: 0}, header))
        await asyncio.sleep(0.2)
        assert header.id in waiter.pending
        consensus_round.value = 20  # the header's round falls below the GC horizon
        await asyncio.sleep(0.2)
        gone = header.id not in waiter.pending and tx_core.empty()
        after = (_counter("primary.header_waiter.parked_batches"),
                 _hist("primary.header_waiter.parked_seconds"))
        store.write(payload_key(digest, 0), b"")
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        waiter.sender.close()
        await receiver.shutdown()
        return gone, before, after

    gone, before, after = asyncio.run(asyncio.wait_for(go(), 30))
    assert gone
    assert after[0] - before[0] == 1
    assert after[1][0] - before[1][0] == 1 and after[1][1] - before[1][1] >= 0.2


def test_certificate_waiter_counts_each_certificate_it_parks():
    async def go():
        c = committee()
        kps = keys()
        store, rx, tx_core = Store(), asyncio.Queue(), asyncio.Queue()
        waiter = CertificateWaiter(store, AtomicRound(), gc_depth=10,
                                   rx_synchronizer=rx, tx_core=tx_core)
        task = asyncio.ensure_future(waiter.run())
        before = _counter("primary.certificate_waiter.parked")
        parent = Digest(bytes([3]) * 32)
        cert = make_certificate(make_header(kps[1], round_=3, parents={parent}, c=c))
        await rx.put(cert)
        await rx.put(cert)  # already parked: not counted again
        await asyncio.sleep(0.1)
        store.write(bytes(parent), b"certificate")
        out = await asyncio.wait_for(tx_core.get(), 5)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        return out.digest() == cert.digest(), _counter("primary.certificate_waiter.parked") - before

    released, parked = asyncio.run(asyncio.wait_for(go(), 15))
    assert released and parked == 1


# --------------------------------------------------------------- the boot


def test_boot_phases_reach_the_primary_snapshot(monkeypatch):
    """A primary booted on the CPU with the consensus kernel's plain twins
    and the cuda backend's plain verifier: its registry holds the store,
    verify and consensus warm-up gauges.  The library and the CUDA
    context are timed only on a card; their gauges are declared."""
    from narwhal_tpu_torch.config import Parameters
    from narwhal_tpu_torch.crypto import backend
    from narwhal_tpu_torch.node import spawn_primary_node
    from narwhal_tpu_torch.ops import ed25519 as E

    names = ("node.boot.store_seconds", "node.boot.verify_warmup_seconds",
             "node.boot.consensus_warmup_seconds")
    for n in names:
        metrics.gauge(n).set(-1.0)
    warmed = []

    async def go():
        c = committee(base_port=27180)
        node = await spawn_primary_node(keys()[0], c, Parameters(), use_kernel=True,
                                        device="cpu")
        await node.shutdown()

    # The plain verifier's warm-up at every pad takes minutes on the CPU.
    monkeypatch.setattr(E.CudaBackend, "warmup", lambda self, **kw: warmed.append(kw))
    saved = backend.get_backend()
    try:
        backend.set_backend("cuda", device="cpu")
        asyncio.run(asyncio.wait_for(go(), 60))
    finally:
        backend._backend = saved
    gauges = metrics.registry().snapshot(include_trace=False)["gauges"]
    assert warmed and all(gauges[n] >= 0.0 for n in names), gauges
    assert "node.boot.library_seconds" in gauges
    assert "node.boot.cuda_context_seconds" in gauges


# ----------------------------------------------------------- the profiler


def test_profiler_is_armed_only_with_an_exporter(monkeypatch):
    monkeypatch.setenv("NARWHAL_PROFILE_HZ", "67")
    assert profiling.install_from_env(exported=False) is None
    prof = profiling.install_from_env(exported=True)
    try:
        assert prof is not None and prof.hz == 67.0
    finally:
        prof.shutdown()


def test_node_without_snapshot_path_or_port_runs_no_profiler(tmp_path):
    """Two workers through the node CLI: the one with ``--metrics-path``
    arms the sampler, the one with neither exporter does not."""
    chip_smoke.node_files(str(tmp_path), 4, 27160, chip_smoke.NODE_SALT)
    worker = ("worker", "--id", "0")
    with chip_smoke.NodeProcesses(str(tmp_path)) as procs:
        procs.start("bare", chip_smoke.node_command(str(tmp_path), 0, worker),
                    {"NARWHAL_PROFILE_HZ": "67"})
        procs.start("exported", chip_smoke.node_command(
            str(tmp_path), 1, worker, "--metrics-path",
            os.path.join(str(tmp_path), "metrics-1.json")),
            {"NARWHAL_PROFILE_HZ": "67"})
        missing = procs.wait_for({n: [chip_smoke.BOOTED] for n in ("bare", "exported")}, 60)
        assert not missing, [procs.log(n)[-2000:] for n in missing]
        procs.stop()
    assert "Sampling profiler armed" not in procs.log("bare")
    assert "Sampling profiler armed at 67.0 Hz" in procs.log("exported")


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
