"""The port's ``store.py`` against the JAX package's, on the CPU: one
seeded sequence of writes, deferred writes, flushes, reads and
``notify_read`` waits goes into a reference ``Store`` and a port ``Store``,
each on its own file; both must give the same reads and byte-identical
log files, before and after reopening.  Then every case of
``tests/test_store.py`` runs again on the port."""

import asyncio
import random

import pytest

from narwhal_tpu.store import Store as JStore
from narwhal_tpu_torch.store import Store as TStore

from tests.test_torch_tasks import mirror

MIRRORED = mirror(globals(), "test_store")


def test_mirror_covers_every_reference_case():
    assert len(MIRRORED) == 14


def _ops(seed: int, n: int = 300):
    rng = random.Random(seed)
    keys = [bytes([rng.randrange(256)]) * rng.randrange(1, 40) for _ in range(24)]
    ops = []
    for _ in range(n):
        kind = rng.choices(
            ["write", "deferred", "flush", "read", "wait"], [5, 4, 1, 4, 2]
        )[0]
        key = rng.choice(keys)
        value = rng.randbytes(rng.randrange(0, 300))
        ops.append((kind, key, value))
    return ops


async def _drive(store_cls, path, ops):
    store = store_cls(path)
    out, waits = [], []
    try:
        for kind, key, value in ops:
            if kind == "write":
                store.write(key, value)
            elif kind == "deferred":
                store.write_deferred(key, value)
            elif kind == "flush":
                store.flush_deferred()
            elif kind == "read":
                out.append(store.read(key))
            else:
                waits.append(asyncio.ensure_future(store.notify_read(key)))
                await asyncio.sleep(0)
                out.append(waits[-1].done())
        # Settle the waits that a later write resolved; cancel the rest.
        await asyncio.sleep(0)
        out.append([w.result() if w.done() else None for w in waits])
        for w in waits:
            w.cancel()
        await asyncio.gather(*waits, return_exceptions=True)
        out.append(sorted(store.values()))
    finally:
        store.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_give_same_reads_and_log_bytes(tmp_path, seed):
    ops = _ops(seed)
    paths = {name: str(tmp_path / name / "store.log") for name in ("jax", "torch")}
    want = asyncio.run(_drive(JStore, paths["jax"], ops))
    got = asyncio.run(_drive(TStore, paths["torch"], ops))
    assert got == want
    logs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert logs["torch"] == logs["jax"] and len(logs["jax"]) > 0
    # Reopen each log with the other package's Store and with its own:
    # every reopened store holds the same map.
    maps = []
    for cls in (JStore, TStore):
        for p in paths.values():
            s = cls(p)
            maps.append({k: s.read(k) for _, k, _ in ops})
            s.close()
    assert all(m == maps[0] for m in maps)
    # A second run on the reopened files appends the same bytes.
    more = _ops(seed + 100, 80)
    asyncio.run(_drive(JStore, paths["jax"], more))
    asyncio.run(_drive(TStore, paths["torch"], more))
    assert open(paths["torch"], "rb").read() == open(paths["jax"], "rb").read()


def test_torn_tail_is_dropped_alike(tmp_path):
    paths = [str(tmp_path / n / "store.log") for n in ("jax", "torch")]
    for cls, p in zip((JStore, TStore), paths):
        s = cls(p)
        s.write(b"a", b"1" * 10)
        s.write(b"b", b"2" * 10)
        s.close()
        with open(p, "ab") as f:
            f.write(b"\x05\x00\x00\x00\x09\x00")  # a torn record header
    reads = []
    for cls, p in zip((JStore, TStore), paths):
        s = cls(p)
        s.write(b"c", b"3")
        reads.append([s.read(k) for k in (b"a", b"b", b"c")])
        s.close()
    assert reads[0] == reads[1] == [b"1" * 10, b"2" * 10, b"3"]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
