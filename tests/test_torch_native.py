"""The port's ``native.py`` against the JAX package's, on the CPU.

The port binds the same repo-root ``native/dataplane.c`` (through
``native/Makefile``) and copies no C: both packages load one library
file.  ``tests/test_native.py`` runs again on the port (its C library and
its Python twin), and a seeded transaction stream seals to the same bytes,
transaction counts and sample ids through both packages' batchers."""

import random

import narwhal_tpu.native as jnative
import narwhal_tpu_torch.native as tnative
from narwhal_tpu_torch.network.framing import frame

from tests.test_torch_tasks import mirror

MIRRORED = mirror(globals(), "test_native")


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED) == 9


def test_both_packages_load_one_library():
    assert tnative._SRC_PATH == jnative._SRC_PATH
    assert tnative._LIB_PATH == jnative._LIB_PATH
    assert tnative.native_available() and jnative.native_available()


def _seal_all(native, stream, batch_size, chunk):
    batcher = native.make_batcher(batch_size)
    framer = native.make_framer(batcher)
    out = []
    for i in range(0, len(stream), chunk):
        ready = framer.feed(batcher, stream[i:i + chunk])
        while ready:
            out.append(batcher.seal())
            ready = framer.feed(batcher, b"")
    tail = batcher.seal()
    if tail is not None:
        out.append(tail)
    return [(s.message, s.tx_count, s.tx_bytes, list(s.samples)) for s in out]


def test_seeded_stream_seals_byte_identically():
    rng = random.Random(11)
    txs = []
    for i in range(600):
        size = rng.randrange(9, 300)
        if i % 7 == 0:
            tx = b"\x00" + i.to_bytes(8, "little") + bytes(size - 9)
        else:
            tx = b"\x01" + rng.randbytes(size - 1)
        txs.append(tx)
    stream = b"".join(frame(tx) for tx in txs)
    for batch_size, chunk in ((500, 97), (4096, 1000), (50_000, 4096)):
        want = _seal_all(jnative, stream, batch_size, chunk)
        got = _seal_all(tnative, stream, batch_size, chunk)
        assert got == want
        assert sum(n for _, n, _, _ in got) == len(txs)
        for message, n, _, _ in got:
            assert tnative.validate_batch(message) == n
            assert jnative.validate_batch(message) == n
