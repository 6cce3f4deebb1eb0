"""The port's batched verifier (host prep, point ops and the plain PyTorch
verifier, on the CPU) against the JAX package's.

The hostile vectors are those of tests/test_ed25519.py: honest
signatures, bit-flip corruptions, S ≥ L, non-canonical y, a small-order
key, an off-curve key, the wrong key, S = 0, plus a small-order R and the
x = 0 / sign = 1 encoding.  All comparisons are exact (tolerance 0):
masks and prep arrays are ints/bools, field values are compared
canonically.  The JAX verifier is called exactly once, jitted, at pad 16
(its CPU compile is the cost of this file)."""

import asyncio
import random
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from narwhal_tpu.ops import ed25519 as JE
from narwhal_tpu.ops import field25519 as JF
from narwhal_tpu_torch.crypto import _ed25519_py as py
from narwhal_tpu_torch.ops import ed25519 as TE
from narwhal_tpu_torch.ops import field25519 as TF

P = TF.P


def _off_curve_y() -> int:
    y = 2
    while True:
        u = (y * y - 1) % P
        v = (TE.D_INT * y * y + 1) % P
        xx = u * pow(v, P - 2, P) % P
        if pow(xx, (P - 1) // 2, P) == P - 1:  # non-square: no x
            return y
        y += 1


def hostile_vectors():
    """16 (message, key, signature) rows, each a case of
    tests/test_ed25519.py (plus two R-side encodings)."""
    rng = random.Random(7)
    sks = [bytes([i + 1]) * 32 for i in range(3)]
    pks = [py.secret_to_public(s) for s in sks]
    rows = []
    for i in range(4):  # honest
        m = rng.randbytes(32)
        rows.append((m, pks[i % 3], py.sign(sks[i % 3], m)))
    m = rng.randbytes(32)
    sig = py.sign(sks[0], m)
    flipped_sig = bytearray(sig)
    flipped_sig[40] ^= 4
    flipped_key = bytearray(pks[0])
    flipped_key[3] ^= 1
    flipped_msg = bytearray(m)
    flipped_msg[0] ^= 0x80
    rows += [
        (m, pks[0], bytes(flipped_sig)),  # corrupted S
        (m, bytes(flipped_key), sig),  # corrupted key
        (bytes(flipped_msg), pks[0], sig),  # corrupted message
    ]
    s_int = int.from_bytes(sig[32:], "little")
    rows.append((m, pks[0], sig[:32] + (s_int + TE.L_ORDER).to_bytes(32, "little")))
    rows.append((m, (P + 3).to_bytes(32, "little"), sig))  # y ≥ p
    s = 12345  # A = identity: passes cofactorless math, small order
    rx, ry = TE._ref_scalarmult(s)
    r_bytes = (ry | ((rx & 1) << 255)).to_bytes(32, "little")
    rows.append((m, (1).to_bytes(32, "little"), r_bytes + s.to_bytes(32, "little")))
    rows.append((m, _off_curve_y().to_bytes(32, "little"), sig))
    rows.append((m, pks[1], sig))  # wrong key
    rows.append((m, pks[0], sig[:32] + bytes(32)))  # S = 0
    rows.append((m, pks[0], (1).to_bytes(32, "little") + sig[32:]))  # R small
    rows.append((m, (1 | (1 << 255)).to_bytes(32, "little"), sig))  # x=0, sign=1
    rows.append((m, pks[2], py.sign(sks[2], m)))  # honest
    assert len(rows) == 16
    return rows


EXPECTED = [True] * 4 + [False] * 11 + [True]


def _prep_both(rows, pad):
    msgs, keys, sigs = zip(*rows)
    return TE.prepare_batch(msgs, keys, sigs, pad), JE.prepare_batch(msgs, keys, sigs, pad)


@pytest.mark.parametrize("pad", [16, 32])
def test_prepare_batch_arrays_equal_jax(pad):
    ours, theirs = _prep_both(hostile_vectors(), pad)
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_prepare_batch_rejects_malformed_lengths():
    with pytest.raises(ValueError):
        TE.prepare_batch([b"m"], [b"short"], [bytes(64)], 16)


def _canon_point(p, canon):
    return [np.asarray(canon(c)) for c in p]


def test_decompress_matches_jax():
    rows = hostile_vectors()
    ours, _ = _prep_both(rows, 16)
    a_y, a_sign, a_canon = ours[0], ours[1], ours[2]
    t_pt, t_valid = TE.decompress(
        torch.from_numpy(a_y), torch.from_numpy(a_sign), torch.from_numpy(a_canon)
    )
    j_pt, j_valid = JE.decompress(
        jnp.asarray(a_y), jnp.asarray(a_sign), jnp.asarray(a_canon)
    )
    assert np.array_equal(t_valid.numpy(), np.asarray(j_valid))
    for t, j in zip(_canon_point(t_pt, lambda c: TF.canon(c).numpy()),
                    _canon_point(j_pt, JF.canon)):
        assert np.array_equal(t, j)


def test_point_add_double_match_jax():
    pts = [TE._ref_scalarmult(k) for k in (3, 5, 7, 11, 123456789)]
    coords = [
        np.stack([TF.to_limbs(c) for c in col])
        for col in zip(*[(x, y, 1, x * y % P) for x, y in pts])
    ]
    rolled = [np.roll(c, 1, axis=0) for c in coords]
    t1 = tuple(torch.from_numpy(c) for c in coords)
    t2 = tuple(torch.from_numpy(c) for c in rolled)
    j1 = tuple(jnp.asarray(c) for c in coords)
    j2 = tuple(jnp.asarray(c) for c in rolled)
    for t_out, j_out in (
        (TE.point_add(t1, t2), JE.point_add(j1, j2)),
        (TE.point_double(t1), JE.point_double(j1)),
    ):
        for t, j in zip(t_out, j_out):
            assert np.array_equal(TF.canon(t).numpy(), np.asarray(JF.canon(j)))


def test_plain_verifier_matches_jax_kernel_on_hostile_vectors():
    """The one JAX verify call of the port's tests: its mask, the port's
    plain mask and the expected verdicts are all equal."""
    rows = hostile_vectors()
    msgs, keys, sigs = zip(*rows)
    want = np.asarray(JE.verify_batch_arrays(msgs, keys, sigs))
    got = TE.verify_batch_arrays(msgs, keys, sigs, device="cpu")
    assert got.tolist() == want.tolist() == EXPECTED
    # The pure-Python signer's verifier agrees wherever strictness does
    # not differ (it accepts the small-order key row, index 9).
    for i, (m, k, s) in enumerate(rows):
        if i != 9:
            assert py.verify(k, m, s) == EXPECTED[i], i


def test_op_count_is_what_the_plain_verifier_runs(monkeypatch):
    """FIELD_MULS_PER_VERIFY and FIELD_SQS_PER_VERIFY (the bound's op
    counts) are counted, not guessed: they equal the field multiplies, and
    the squares among them, that one plain verify call runs."""
    calls = {"mul": 0, "square": 0}
    real_mul, real_square = TF.mul, TF.square

    def counting_mul(a, b):
        calls["mul"] += 1
        return real_mul(a, b)

    def counting_square(a):
        calls["square"] += 1
        return real_square(a)

    monkeypatch.setattr(TF, "mul", counting_mul)
    monkeypatch.setattr(TF, "square", counting_square)
    args = TE.to_device(TE.prepare_batch([], [], [], 16), "cpu")
    TE.verify_plain(*args)
    # A square is a mul of the plain field, so the muls count both.
    assert calls["mul"] == TE.FIELD_MULS_PER_VERIFY
    assert calls["square"] == TE.FIELD_SQS_PER_VERIFY


def test_cuda_backend_on_cpu_runs_off_the_event_loop():
    """CudaBackend(device="cpu") keeps the reference backend's surface: a
    dedicated dispatch thread, a responsive loop, the right mask."""
    from narwhal_tpu_torch.crypto import backend as cb
    from narwhal_tpu_torch.crypto.keys import PublicKey, Signature

    rows = hostile_vectors()[:3]
    backend = TE.CudaBackend(device="cpu")
    threads = []
    inner = backend.verify_batch_mask

    def recording(msgs, ks, ss):
        threads.append(threading.current_thread().name)
        return inner(msgs, ks, ss)

    backend.verify_batch_mask = recording

    async def go():
        ticks = []

        async def ticker():
            while True:
                ticks.append(1)
                await asyncio.sleep(0.001)

        t = asyncio.ensure_future(ticker())
        try:
            mask = await backend.averify_batch_mask(
                [m for m, _, _ in rows],
                [PublicKey(k) for _, k, _ in rows],
                [Signature(s) if i != 1 else Signature(bytes(64))
                 for i, (_, _, s) in enumerate(rows)],
            )
        finally:
            t.cancel()
        return mask, ticks

    mask, ticks = asyncio.run(go())
    assert mask == [True, False, True]
    assert threads and threads[0].startswith("cuda-verify"), threads
    assert ticks, "event loop starved during verify"

    cb.set_backend("cuda", device="cpu")
    try:
        assert cb.get_backend().name == "cuda"
        m, k, s = rows[0]
        assert cb.verify(m, PublicKey(k), Signature(s))
    finally:
        cb.set_backend("cpu")


def test_cancelled_caller_waits_for_the_burst_on_the_dispatch_thread():
    """A caller cancelled while its burst runs on the dispatch thread
    finishes cancelling only after the burst has ended, so a node's
    shutdown (which awaits its cancelled tasks) never leaves a launch
    counted and its timing not yet recorded."""
    from narwhal_tpu_torch.crypto.keys import PublicKey, Signature

    rows = hostile_vectors()[:2]
    backend = TE.CudaBackend(device="cpu")
    started, ended = threading.Event(), []

    def slow(msgs, ks, ss):
        started.set()
        threading.Event().wait(0.3)
        ended.append(1)
        return [True] * len(msgs)

    backend.verify_batch_mask = slow

    async def go():
        task = asyncio.ensure_future(backend.averify_batch_mask(
            [m for m, _, _ in rows], [PublicKey(k) for _, k, _ in rows],
            [Signature(s) for _, _, s in rows]))
        while not started.is_set():
            await asyncio.sleep(0.005)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return list(ended)

    assert asyncio.run(go()) == [1]
