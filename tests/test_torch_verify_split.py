"""The port's verifier batch split (``verify_sharded``, the counterpart of
the reference's NARWHAL_VERIFY_MESH path) on the CPU: shards of the plain
verifier, in order, must give the unsharded mask exactly.  The staging
layout and the split against the reference's mesh path are in
tests/test_torch_verify_staging.py.

The unsharded plain mask is held against the JAX verifier in
tests/test_torch_ed25519.py; nothing here calls the JAX verifier.  On the
card, chip_smoke.py holds the split against the single launch."""

import random

import numpy as np
import pytest

from narwhal_tpu_torch.crypto import _ed25519_py as py
from narwhal_tpu_torch.ops import ed25519 as TE

ROWS = 21
PAD = 32


@pytest.fixture(scope="module")
def batch():
    """21 rows of one key, S ≥ L on every fourth (the batch of
    tests/test_backend_differential.py's mesh test), the nine prep arrays
    at pad 32, and the unsharded plain mask."""
    rng = random.Random(0x5EED)
    sk = rng.randbytes(32)
    pk = py.secret_to_public(sk)
    rows = []
    for i in range(ROWS):
        m = rng.randbytes(32)
        s = py.sign(sk, m)
        if i % 4 == 0:
            s = s[:32] + (TE.L_ORDER + 5).to_bytes(32, "little")
        rows.append((m, pk, s))
    msgs, keys, sigs = zip(*rows)
    arrays = TE.prepare_batch(msgs, keys, sigs, PAD)
    plain = TE.verify_batch_arrays(msgs, keys, sigs, device="cpu")
    return arrays, plain, (msgs, keys, sigs)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_verify_sharded_equals_unsharded(batch, shards):
    arrays, plain, _ = batch
    got = TE.verify_sharded(arrays, ["cpu"] * shards)
    assert got.dtype == bool and got.shape == (PAD,)
    assert list(got[:ROWS]) == list(plain) == [i % 4 != 0 for i in range(ROWS)]
    assert not got[ROWS:].any()  # zero padding rows never verify


def test_verify_sharded_refuses_an_uneven_split(batch):
    arrays, _, _ = batch
    with pytest.raises(ValueError, match="equal shards"):
        TE.verify_sharded(arrays, ["cpu"] * 3)


@pytest.mark.parametrize("flag", [None, "0", "1"])
def test_mesh_devices_is_one_without_several_cards(monkeypatch, flag):
    if flag is None:
        monkeypatch.delenv("NARWHAL_VERIFY_MESH", raising=False)
    else:
        monkeypatch.setenv("NARWHAL_VERIFY_MESH", flag)
    monkeypatch.setattr(TE.torch.cuda, "is_available", lambda: False)
    assert TE.mesh_devices() == 1
    # Flag on with one visible card: still one.
    monkeypatch.setattr(TE.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(TE.torch.cuda, "device_count", lambda: 1)
    assert TE.mesh_devices() == 1
    # Several cards: the flag decides.
    monkeypatch.setattr(TE.torch.cuda, "device_count", lambda: 4)
    assert TE.mesh_devices() == (4 if flag == "1" else 1)


def test_pad_floor_follows_the_reference():
    assert [TE.pad_size(n) for n in (1, 16, 17, 33)] == [16, 16, 32, 64]
    assert [TE.pad_size(n, floor=16 * 4) for n in (1, 64, 65)] == [64, 64, 128]
    assert TE.pad_size(100, floor=48) == 192


@pytest.mark.parametrize("cards", [2, 4])
def test_backend_splits_a_batch_under_the_mesh_flag(batch, monkeypatch, cards):
    """``set_backend("cuda")``'s backend (made with no device) takes the
    split when the flag is on and several cards are visible: the cards
    are faked, and each shard runs the plain twin on the CPU."""
    _, plain, rows = batch
    monkeypatch.setenv("NARWHAL_VERIFY_MESH", "1")
    monkeypatch.setattr(TE.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(TE.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(TE.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(TE, "_load_consts", lambda device: None)
    split = TE.verify_sharded
    calls = []

    def fake_sharded(arrays, devices, on_kernel=None, report=None):
        calls.append((int(arrays[0].shape[0]), [str(d) for d in devices]))
        return split(arrays, ["cpu"] * len(devices), on_kernel, report)

    monkeypatch.setattr(TE, "verify_sharded", fake_sharded)
    backend = TE.CudaBackend()
    got = backend.verify_batch_mask(*rows)
    pad = TE.pad_size(ROWS, floor=16 * cards)
    assert calls == [(pad, [f"cuda:{k}" for k in range(cards)])]
    assert got == list(plain) == [i % 4 != 0 for i in range(ROWS)]
    # A backend bound to a named device never splits: one shard there.
    calls.clear()
    assert TE.CudaBackend("cpu").verify_batch_mask(*rows) == got
    assert calls == [(TE.pad_size(ROWS), ["cpu"])]
