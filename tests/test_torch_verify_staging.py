"""The verifier's staged launcher on the CPU: the staging layout
(``stage_layout`` / ``stage_views``) at the pads a node and the kernels
phase use, split into 1, 2, 4 and 8 shards, and the split held to the
reference's NARWHAL_VERIFY_MESH path over the conftest's 8-device CPU mesh.

Pinned buffers and streams need a card; chip_smoke.py checks them there.
Here the views are taken of a plain CPU uint8 buffer, which is also what
a CPU shard of ``verify_sharded`` runs on."""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from narwhal_tpu.ops import ed25519 as JE
from narwhal_tpu_torch.crypto import _ed25519_py as py
from narwhal_tpu_torch.ops import ed25519 as TE

PADS = (16, 64, 2048, 16384)
SHARDS = (1, 2, 4, 8)
JUNK = 0xA5


@pytest.fixture(scope="module")
def batches():
    """Per pad: the nine prep arrays of random (message, key, signature)
    rows filling it (the layout does not care whether they verify)."""
    rng = np.random.default_rng(0x57A6E)
    out = {}
    for pad in PADS:
        msgs = [bytes(m) for m in rng.integers(0, 256, (pad, 40), dtype=np.uint8)]
        keys = [bytes(k) for k in rng.integers(0, 256, (pad, 32), dtype=np.uint8)]
        sigs = [bytes(s) for s in rng.integers(0, 256, (pad, 64), dtype=np.uint8)]
        out[pad] = TE.prepare_batch(msgs, keys, sigs, pad)
    return out


def segments(rows):
    offsets, size = TE.stage_layout(rows)
    lengths = [rows * dtype.itemsize * int(np.prod(shape, dtype=int))
               for _, dtype, shape in TE.STAGED]
    return offsets, lengths, size


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("pad", PADS)
def test_stage_layout_is_aligned_disjoint_and_ordered(pad, shards):
    rows = pad // shards
    offsets, lengths, size = segments(rows)
    assert [name for name, _, _ in TE.STAGED] == [
        "a_y", "a_sign", "a_canon", "r_y", "r_sign", "r_canon",
        "s_windows", "s_ok", "k_windows"]
    assert all(off % TE.STAGE_ALIGN == 0 for off in offsets)
    ends = [off + n for off, n in zip(offsets, lengths)]
    # In the kernel's order, each segment wholly before the next.
    assert offsets[0] == 0
    assert all(end <= nxt for end, nxt in zip(ends, offsets[1:]))
    assert ends[-1] <= size < ends[-1] + TE.STAGE_ALIGN
    assert sum(lengths) == 779 * rows
    # Gaps are only the rounding to 16 bytes.
    assert all(nxt - end < TE.STAGE_ALIGN for end, nxt in zip(ends, offsets[1:]))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("pad", PADS)
def test_stage_views_round_trip_the_prep_arrays(batches, pad, shards):
    """Each shard's nine arrays, copied into the views of a junk-filled
    uint8 buffer as the launcher fills a stage, read back bit for bit;
    the bytes between segments are never written."""
    arrays = batches[pad]
    rows = pad // shards
    offsets, lengths, size = segments(rows)
    written = np.zeros(size, dtype=bool)
    for off, n in zip(offsets, lengths):
        written[off : off + n] = True
    for k in range(shards):
        part = [a[k * rows : (k + 1) * rows] for a in arrays]
        buf = torch.full((size,), JUNK, dtype=torch.uint8)
        views = TE.stage_views(buf, rows)
        TE._copy_into([v.numpy() for v in views], part)
        for v, (_, dtype, shape), want in zip(views, TE.STAGED, part):
            assert v.dtype == dtype and tuple(v.shape) == (rows, *shape)
            assert v.is_contiguous()
            assert v.numpy().dtype == want.dtype
            assert v.numpy().tobytes() == np.ascontiguousarray(want).tobytes()
        assert (buf.numpy()[~written] == JUNK).all()


def reference_mesh_kernel(n_dev):
    """The reference's ``_mesh_verify_kernel(n_dev)`` program: a jit of a
    shard_map of its un-jitted ``_verify_kernel`` over a 1-D ``batch``
    mesh of every device, all nine inputs and the mask split along the
    batch.  Built here with ``check_vma=False``: the reference builds it
    with the type check on, which this JAX version refuses for the
    unsharded initial carry of the ``lax.scan`` in field25519's
    ``_sub_p``.  The computation is the same."""
    spec = PartitionSpec("batch")
    return jax.jit(jax.shard_map(
        JE._verify_kernel.__wrapped__,
        mesh=Mesh(np.array(jax.devices()), ("batch",)),
        in_specs=(spec,) * 9, out_specs=spec, check_vma=False))


def test_split_matches_the_reference_mesh_path(monkeypatch):
    """The batch of tests/test_backend_differential.py's mesh test (21
    rows of one key, S ≥ L on every fourth): the reference's
    ``verify_batch_arrays`` under NARWHAL_VERIFY_MESH=1 over the 8-device
    CPU mesh (pad floor 16 × 8) and the port's ``verify_sharded`` over
    eight CPU shards of the same pad give the same mask, tolerance 0."""
    rng = random.Random(0x3E5)
    sk = rng.randbytes(32)
    pk = py.secret_to_public(sk)
    rows = []
    for i in range(21):
        m = rng.randbytes(32)
        s = py.sign(sk, m)
        if i % 4 == 0:
            s = s[:32] + (TE.L_ORDER + 5).to_bytes(32, "little")
        rows.append((m, pk, s))
    msgs, keys, sigs = zip(*rows)
    n_dev = len(jax.devices())
    assert n_dev == 8
    monkeypatch.setenv("NARWHAL_VERIFY_MESH", "1")
    assert JE.mesh_devices() == n_dev
    monkeypatch.setitem(JE._mesh_kernel_cache, n_dev, reference_mesh_kernel(n_dev))
    want = np.asarray(JE.verify_batch_arrays(msgs, keys, sigs))
    pad = TE.pad_size(len(rows), floor=16 * n_dev)
    assert pad == 128
    got = TE.verify_sharded(TE.prepare_batch(msgs, keys, sigs, pad), ["cpu"] * n_dev)
    assert got.shape == (pad,) and not got[len(rows):].any()
    assert got[: len(rows)].tolist() == want.tolist() == [i % 4 != 0 for i in range(21)]
