"""The port's mirrored ring window (``WindowRing`` and the plain twin of
``window_update``, on the CPU) against JAX's ``window_shift_op`` followed
by ``window_apply``, at every origin of the ring.

Every comparison is exact (tolerance 0): the window holds int32 counts.
The CUDA kernel itself runs only on the GPU, where chip_smoke.py holds it
against the same plain twin."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from narwhal_tpu.ops import reachability as JR
from narwhal_tpu_torch.ops import reachability as TR
from tests.test_torch_reachability import _t, _window, assert_mirrored, ring_at

W, N = 16, 7
SHIFTS = [0, 1, 2, 5, W - 1, W, W + 3]


def _flush(rng, window: int, n: int, rows: int = 40):
    """A flush of ``rows`` entries at logical slots, with padding (slot
    ``window``, dropped) and one parent cell hit by two rows."""
    ins_w = rng.integers(0, window + 1, rows).astype(np.int32)
    ins_i = rng.integers(0, n, rows).astype(np.int32)
    row_w = rng.integers(0, window + 1, rows).astype(np.int32)
    row_c = rng.integers(0, n, rows).astype(np.int32)
    row_v = (rng.random((rows, n)) < 0.4).astype(np.int32)
    row_w[1], row_c[1] = row_w[0] % window, row_c[0]
    row_w[0] = row_w[1]
    ins_w[1], ins_i[1] = ins_w[0] % window, ins_i[0]
    ins_w[0] = ins_w[1]
    return ins_w, ins_i, row_w, row_c, row_v


def _jax_step(state, d=None, flush=None):
    je, jp = state
    if d is not None:
        je, jp = JR.window_shift_op(je, jp, jnp.int32(d), W)
    if flush is not None:
        je, jp = JR.window_apply(je, jp, *flush)
    return je, jp


def _assert_view(ring, state):
    assert np.array_equal(ring.exists.numpy(), np.asarray(state[0]))
    assert np.array_equal(ring.parent.numpy(), np.asarray(state[1]))
    assert_mirrored(ring)


@pytest.mark.parametrize("d", SHIFTS)
@pytest.mark.parametrize("origin", range(W))
def test_shift_then_update_matches_jax(origin, d):
    """Shift by d, then one update with a flush (the commit path's launch),
    from every origin: the logical view equals JAX's shift then apply."""
    rng = np.random.default_rng(1000 * origin + d)
    exists, parent = _window(rng, W, N)
    flush = _flush(rng, W, N)
    want = _jax_step((jnp.asarray(exists), jnp.asarray(parent)), d, flush)
    ring = ring_at(exists, parent, origin)
    ring.shift(d)
    ring.update(tuple(_t(a) for a in flush))
    assert not ring.pending
    _assert_view(ring, want)


@pytest.mark.parametrize("seed", range(8))
def test_shifts_flushes_and_reads_in_any_order(seed):
    """Random runs of shifts (several may pile up before one launch),
    flushes and reads: after every read the view equals JAX's sequence."""
    rng = np.random.default_rng(50 + seed)
    exists, parent = _window(rng, W, N)
    state = (jnp.asarray(exists), jnp.asarray(parent))
    ring = ring_at(exists, parent, int(rng.integers(W)))
    reads = 0
    for _ in range(30):
        op = rng.integers(3)
        if op == 0:
            d = int(rng.choice([0, 1, 2, 3, W - 2, W + 1], p=[.1, .3, .3, .2, .07, .03]))
            ring.shift(d)
            state = _jax_step(state, d=d)
        elif op == 1:
            flush = _flush(rng, W, N, rows=int(rng.integers(2, 24)))
            ring.update(tuple(_t(a) for a in flush))
            state = _jax_step(state, flush=flush)
        else:
            _assert_view(ring, state)
            reads += 1
    _assert_view(ring, state)
    assert reads > 0


@pytest.mark.parametrize("retired,clear_slot0", [(0, False), (0, True), (3, True), (W - 1, False)])
def test_update_plain_clears_only_the_named_slots(retired, clear_slot0):
    """``window_update_plain`` on a junk-filled ring with no flush: the
    retired slots below the origin lose exists and parent, the origin loses
    its parent block, in both copies, and nothing else changes."""
    origin = 5
    e2 = torch.arange(2 * W * N, dtype=torch.int32).view(2 * W, N) + 1
    p2 = torch.arange(2 * W * N * N, dtype=torch.int32).view(2 * W, N, N) + 1
    we, wp = e2.clone(), p2.clone()
    for k in range(1, retired + 1):
        s = (origin - k) % W
        for copy in (0, W):
            we[s + copy] = 0
            wp[s + copy] = 0
    if clear_slot0:
        wp[origin] = 0
        wp[origin + W] = 0
    TR.window_update_plain(e2, p2, window=W, origin=origin, retired=retired,
                           clear_slot0=clear_slot0)
    assert torch.equal(e2, we) and torch.equal(p2, wp)


def test_ring_and_update_refuse_bad_arguments():
    with pytest.raises(ValueError):
        TR.WindowRing(12, N, "cpu")  # not a power of two
    ring = TR.WindowRing(W, N, "cpu")
    with pytest.raises(ValueError):
        ring.shift(-1)
    for kwargs in (dict(window=W, origin=W), dict(window=W, retired=W),
                   dict(window=W - 1)):
        with pytest.raises(ValueError):
            TR.window_update(ring.exists2, ring.parent2, **kwargs)


def test_update_refuses_a_window_beyond_32_bit_indexing():
    """2W·N² counts must fit in int32 for the kernel's index arithmetic
    (meta tensors: the check runs before anything is allocated)."""
    W2, N2 = 1024, 1024
    e = torch.empty((2 * W2, N2), dtype=torch.int32, device="meta")
    p = torch.empty((2 * W2, N2, N2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        TR.window_update(e, p, window=W2, retired=1)
