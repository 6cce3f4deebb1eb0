"""The port's flagship commit step and its three bool-window kernels
(plain PyTorch twins, on the CPU) against the JAX programs they replace:
``__graft_entry__``'s commit step, ``leader_chain_scan``,
``causal_mask_scan`` and ``support_stake``.

Every comparison here is exact (tolerance 0): all values are bools or
int32 sums.  The CUDA kernels themselves run only on the GPU, where
chip_smoke.py holds each against these twins."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as G
import chip_smoke
from narwhal_tpu.ops import reachability as JR
from narwhal_tpu_torch import commit_step as CS
from narwhal_tpu_torch.ops import reachability as TR

from tests.test_torch_reachability import (  # noqa: F401  (fixture)
    SCENARIOS,
    _carry,
    _feed,
    _scenario,
    _window,
    wire_committee,
)

FIXTURES = [(0, 64, 50), (1, 16, 32)]
W, N = 16, 7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bool_window(seed, window=W, n=N, dangling=False):
    """A random causal window as bools; with ``dangling`` a tenth of the
    certificates are then dropped from ``exists`` while their children
    keep citing them, so the programs' ``& exists`` is exercised."""
    rng = np.random.default_rng(seed)
    exists, parent = _window(rng, window, n)
    exists = exists > 0
    if dangling:
        exists &= rng.random(exists.shape) < 0.9
    return exists, parent > 0


def _leaders(rng, exists):
    window, n = exists.shape
    leader_onehot = np.zeros((window, n), dtype=bool)
    is_leader_slot = np.zeros(window, dtype=bool)
    for w in range(2, window - 1, 2):
        who = int(rng.integers(n))
        leader_onehot[w, who] = exists[w, who]
        is_leader_slot[w] = exists[w, who]
    return leader_onehot, is_leader_slot


def _onehot(i, n=N):
    out = np.zeros(n, dtype=bool)
    out[i] = True
    return out


@pytest.mark.parametrize("seed,window,n", FIXTURES)
def test_fixture_equals_reference(seed, window, n):
    ours = CS.commit_fixture(seed, window, n)
    ref = G.commit_fixture(seed, window, n)
    assert len(ours) == len(ref) == 7
    for a, b in zip(ours, ref):
        if isinstance(b, int):
            assert a == b and isinstance(a, int)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed,window,n", FIXTURES)
def test_commit_step_equals_jax(seed, window, n):
    fixture = G.commit_fixture(seed, window, n)
    j_support, j_committed, j_reach = G.make_commit_step(window)(
        *fixture[:5], np.int32(fixture[5]), fixture[6]
    )
    args = tuple(a if isinstance(a, int) else _t(a)
                 for a in CS.commit_fixture(seed, window, n))
    support, committed, reach = CS.make_commit_step(window)(*args)
    assert support.dtype == torch.int32 and support.dim() == 0
    assert int(support) == int(j_support)
    assert np.array_equal(committed.numpy(), np.asarray(j_committed))
    assert np.array_equal(reach.numpy(), np.asarray(j_reach))
    if (seed, window, n) == (0, 64, 50):
        # The flagship's values, which chip_smoke.py asks of the card.
        assert (int(support), int(committed.sum()), int(reach.sum())) == (28, 26, 2477)


ANCHOR_FIXTURES = [(0, 64, 50), (1, 16, 7)]


@pytest.fixture(scope="module")
def jax_steps():
    """The reference commit step under ``jax.jit`` (its anchor slot a
    traced index, as the program is traced in ``__graft_entry__``), one
    per window."""
    return {window: jax.jit(G.make_commit_step(window))
            for window in {w for _, w, _ in ANCHOR_FIXTURES}}


# Anchor slots as functions of the window W.
ANCHORS = {"-W": lambda w: -w, "-1": lambda w: -1, "0": lambda w: 0,
           "1": lambda w: 1, "W-2": lambda w: w - 2, "W-1": lambda w: w - 1,
           "W": lambda w: w, "W+1": lambda w: w + 1, "W+2": lambda w: w + 2,
           "W+5": lambda w: w + 5}


@pytest.mark.parametrize("anchor", ANCHORS)
@pytest.mark.parametrize("seed,window,n", ANCHOR_FIXTURES)
def test_make_commit_step_matches_jax_at_every_anchor(seed, window, n, anchor,
                                                      jax_steps):
    """Anchors inside, at the edges of and outside the window: the leader
    row ``anchor_slot - 2`` and the gate's child slot follow JAX's rule
    for a traced index (from the end once when negative, then clamped), so
    the port returns where a Python index would raise."""
    anchor_slot = ANCHORS[anchor](window)
    fixture = G.commit_fixture(seed, window, n)
    j_support, j_committed, j_reach = jax_steps[window](
        *fixture[:5], np.int32(anchor_slot), fixture[6])
    args = [a if isinstance(a, int) else _t(a)
            for a in CS.commit_fixture(seed, window, n)]
    args[5] = anchor_slot
    support, committed, reach = CS.make_commit_step(window)(*args)
    assert support.dtype == torch.int32 and support.dim() == 0
    assert int(support) == int(j_support)
    assert np.array_equal(committed.numpy(), np.asarray(j_committed))
    assert np.array_equal(reach.numpy(), np.asarray(j_reach))


def test_entry_on_cpu_is_the_flagship_fixture():
    step, args = CS.entry("cpu")
    assert all(a.device.type == "cpu" for a in args if torch.is_tensor(a))
    assert args[5] == 62 and args[0].shape == (64, 50, 50)
    support, committed, reach = step(*args)
    assert (int(support), int(committed.sum()), int(reach.sum())) == (28, 26, 2477)


@pytest.mark.parametrize("seed", range(4))
def test_leader_chain_scan_plain_equals_jax(seed):
    rng = np.random.default_rng(300 + seed)
    exists, parent = _bool_window(300 + seed, dangling=seed % 2 == 1)
    leader_onehot, is_leader_slot = _leaders(rng, exists)
    no_leaders = np.zeros_like(leader_onehot)
    cases = [
        (W - 2, leader_onehot, is_leader_slot),
        (W - 1, leader_onehot, is_leader_slot),
        (int(rng.integers(3, W - 2)), leader_onehot, is_leader_slot),
        (W - 2, no_leaders, np.zeros_like(is_leader_slot)),  # no linked leader
        (W, leader_onehot, is_leader_slot),  # outside the window
        (-1, leader_onehot, is_leader_slot),
    ]
    for anchor_slot, lo, isl in cases:
        anchor = _onehot(int(rng.integers(N)))
        jc, jr = JR.leader_chain_scan(
            jnp.asarray(parent), jnp.asarray(exists), lo, isl,
            jnp.int32(anchor_slot), anchor, W,
        )
        tc, tr = TR.leader_chain_scan(
            _t(parent), _t(exists), _t(lo), _t(isl), anchor_slot, _t(anchor)
        )
        assert np.array_equal(tc.numpy(), np.asarray(jc)), anchor_slot
        assert np.array_equal(tr.numpy(), np.asarray(jr)), anchor_slot
        if not lo.any():
            assert not tc.any()


@pytest.mark.parametrize("seed", range(6))
def test_chain_scan_on_a_count_window_commits_like_commit_scan(seed):
    rng = np.random.default_rng(400 + seed)
    exists, parent = _window(rng, W, N)
    leader_onehot, is_leader_slot = _leaders(rng, exists > 0)
    anchor_slot = W - 1 - int(rng.integers(0, 3))
    anchor = _onehot(int(rng.integers(N)))
    args = (_t(leader_onehot), _t(is_leader_slot), anchor_slot, _t(anchor))
    counts = TR.leader_commit_scan_plain(_t(parent), _t(exists), *args)
    committed, _ = TR.leader_chain_scan_plain(_t(parent) > 0, _t(exists) > 0, *args)
    assert torch.equal(counts, committed)


def _host_cone(parent, exists, w0, i0):
    window, n = exists.shape
    want = np.zeros((window, n), dtype=bool)
    if not 0 <= w0 < window:
        return want
    want[w0, i0] = True
    for w in range(w0, 0, -1):
        for i in np.flatnonzero(want[w]):
            want[w - 1] |= parent[w, i] & exists[w - 1]
    return want


@pytest.mark.parametrize("seed", range(5))
def test_causal_mask_scan_plain_equals_jax_and_host_bfs(seed):
    rng = np.random.default_rng(42 + seed)
    window, n = 16, 8
    exists = rng.random((window, n)) < 0.8
    exists[0] = True
    parent = np.zeros((window, n, n), dtype=bool)
    for w in range(1, window):
        for i in range(n):
            if exists[w, i]:
                prev = np.flatnonzero(exists[w - 1])
                if len(prev):
                    take = rng.choice(prev, size=min(3, len(prev)), replace=False)
                    parent[w, i, take] = True
    if seed % 2:
        # Dangling edges: cited certificates missing from exists.
        exists &= rng.random(exists.shape) < 0.9
    starts = np.argwhere(exists)
    w0, i0 = (int(x) for x in starts[rng.integers(len(starts))])
    for start_slot in (w0, window - 1, window, -1):
        onehot = _onehot(i0, n)
        want = np.asarray(JR.causal_mask_scan(
            jnp.asarray(parent), jnp.asarray(exists), jnp.int32(start_slot),
            jnp.asarray(onehot), window,
        ))
        got = TR.causal_mask_scan(_t(parent), _t(exists), start_slot, _t(onehot)).numpy()
        assert np.array_equal(got, want), start_slot
        if start_slot == w0:
            assert np.array_equal(got, _host_cone(parent, exists, w0, i0))
        if not 0 <= start_slot < window:
            assert not got.any()


@pytest.mark.parametrize("seed", range(3))
def test_support_stake_plain_equals_jax_at_every_slot(seed):
    """Every leader slot in [-1, W-1], and a few beyond it on both sides,
    where JAX's dynamic index wraps once and then clamps."""
    rng = np.random.default_rng(500 + seed)
    exists, parent = _bool_window(500 + seed, dangling=True)
    stake = rng.integers(1, 100, N).astype(np.int32)
    jp, je, js = jnp.asarray(parent), jnp.asarray(exists), jnp.asarray(stake)
    for leader_slot in range(-3 - W, W + 2):
        onehot = _onehot(int(rng.integers(N)))
        want = int(JR.support_stake(jp, je, js, jnp.int32(leader_slot),
                                    jnp.asarray(onehot), W))
        got = TR.support_stake(_t(parent), _t(exists), _t(stake), leader_slot,
                               _t(onehot))
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == want, leader_slot


@pytest.mark.parametrize("name", SCENARIOS)
def test_live_window_kernels_agree_with_the_tusk(name, wire_committee):
    """chip_smoke.py's live-window check, on the CPU: at every commit
    opportunity of the port's KernelTusk, support_stake on the live
    window equals the host's f+1 gate count, the chain scan's committed
    slots are the chain order_leaders returned, and every committed
    leader's causal mask equals a host BFS and holds what order_dag
    emitted."""
    _, tc = wire_committee
    certs, gc_depth = _scenario(name)
    tk = TR.KernelTusk(tc, gc_depth=gc_depth, fixed_coin=True, device="cpu")
    check = chip_smoke.LiveWindowCheck(tk).install()
    _feed(tk, _carry(certs))
    counts = check.counts
    assert check.failures == []
    assert counts["opportunities"] == (counts["chain_checked"]
                                       + counts["skipped_python_walk"])
    assert counts["skipped_python_walk"] == tk.python_fallbacks
    if name != "missing_leader":  # (the scenario reaches no commit)
        assert counts["support_checked"] > 0
        assert counts["cones_checked"] > 0 and counts["emitted_in_window"] > 0
