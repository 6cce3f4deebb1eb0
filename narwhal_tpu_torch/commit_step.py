"""The flagship commit step on the card: the f+1 support gate, then the
whole linked-leader chain with its per-slot reach masks.

The port of the commit-step program of ``__graft_entry__.py`` at the
repository root (``_window``, ``commit_fixture``, ``make_commit_step``,
``entry``).  :func:`make_commit_step` is one CUDA launch,
:func:`~.ops.reachability.commit_step_fused`: the chain scan's cluster,
whose blocks that are idle after the pack run the support gate while one
warp steps the chain.  :func:`entry` sets it up at BASELINE.json's
"50-node committee … large-DAG stress" size: N = 50 authorities, a window
of W = 64 slots.

The fixture generator is a copy of the reference's: it consumes the same
``numpy.random.default_rng(seed)`` stream, so its arrays equal the
reference's bit for bit.  The reference's committee-sharded dry run
(``dryrun_multichip``) is not ported here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .ops import resolve_device
from .ops.reachability import commit_step_fused

WINDOW = 64
COMMITTEE = 50


def _window(seed: int, window: int, n: int):
    """A random-but-causal DAG window: every cert references a quorum of
    the previous round."""
    rng = np.random.default_rng(seed)
    exists = rng.random((window, n)) < 0.9
    exists[0] = True  # genesis row
    parent = np.zeros((window, n, n), dtype=bool)
    quorum = 2 * ((n - 1) // 3) + 1
    for w in range(1, window):
        for i in range(n):
            if exists[w, i]:
                prev = np.flatnonzero(exists[w - 1])
                take = prev[rng.permutation(len(prev))[:quorum]]
                parent[w, i, take] = True
    return exists, parent


def commit_fixture(seed: int, window: int, n: int):
    """DAG window + leader schedule + anchor, as numpy arrays (the anchor
    slot an int), in the positional order of :func:`make_commit_step`'s
    step."""
    exists, parent = _window(seed, window, n)
    leader_onehot = np.zeros((window, n), dtype=bool)
    is_leader_slot = np.zeros(window, dtype=bool)
    for w in range(2, window - 2, 2):
        leader_onehot[w, w % n] = exists[w, w % n]
        is_leader_slot[w] = exists[w, w % n]
    stake = np.ones(n, dtype=np.int32)
    anchor_slot = window - 2
    anchor_idx = int(np.flatnonzero(exists[anchor_slot])[0])
    anchor_onehot = np.zeros(n, dtype=bool)
    anchor_onehot[anchor_idx] = True
    return (parent, exists, leader_onehot, is_leader_slot, stake,
            anchor_slot, anchor_onehot)


def make_commit_step(window: int) -> Callable:
    """One Tusk commit decision on tensors: the support of the leader two
    slots below the anchor, then the linked-leader chain and its reach
    masks.  The step is one launch for CUDA tensors (the two plain twins
    for CPU tensors), does not synchronise, and returns
    ``(support, committed, reach)``: a 0-d int32 tensor, bool[W] and
    bool[W, N] on the inputs' device.  Every anchor slot gives what the
    reference program gives under ``jax.jit``: the leader row
    ``anchor_slot - 2`` and the gate's child slot are traced indices, each
    counted from the end once when negative and then clamped into
    [0, W)."""

    def commit_step(parent, exists, leader_onehot, is_leader_slot, stake,
                    anchor_slot: int, anchor_onehot):
        if exists.shape[0] != window:
            raise ValueError(
                f"commit_step: window {exists.shape[0]} != {window}"
            )
        return commit_step_fused(parent, exists, leader_onehot, is_leader_slot,
                                 stake, anchor_slot, anchor_onehot)

    return commit_step


def entry(device=None) -> Tuple[Callable, tuple]:
    """``(step, args)`` for the flagship commit step at N = 50, W = 64 on
    ``device`` (None → the GPU; raises without one).  ``args`` are the
    fixture of seed 0 as tensors on that device; the anchor slot stays a
    Python int."""
    dev = resolve_device(device)
    fixture = commit_fixture(0, WINDOW, COMMITTEE)
    args = tuple(
        a if isinstance(a, int)
        else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in fixture
    )
    return make_commit_step(WINDOW), args
