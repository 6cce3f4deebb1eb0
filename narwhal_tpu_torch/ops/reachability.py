"""Tusk's DAG window on the card: eight hand-written CUDA kernels.

The port of ``narwhal_tpu/ops/reachability.py``.  The commit path's
window is a pair of int32 presence-COUNT tensors that live on ``device``
across calls — ``exists[W, N]`` (certificate present at slot w, authority
n) and ``parent[W, N, N]`` (cert (w, n) references cert (w-1, m)) —
kept as a mirrored ring (:class:`WindowRing`: 2W physical slots, slot p
and p + W equal, so the logical window is one contiguous view) and
maintained and read by two kernels (csrc/reachability.cu):

- :func:`window_update` zeroes the slots the last shifts retired and
  scatter-adds a flush of staged certificates, in one launch (replaces
  the JAX ``window_shift_op`` followed by ``window_apply``; the ring's
  shift itself only moves its origin, and :func:`window_apply` keeps the
  JAX signature for a plain window);
- :func:`leader_commit_scan` runs the whole linked-leader chain in one
  launch and returns the W-bool committed bitmap (replaces
  ``leader_commit_scan_counts`` and its body ``_chain_scan``).

Four more take the window as bools, as the JAX programs do:

- :func:`leader_chain_scan`, the same chain (one scan body with
  :func:`leader_commit_scan` in the CUDA source) that also returns the
  per-slot reach masks (replaces ``leader_chain_scan``);
- :func:`causal_mask_scan`, the causal cone of one certificate (replaces
  ``causal_mask_scan``);
- :func:`support_stake`, the f+1 support gate's stake sum (replaces
  ``support_stake``);
- :func:`commit_step_fused`, the flagship commit step of
  ``narwhal_tpu_torch/commit_step.py`` (the JAX ``support_stake`` and
  ``leader_chain_scan`` traced as one program) in one launch: the chain
  scan's, with the support gate run beside the scan.

One more runs the same commit step with the committee's columns split
over the ranks of a process group, as ``jax.jit`` of the step runs it
over a ``committee`` mesh (:func:`commit_step_sharded`):
:func:`commit_step_block`, one slot of the chain on a rank's block of
columns with its part of the support gate; the ranks all-gather each
slot's record with ``torch.distributed``, and on NCCL a step is one CUDA
graph.

Where the JAX programs donate their buffers, the port updates the
window tensors in place.  Each wrapper launches its kernel for a CUDA
tensor and runs the plain PyTorch twin beside it only for a CPU tensor;
the twin is what the CPU tests hold against the JAX programs.  The
window kernels take N <= 1024.

The three scans share one kernel body (``csrc/window_bits.cuh``): a
cluster of eight blocks packs the window into bits in the first block's
shared memory, then one warp steps the W slots on those bits, a step
being a few shared loads, one warp OR reduction per 32-bit word and some
ANDs, with no block barrier and no global load inside it.  A window
larger than shared memory is scanned in chunks of slots, the frontier
carried across them.  The support gate is written once in the same file:
a warp packs 32 child rows into bits in its own shared memory and tests
each against the leader's bit words.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import metrics
from . import (
    capturing,
    check_launch,
    count_launches,
    kernel_fn,
    open_context,
    ptr,
    require,
    resolve_device,
    stream_handle,
    warming,
)

# Kernel observability, under the reference's names (bench JSON keys on
# them): staged flush sizes and the device work the commit path issues.
_m_flush_batch = metrics.histogram(
    "consensus.kernel.flush_batch_size", metrics.COUNT_BUCKETS
)
_m_dispatches = metrics.counter("consensus.kernel.dispatches")
_m_shifts = metrics.counter("consensus.kernel.window_shifts")
_m_fallbacks = metrics.counter("consensus.kernel.python_fallbacks")

_VP, _I = ctypes.c_void_p, ctypes.c_int


# --------------------------------------------------------------- window_update


def window_update_plain(exists, parent, flush=None, *, window: int,
                        origin: int = 0, retired: int = 0,
                        clear_slot0: bool = False):
    """Plain twin of :func:`window_update`: the clears by indexing, the
    flush by index_add_ on flat views, in each copy.  A flush entry's slot
    in [-W, 0) or authority in [-N, 0) counts from the end; entries still
    outside the window are dropped (the JAX ``mode="drop"``)."""
    W = window
    S, N = exists.shape
    copies = S // W
    dev = exists.device
    gone = torch.arange(origin - retired, origin, device=dev) % W
    for c in range(copies):
        exists[gone + c * W] = 0
        parent[gone + c * W] = 0
        if clear_slot0:
            parent[origin + c * W] = 0
    if flush is None:
        return exists, parent
    ins_w, ins_i, row_w, row_c = (_wrap(t, n) for t, n in zip(flush[:4], (W, N, W, N)))
    row_v = flush[4]
    keep = (ins_w >= 0) & (ins_w < W) & (ins_i >= 0) & (ins_i < N)
    slot = (ins_w[keep] + origin) % W
    ones = torch.ones(slot.shape, dtype=exists.dtype, device=dev)
    keep_r = (row_w >= 0) & (row_w < W) & (row_c >= 0) & (row_c < N)
    slot_r = (row_w[keep_r] + origin) % W
    for c in range(copies):
        exists.view(-1).index_add_(0, (slot + c * W) * N + ins_i[keep], ones)
        parent.view(S * N, N).index_add_(
            0, (slot_r + c * W) * N + row_c[keep_r], row_v[keep_r])
    return exists, parent


def _wrap(index, n: int):
    """``index`` as int64 with the entries in [-n, 0) counted from the end,
    as JAX's ``.at[...]`` normalises a negative index; what is still out
    of range stays so (and is dropped)."""
    index = index.long()
    return torch.where(index < 0, index + n, index)


def window_update(exists, parent, flush=None, *, window: int, origin: int = 0,
                  retired: int = 0, clear_slot0: bool = False):
    """The window's pending shift and one flush of staged certificates, in
    place, in one launch.  ``exists`` [S, N] and ``parent`` [S, N, N] hold
    S = ``window`` slots, or 2·``window`` as a mirrored ring (slot p + W
    repeats slot p, and every write goes to both).  Logical slot w is
    physical (``origin`` + w) mod W.  First the ``retired`` slots just below
    ``origin`` are zeroed (exists and parent) and, with ``clear_slot0``,
    the parent block of ``origin`` itself; then ``flush`` = (ins_w, ins_i,
    row_w, row_c, row_v) adds exists[ins_w, ins_i] += 1 and
    parent[row_w, row_c, :] += row_v at logical slots; a slot in [-W, 0)
    or an authority in [-N, 0) counts from the end, as JAX's indexing
    does, and entries still outside the window are dropped.  Counts make
    duplicate and late (waiting-child repair) rows order-independent.
    Returns the two tensors."""
    W = window
    S, N = exists.shape
    if S not in (W, 2 * W) or not 0 <= origin < W or not 0 <= retired < W:
        raise ValueError(
            f"window_update: {S} slots, window {W}, origin {origin}, "
            f"retired {retired}")
    if exists.device.type == "cpu":
        return window_update_plain(exists, parent, flush, window=W, origin=origin,
                                   retired=retired, clear_slot0=clear_slot0)
    if N > 1024 or S * N * N > 2**31 - 1:
        raise ValueError(f"window_update: {S} slots of N={N} exceed 32-bit indexing")
    dev = exists.device
    require(exists, torch.int32, (S, N), dev, "window_update exists")
    require(parent, torch.int32, (S, N, N), dev, "window_update parent")
    C = 0 if flush is None else flush[0].shape[0]
    if flush is not None:
        for name, t in zip(("ins_w", "ins_i", "row_w", "row_c"), flush):
            require(t, torch.int32, (C,), dev, f"window_update {name}")
        require(flush[4], torch.int32, (C, N), dev, "window_update row_v")
    if C == 0 and retired == 0 and not clear_slot0:
        return exists, parent
    ptrs = [ptr(t) for t in flush] if flush is not None else [_VP(0)] * 5
    fn = kernel_fn("nt_window_update", _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                   _I, _I, _I, _I, _VP)
    rc = fn(ptr(exists), ptr(parent), *ptrs, W, N, C, int(origin), int(S == 2 * W),
            int(retired), int(bool(clear_slot0)), _VP(stream_handle(dev)))
    check_launch("window_update", rc)
    return exists, parent


def window_apply(exists, parent, ins_w, ins_i, row_w, row_c, row_v):
    """One batched insert flush, in place, with the JAX signature:
    exists[ins_w, ins_i] += 1 and parent[row_w, row_c, :] += row_v,
    with JAX's negative indices and drops (see :func:`window_update`).  The
    :func:`window_update` launch with origin 0, no mirror and nothing to
    clear.  Returns the same two tensors."""
    return window_update(exists, parent, (ins_w, ins_i, row_w, row_c, row_v),
                         window=exists.shape[0])


def window_apply_plain(exists, parent, ins_w, ins_i, row_w, row_c, row_v):
    """Plain twin of :func:`window_apply`."""
    return window_update_plain(exists, parent, (ins_w, ins_i, row_w, row_c, row_v),
                               window=exists.shape[0])


class WindowRing:
    """The commit path's count window as a mirrored ring on ``device``:
    ``exists2`` int32[2W, N] and ``parent2`` int32[2W, N, N], slot p and
    slot p + W always equal, so the logical window (logical slot w at
    physical (origin + w) mod W) is the contiguous view
    ``[origin, origin + W)`` that the scans take.  W is a power of two.

    :meth:`shift` is the port of JAX's ``window_shift_op``: it moves the
    origin and leaves the retired slots to be zeroed by the next
    :meth:`update`, which applies a flush in the same launch.  Reading
    :attr:`exists` or :attr:`parent` with a clear pending first runs it
    (one launch with no flush)."""

    def __init__(self, window: int, n: int, device) -> None:
        if window < 1 or window & (window - 1):
            raise ValueError(f"WindowRing: window {window} is not a power of two")
        self.window, self.n = window, n
        self.exists2 = torch.zeros((2 * window, n), dtype=torch.int32, device=device)
        self.parent2 = torch.zeros((2 * window, n, n), dtype=torch.int32, device=device)
        self.origin = 0
        # Zeroed by the next update: the `retired` slots below the origin,
        # and the parent block of the origin (the new slot 0).
        self.retired = 0
        self.clear_slot0 = False

    @property
    def pending(self) -> bool:
        return self.retired > 0 or self.clear_slot0

    def shift(self, d: int) -> None:
        """Shift the window down by ``d`` >= 0 slots: logical slot w takes
        slot w + d; the vacated top slots and the parent block of slot 0
        read as zero.  No launch, except that a shift reaching past every
        slot not yet cleared zeroes both buffers at once."""
        if d < 0:
            raise ValueError(f"WindowRing.shift: d must be >= 0, got {d}")
        W = self.window
        if self.retired + d >= W:
            self.exists2.zero_()
            self.parent2.zero_()
            self.origin, self.retired, self.clear_slot0 = 0, 0, False
            return
        self.origin = (self.origin + d) & (W - 1)
        self.retired += d
        self.clear_slot0 = True

    def update(self, flush=None) -> None:
        """The pending clears, then ``flush`` (ins_w, ins_i, row_w, row_c,
        row_v at logical slots; ``None`` for none): one launch."""
        window_update(self.exists2, self.parent2, flush, window=self.window,
                      origin=self.origin, retired=self.retired,
                      clear_slot0=self.clear_slot0)
        self.retired, self.clear_slot0 = 0, False

    def _view(self, t):
        if self.pending:
            self.update()
        return t[self.origin : self.origin + self.window]

    @property
    def exists(self):
        """The logical window's exists, int32[W, N] (a view)."""
        return self._view(self.exists2)

    @property
    def parent(self):
        """The logical window's parent, int32[W, N, N] (a view)."""
        return self._view(self.parent2)


# ----------------------------------------------------------- leader_commit_scan


def _window_checks(parent, exists, dtype, name):
    """The checks every window kernel shares: N <= 1024, and
    ``parent`` [W, N, N] and ``exists`` [W, N] of ``dtype`` on one card.
    Returns (W, N, device)."""
    W, N = exists.shape
    if N > 1024:
        raise ValueError(f"{name}: N={N} > 1024")
    dev = exists.device
    require(parent, dtype, (W, N, N), dev, f"{name} parent")
    require(exists, dtype, (W, N), dev, f"{name} exists")
    return W, N, dev


def _chain_scan_checks(parent, exists, leader_onehot, is_leader_slot,
                       anchor_onehot, dtype, name):
    W, N, dev = _window_checks(parent, exists, dtype, name)
    require(leader_onehot, torch.bool, (W, N), dev, f"{name} leader_onehot")
    require(is_leader_slot, torch.bool, (W,), dev, f"{name} is_leader_slot")
    require(anchor_onehot, torch.bool, (N,), dev, f"{name} anchor_onehot")
    return W, N, dev


def leader_commit_scan_plain(parent, exists, leader_onehot, is_leader_slot,
                             anchor_slot: int, anchor_onehot):
    """Plain twin of :func:`leader_commit_scan`."""
    committed, _ = leader_chain_scan_plain(
        parent > 0, exists > 0, leader_onehot, is_leader_slot, anchor_slot,
        anchor_onehot,
    )
    return committed


def leader_commit_scan(parent, exists, leader_onehot, is_leader_slot,
                       anchor_slot: int, anchor_onehot):
    """The whole linked-leader chain (``order_leaders``) over the count
    window in ONE launch: a cluster of blocks packs the window's presence
    bits into shared memory, then one warp steps the W slots with the
    frontier in its registers.  Returns committed bool[W] on the window's
    device."""
    if exists.device.type == "cpu":
        return leader_commit_scan_plain(
            parent, exists, leader_onehot, is_leader_slot, anchor_slot,
            anchor_onehot,
        )
    W, N, dev = _chain_scan_checks(parent, exists, leader_onehot,
                                   is_leader_slot, anchor_onehot, torch.int32,
                                   "leader_commit_scan")
    committed = torch.empty(W, dtype=torch.bool, device=dev)
    fn = kernel_fn("nt_leader_commit_scan", _VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _VP)
    rc = fn(ptr(parent), ptr(exists), ptr(leader_onehot), ptr(is_leader_slot),
            ptr(anchor_onehot), int(anchor_slot), ptr(committed), W, N,
            ctypes.c_void_p(stream_handle(dev)))
    check_launch("leader_commit_scan", rc)
    return committed


# ------------------------------------------------------------ leader_chain_scan


def leader_chain_scan_plain(parent, exists, leader_onehot, is_leader_slot,
                            anchor_slot: int, anchor_onehot):
    """Plain twin of :func:`leader_chain_scan`: the JAX ``_chain_scan``
    step by step, descending over the W slots, on bool tensors.  Returns
    (committed bool[W], reach bool[W, N]), where reach[w] is the frontier
    g at slot w before any leader reset."""
    W, N = exists.shape
    frontier = torch.zeros(N, dtype=torch.bool, device=exists.device)
    committed = torch.zeros(W, dtype=torch.bool, device=exists.device)
    reach = torch.zeros((W, N), dtype=torch.bool, device=exists.device)
    for w in range(W - 1, -1, -1):
        # Step w consumes parent[w+1] (edges slot w+1 → slot w).
        if w + 1 < W:
            hit = (frontier[:, None] & parent[w + 1]).any(dim=0)
        else:
            hit = torch.zeros_like(frontier)
        g = hit & exists[w]
        if w == anchor_slot:
            g = anchor_onehot.clone()
        lead_here = bool(is_leader_slot[w]) and w < anchor_slot and bool(
            (g & leader_onehot[w]).any()
        )
        committed[w] = lead_here
        reach[w] = g
        frontier = g & leader_onehot[w] if lead_here else g
    return committed, reach


def leader_chain_scan(parent, exists, leader_onehot, is_leader_slot,
                      anchor_slot: int, anchor_onehot):
    """The linked-leader chain on a bool window (``parent`` bool[W, N, N],
    ``exists`` bool[W, N]) in one launch, with the per-slot reach masks.
    Returns (committed bool[W], reach bool[W, N]) on the window's device;
    reach[w] is the frontier at slot w before any leader reset, as the
    JAX ``leader_chain_scan`` returns it.  An ``anchor_slot`` outside
    [0, W) never matches a slot."""
    if exists.device.type == "cpu":
        return leader_chain_scan_plain(
            parent, exists, leader_onehot, is_leader_slot, anchor_slot,
            anchor_onehot,
        )
    W, N, dev = _chain_scan_checks(parent, exists, leader_onehot,
                                   is_leader_slot, anchor_onehot, torch.bool,
                                   "leader_chain_scan")
    committed = torch.empty(W, dtype=torch.bool, device=dev)
    reach = torch.empty((W, N), dtype=torch.bool, device=dev)
    fn = kernel_fn("nt_leader_chain_scan", _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP,
                   _I, _I, _VP)
    rc = fn(ptr(parent), ptr(exists), ptr(leader_onehot), ptr(is_leader_slot),
            ptr(anchor_onehot), int(anchor_slot), ptr(committed), ptr(reach),
            W, N, ctypes.c_void_p(stream_handle(dev)))
    check_launch("leader_chain_scan", rc)
    return committed, reach


# ------------------------------------------------------------- causal_mask_scan


def causal_mask_scan_plain(parent, exists, start_slot: int, start_onehot):
    """Plain twin of :func:`causal_mask_scan`."""
    W, N = exists.shape
    frontier = torch.zeros(N, dtype=torch.bool, device=exists.device)
    mask = torch.zeros((W, N), dtype=torch.bool, device=exists.device)
    for w in range(W - 1, -1, -1):
        if w + 1 < W:
            hit = (frontier[:, None] & parent[w + 1]).any(dim=0)
        else:
            hit = torch.zeros_like(frontier)
        g = hit & exists[w]
        if w == start_slot:
            g = g | start_onehot
        mask[w] = g
        frontier = g
    return mask


def causal_mask_scan(parent, exists, start_slot: int, start_onehot):
    """The causal cone of certificate (``start_slot``, ``start_onehot``)
    on a bool window in one launch: bool[W, N], every certificate
    reachable through parent links — the set ``order_dag`` flattens.
    The frontier accumulates and never resets; a ``start_slot`` outside
    [0, W) gives an empty mask."""
    if exists.device.type == "cpu":
        return causal_mask_scan_plain(parent, exists, start_slot, start_onehot)
    W, N, dev = _window_checks(parent, exists, torch.bool, "causal_mask_scan")
    require(start_onehot, torch.bool, (N,), dev, "causal_mask_scan start_onehot")
    mask = torch.empty((W, N), dtype=torch.bool, device=dev)
    fn = kernel_fn("nt_causal_mask_scan", _VP, _VP, _I, _VP, _VP, _I, _I, _VP)
    rc = fn(ptr(parent), ptr(exists), int(start_slot), ptr(start_onehot),
            ptr(mask), W, N, ctypes.c_void_p(stream_handle(dev)))
    check_launch("causal_mask_scan", rc)
    return mask


# ---------------------------------------------------------------- support_stake


def _dynamic_index(index: int, size: int) -> int:
    """JAX's rule for a traced index into an axis of ``size``: counted from
    the end once when negative, then clamped into [0, size) (JAX does not
    raise on an index out of range)."""
    if index < 0:
        index += size
    return min(max(index, 0), size - 1)


def _support_slot(leader_slot: int, window: int) -> int:
    """The child slot the JAX ``support_stake`` reads for ``leader_slot``:
    its dynamic index ``leader_slot + 1``."""
    return _dynamic_index(leader_slot + 1, window)


def _leader_row(anchor_slot: int, window: int) -> int:
    """The row of ``leader_onehot`` the JAX commit step passes to its
    support gate: ``leader_onehot[anchor_slot - 2]`` with a traced index."""
    return _dynamic_index(anchor_slot - 2, window)


def support_stake_plain(parent, exists, stake, leader_slot: int, leader_onehot):
    """Plain twin of :func:`support_stake`."""
    s = _support_slot(leader_slot, exists.shape[0])
    votes = (parent[s] & leader_onehot[None, :]).any(dim=1) & exists[s]
    return torch.where(votes, stake, torch.zeros_like(stake)).sum(dtype=torch.int32)


def support_stake(parent, exists, stake, leader_slot: int, leader_onehot):
    """Stake of the slot ``leader_slot + 1`` certificates that exist and
    cite the leader (``leader_onehot`` bool[N]) — the f+1 support gate —
    in one launch.  Returns a 0-d int32 tensor on the window's device,
    with no host synchronisation."""
    if exists.device.type == "cpu":
        return support_stake_plain(parent, exists, stake, leader_slot, leader_onehot)
    W, N, dev = _window_checks(parent, exists, torch.bool, "support_stake")
    require(stake, torch.int32, (N,), dev, "support_stake stake")
    require(leader_onehot, torch.bool, (N,), dev, "support_stake leader_onehot")
    out = torch.empty((), dtype=torch.int32, device=dev)
    fn = kernel_fn("nt_support_stake", _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _VP)
    rc = fn(ptr(parent), ptr(exists), ptr(stake), _support_slot(leader_slot, W),
            ptr(leader_onehot), ptr(out), W, N,
            ctypes.c_void_p(stream_handle(dev)))
    check_launch("support_stake", rc)
    return out


# ------------------------------------------------------------------ commit_step


def commit_step_plain(parent, exists, leader_onehot, is_leader_slot, stake,
                      anchor_slot: int, anchor_onehot):
    """Plain twin of :func:`commit_step_fused`: the two plain twins, the
    support gate's leader row resolved as JAX resolves a traced index."""
    row = leader_onehot[_leader_row(anchor_slot, exists.shape[0])]
    support = support_stake_plain(parent, exists, stake, anchor_slot - 2, row)
    return (support, *leader_chain_scan_plain(
        parent, exists, leader_onehot, is_leader_slot, anchor_slot, anchor_onehot))


def commit_step_fused(parent, exists, leader_onehot, is_leader_slot, stake,
                      anchor_slot: int, anchor_onehot):
    """The flagship commit step (``__graft_entry__.make_commit_step``: the
    support gate of the leader two slots below the anchor, then the
    linked-leader chain with its reach masks) in ONE launch: the chain
    scan's cluster, whose blocks that are idle after the pack run the
    gate while one warp steps the scan.  Returns (support 0-d int32,
    committed bool[W], reach bool[W, N]) on the window's device, with no
    host synchronisation."""
    if exists.device.type == "cpu":
        return commit_step_plain(parent, exists, leader_onehot, is_leader_slot,
                                 stake, anchor_slot, anchor_onehot)
    W, N, dev = _chain_scan_checks(parent, exists, leader_onehot, is_leader_slot,
                                   anchor_onehot, torch.bool, "commit_step")
    require(stake, torch.int32, (N,), dev, "commit_step stake")
    support = torch.empty((), dtype=torch.int32, device=dev)
    committed = torch.empty(W, dtype=torch.bool, device=dev)
    reach = torch.empty((W, N), dtype=torch.bool, device=dev)
    fn = kernel_fn("nt_commit_step", _VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _VP,
                   _VP, _VP, _I, _I, _VP)
    rc = fn(ptr(parent), ptr(exists), ptr(leader_onehot), ptr(is_leader_slot),
            ptr(anchor_onehot), int(anchor_slot), ptr(stake),
            _support_slot(anchor_slot - 2, W), _leader_row(anchor_slot, W),
            ptr(support), ptr(committed), ptr(reach), W, N,
            ctypes.c_void_p(stream_handle(dev)))
    check_launch("commit_step", rc)
    return support, committed, reach


# ------------------------------------------------------- the sharded commit step


def _frontier(prev, prev_lead, n: int):
    """The frontier a block step reads, bool[n]: from ``prev`` bool[k, 2,
    Nb], every rank's (g, g & leader) blocks at the slot above, its
    g & leader where ``prev_lead`` (that slot's ``is_leader_slot``, bool
    0-d) holds and any of those bits is set, else its g."""
    g, gl = (prev[:, h].reshape(-1)[:n] for h in (0, 1))
    return torch.where(prev_lead & gl.any(), gl, g)


def chain_step_block_plain(parent_up_blk, exists_blk, leader_blk, prev, prev_lead,
                           *, out=None):
    """One descending slot w of the linked-leader chain on one rank's block
    of Nb columns (cited parents) of N: from the slot above's gathered
    (g, g & leader) blocks ``prev`` bool[k, 2, Nb] and its
    ``is_leader_slot`` ``prev_lead`` (bool 0-d) the frontier (see
    :func:`_frontier`), then g = (frontier · ``parent_up_blk`` bool[N,
    Nb], parent[w + 1]'s columns) & ``exists_blk`` bool[Nb].  Returns
    bool[2, Nb], (g_blk, g_blk & ``leader_blk``), in ``out`` when given.
    A piece of :func:`commit_step_block_plain`."""
    frontier = _frontier(prev, prev_lead, parent_up_blk.shape[0])
    g = (frontier[:, None] & parent_up_blk).any(dim=0) & exists_blk
    res = torch.stack((g, g & leader_blk))
    return res if out is None else out.copy_(res)


def support_votes_block_plain(parent_s_blk, leader_blk):
    """The f+1 gate's votes on one rank's block of columns: votes[i] = OR
    over the block's columns j of ``parent_s_blk`` bool[N, Nb] (the child
    slot's parent rows) [i, j] & ``leader_blk`` bool[Nb] [j].  Returns
    bool[N]; the ranks' votes OR together.  A piece of
    :func:`commit_step_block_plain`."""
    return (parent_s_blk & leader_blk[None, :]).any(dim=1)


def _words(bits: int) -> int:
    return -(-bits // 32)


def record_words(n: int, nb: int) -> int:
    """Words of one rank's record of a slot of the sharded step (n
    authorities, nb columns a rank): g and g & leader on its columns, the
    gate's votes on the n child rows, one int32 of partial support."""
    return 2 * _words(nb) + _words(n) + 1


def packed_words(window: int, n: int, nb: int) -> int:
    """int32 words of the scratch into which the step's top launch packs a
    rank's parent block: each row's nb bits in a power-of-two number of
    words, each slot padded to 16 bytes."""
    bwp = 1 << (_words(nb) - 1).bit_length()
    return window * (-(-n * bwp // 4) * 4)


def pack_bits(bits):
    """bool[..., m] → int32[..., ceil(m / 32)]: bit j in word j // 32 at
    position j % 32 (a ballot's order)."""
    m = bits.shape[-1]
    pad = torch.zeros(bits.shape[:-1] + (_words(m) * 32 - m,), dtype=torch.bool,
                      device=bits.device)
    lanes = torch.cat((bits, pad), -1).unflatten(-1, (_words(m), 32)).long()
    word = (lanes << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def unpack_bits(words, m: int):
    """int32[..., w] → bool[..., m], the inverse of :func:`pack_bits`."""
    bit = (words.unsqueeze(-1) >> torch.arange(32, device=words.device, dtype=torch.int32)) & 1
    return bit.bool().flatten(-2)[..., :m]


def commit_step_block_plain(w: int, parent_blk, exists_blk, leader_blk, is_leader_slot,
                            stake_blk, anchor, anchor_onehot, prev, packed=None, *,
                            rank: int, k: int, out=None):
    """Plain twin of :func:`commit_step_block` (``packed`` unused), from
    :func:`chain_step_block_plain` and :func:`support_votes_block_plain`."""
    W, N, Nb = parent_blk.shape
    a, bw, vw = int(anchor), _words(Nb), _words(N)
    lo = rank * Nb
    own = max(0, min(N - lo, Nb))
    dev = parent_blk.device
    g = torch.zeros(Nb, dtype=torch.bool, device=dev)
    gl = torch.zeros_like(g)
    if 0 <= w == a:
        g[:own] = anchor_onehot[lo : lo + own]
    elif prev is not None and 0 <= w < a < W:
        # The slot above's g & leader is written only where it may lead,
        # so the chain's reset is "where any of it is set".
        halves = torch.stack([unpack_bits(prev[:, h * bw : (h + 1) * bw], Nb)
                              for h in (0, 1)], 1)
        g, gl = chain_step_block_plain(parent_blk[w + 1], exists_blk[w], leader_blk[w],
                                       halves, torch.tensor(True, device=dev))
        if not bool(is_leader_slot[w]):
            gl = torch.zeros_like(g)
    votes = torch.zeros(N, dtype=torch.bool, device=dev)
    if w == W - 1:
        votes = support_votes_block_plain(parent_blk[_support_slot(a - 2, W)],
                                          leader_blk[_leader_row(a, W)])
    support = torch.zeros(1, dtype=torch.int32, device=dev)
    if w == (W - 2 if W >= 2 else -1):
        s = _support_slot(a - 2, W)
        voted = unpack_bits(prev[:, 2 * bw : 2 * bw + vw], N).any(0)[lo : lo + own]
        mine = voted & exists_blk[s, :own]
        support = torch.where(mine, stake_blk[:own], 0).sum(dtype=torch.int32).reshape(1)
    res = torch.cat((pack_bits(g), pack_bits(gl), pack_bits(votes), support))
    return res if out is None else out.copy_(res)


def commit_step_block(w: int, parent_blk, exists_blk, leader_blk, is_leader_slot,
                      stake_blk, anchor, anchor_onehot, prev, packed, *, rank: int, k: int,
                      out=None):
    """Slot ``w`` of the committee-sharded commit step on rank ``rank`` of
    ``k``, in one launch, as the JAX scan steps it.  The rank holds Nb
    columns of N: ``parent_blk`` bool[W, N, Nb], ``exists_blk`` and
    ``leader_blk`` bool[W, Nb], ``stake_blk`` int32[Nb]; ``is_leader_slot``
    bool[W], ``anchor`` int32 0-d (the anchor slot, read on the card) and
    ``anchor_onehot`` bool[N] are whole.

    Returns int32[R] (:func:`record_words`), in ``out`` when given: this
    rank's record of slot w — g on its columns (at the anchor its block of
    ``anchor_onehot``; below an anchor inside the window the parents of
    the frontier, rebuilt from ``prev`` int32[k, R], every rank's record
    of slot w + 1, that exist; else empty), g & leader where slot w may
    lead (``is_leader_slot[w]``, w below the anchor), the gate's votes
    (top slot w = W - 1 only) and the stake of this rank's voters (slot
    W - 2, from the votes in ``prev``; for W = 1 a launch of its own at
    w = -1), the gate's child slot and leader row resolved as JAX resolves
    a traced index.  ``prev`` is None at the top slot, whose launch also
    packs ``parent_blk`` into ``packed`` int32[:func:`packed_words`] for
    the slots below it: the caller keeps ``packed`` through one step."""
    if parent_blk.device.type == "cpu":
        return commit_step_block_plain(w, parent_blk, exists_blk, leader_blk,
                                       is_leader_slot, stake_blk, anchor, anchor_onehot,
                                       prev, packed, rank=rank, k=k, out=out)
    W, N, Nb = parent_blk.shape
    R = record_words(N, Nb)
    if N > 1024 or Nb > 1024 or k * Nb < N or not 0 <= rank < k:
        raise ValueError(f"commit_step_block: N={N} in {k} blocks of {Nb}, rank {rank}")
    if (prev is None) != (w == W - 1) or not (-1 if W == 1 else 0) <= w < W:
        raise ValueError(f"commit_step_block: slot {w} of {W}, prev {prev is not None}")
    dev = resolve_device(parent_blk.device)
    require(parent_blk, torch.bool, (W, N, Nb), dev, "commit_step_block parent_blk")
    require(exists_blk, torch.bool, (W, Nb), dev, "commit_step_block exists_blk")
    require(leader_blk, torch.bool, (W, Nb), dev, "commit_step_block leader_blk")
    require(is_leader_slot, torch.bool, (W,), dev, "commit_step_block is_leader_slot")
    require(stake_blk, torch.int32, (Nb,), dev, "commit_step_block stake_blk")
    require(anchor, torch.int32, (), dev, "commit_step_block anchor")
    require(anchor_onehot, torch.bool, (N,), dev, "commit_step_block anchor_onehot")
    require(packed, torch.int32, (packed_words(W, N, Nb),), dev, "commit_step_block packed")
    if prev is not None:
        require(prev, torch.int32, (k, R), dev, "commit_step_block prev")
    if out is None:
        out = torch.empty(R, dtype=torch.int32, device=dev)
    require(out, torch.int32, (R,), dev, "commit_step_block out")
    fn = kernel_fn("nt_commit_step_block", _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                   _VP, _I, _I, _I, _I, _I, _I, _I, _VP)
    rc = fn(ptr(parent_blk), ptr(packed), ptr(exists_blk), ptr(leader_blk),
            ptr(is_leader_slot), ptr(stake_blk), ptr(anchor), ptr(anchor_onehot),
            _VP(0) if prev is None else ptr(prev), ptr(out), int(w), W, N, Nb, k, rank,
            packed.numel() // W, _VP(stream_handle(dev)))
    check_launch("commit_step_block", rc)
    return out


def _step_slots(window: int) -> List[int]:
    """The slots a sharded step launches, in order: W - 1 down to 0, and
    for W = 1 the gate's own launch, -1."""
    return list(range(window - 1, -1, -1)) + ([-1] if window == 1 else [])


def _sharded_step(group, args, rec, send, packed, *, rank: int, k: int, n: int):
    """Enqueue one sharded step on ``args`` (the inputs of
    :func:`commit_step_sharded`, the anchor an int32 0-d tensor): a
    :func:`commit_step_block` launch and a gather of the ranks' records a
    slot into ``rec`` [L, k, R] (slot w at row w; the gate's own launch of
    W = 1 at row 1), then the result read off ``rec`` with no host
    synchronisation."""
    import torch.distributed as dist

    parent_blk = args[0]
    W, _, nb = parent_blk.shape
    bw = _words(nb)
    nccl = dist.get_backend(group) == "nccl"
    for i, w in enumerate(_step_slots(W)):
        row = w if w >= 0 else W
        prev = None if i == 0 else rec[w + 1 if w >= 0 else 0]
        commit_step_block(w, *args, prev, packed, rank=rank, k=k, out=send[row])
        if nccl:
            dist.all_gather_into_tensor(rec[row], send[row], group=group)
        else:
            # gloo: the list form, which it takes on card and CPU alike.
            dist.all_gather(list(rec[row].unbind(0)), send[row], group=group)
    gate = W - 2 if W >= 2 else W
    support = rec[gate, :, -1].sum(dtype=torch.int32)
    committed = (rec[:W, :, bw : 2 * bw] != 0).flatten(1).any(1)
    reach = unpack_bits(rec[:W, :, :bw], nb).reshape(W, k * nb)[:, :n].contiguous()
    return support, committed, reach


class _StepGraph:
    """One rank's sharded step captured as a CUDA graph: W
    :func:`commit_step_block` launches, W ``all_gather_into_tensor`` calls
    into a preallocated record and the final reads, on static buffers.
    Built with an eager warm-up step (which also initialises the NCCL
    communicator) and then the capture; a capture or replay that fails
    raises.  ``launches`` holds the kernel launches the capture took, which
    each replay adds to the launch counts; ``replays`` counts the
    replays."""

    def __init__(self, group, args, *, rank: int, k: int, n: int) -> None:
        W, _, nb = args[0].shape
        dev = args[0].device
        self.static = [t.clone() for t in args]
        R = record_words(n, nb)
        rows = W + (W == 1)
        self.rec = torch.zeros((rows, k, R), dtype=torch.int32, device=dev)
        self.send = torch.zeros((rows, R), dtype=torch.int32, device=dev)
        self.packed = torch.empty(packed_words(W, n, nb), dtype=torch.int32, device=dev)
        step = (group, self.static, self.rec, self.send, self.packed)
        kw = dict(rank=rank, k=k, n=n)
        _sharded_step(*step, **kw)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        with capturing() as tally, torch.cuda.graph(self.graph,
                                                    capture_error_mode="thread_local"):
            self.out = _sharded_step(*step, **kw)
        self.launches = {name: n for name, n in tally.items() if n}
        self.replays = 0

    def __call__(self, args):
        for dst, src in zip(self.static, args):
            dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            count_launches(name, n)
        return self.out


_GRAPHS: Dict[tuple, _StepGraph] = {}


def graph_replays() -> int:
    """Replays of every captured sharded step so far, in this process."""
    return sum(step.replays for step in _GRAPHS.values())


def step_runs_as_graph(group, device) -> bool:
    """Whether :func:`commit_step_sharded` runs a step on ``device`` over
    ``group`` as a CUDA graph: on a card with the ``nccl`` backend."""
    import torch.distributed as dist

    return torch.device(device).type == "cuda" and dist.get_backend(group) == "nccl"


def commit_step_sharded(group, parent_blk, exists_blk, leader_blk, is_leader_slot,
                        stake_blk, anchor_slot, anchor_onehot, *, n: int,
                        graph: Optional[bool] = None):
    """The flagship commit step with the committee's columns split over the
    k ranks of the process group ``group`` (None: the default group), as
    ``jax.jit`` of ``__graft_entry__.make_commit_step`` runs it over a
    ``committee`` mesh.  Rank r holds the columns [r·Nb, (r+1)·Nb) of the
    cited-parent axis, Nb = ceil(n / k), the last block padded with
    columns that do not exist and hold no stake: ``parent_blk`` bool[W,
    n, Nb], ``exists_blk`` and ``leader_blk`` bool[W, Nb], ``stake_blk``
    int32[Nb]; ``is_leader_slot`` bool[W], ``anchor_slot`` (an int or an
    int32 0-d tensor) and ``anchor_onehot`` bool[n] are whole on every
    rank.  No rank holds the whole window.

    Returns (support 0-d int32, committed bool[W], reach bool[W, n]), the
    same on every rank and equal to :func:`commit_step_fused` on the whole
    window at every anchor.  A step follows the JAX scan: one
    :func:`commit_step_block` launch and one all-gather of the ranks'
    records a slot, W of each whatever the anchor (W = 1 adds the gate's
    own launch and gather), and no reduction collective; nothing waits on
    the host.

    On a card with the ``nccl`` backend the step runs as one CUDA graph,
    captured on the first call of each (W, n, k, group) after an eager
    warm-up step; each call copies its inputs into the graph's buffers and
    replays it, and the returned tensors are the graph's outputs, which the
    next call of that shape overwrites.  With ``gloo`` (the CPU, or ranks
    that share a card) the same sequence runs eagerly.  ``graph=False``
    runs a NCCL step eagerly too (for timing the two side by side)."""
    import torch.distributed as dist

    dev = resolve_device(parent_blk.device)
    k, rank = dist.get_world_size(group), dist.get_rank(group)
    W, N, Nb = parent_blk.shape
    if N != n or Nb != -(-n // k):
        raise ValueError(f"commit_step_sharded: parent block {tuple(parent_blk.shape)} "
                         f"is not n={n} over {k} ranks")
    can_graph = step_runs_as_graph(group, dev)
    if graph is None:
        graph = can_graph
    elif graph and not can_graph:
        raise ValueError("commit_step_sharded: a CUDA graph needs the nccl backend on a card")
    # An int anchor becomes a fill on the card, not a copy from the host.
    anchor = (anchor_slot.to(device=dev, dtype=torch.int32)
              if isinstance(anchor_slot, torch.Tensor)
              else torch.full((), int(anchor_slot), dtype=torch.int32, device=dev))
    args = (parent_blk, exists_blk, leader_blk, is_leader_slot, stake_blk, anchor,
            anchor_onehot)
    kw = dict(rank=rank, k=k, n=n)
    if not graph:
        R, rows = record_words(n, Nb), W + (W == 1)
        rec = torch.zeros((rows, k, R), dtype=torch.int32, device=dev)
        send = torch.zeros((rows, R), dtype=torch.int32, device=dev)
        packed = torch.empty(packed_words(W, n, Nb), dtype=torch.int32, device=dev)
        return _sharded_step(group, args, rec, send, packed, **kw)
    key = (W, n, k, dist.group.WORLD if group is None else group, dev)
    step = _GRAPHS.get(key)
    if step is None:
        step = _GRAPHS[key] = _StepGraph(group, args, **kw)
    return step(args)


# -------------------------------------------------------------------- KernelTusk

from ..consensus.tusk import Tusk  # noqa: E402  (consensus imports this lazily)
from ..primary.messages import genesis  # noqa: E402


class KernelTusk(Tusk):
    """Tusk with ``order_leaders`` on the card: the same decisions as the
    Python Tusk, with the window traversals collapsed into one
    :func:`leader_commit_scan` launch.  The emission DFS (``order_dag``)
    stays on the host — it is O(output) and must produce the exact
    reference DFS tie-order.

    The dense window is DEVICE-RESIDENT across calls:

    - **Arrival** (``insert_certificate``): O(1) — the certificate is
      appended to a host staging list; no launch.
    - **Commit opportunity** (``order_leaders``, reached only when the
      host-side f+1 support gate passes): the staged batch is resolved
      (digest → (round, authority), out-of-order children repaired via the
      waiting-child map), copied to the card in one packed transfer and
      applied by one :func:`window_update` launch per chunk of C rows, the
      first of which also zeroes the slots the last commit retired; then
      ONE :func:`leader_commit_scan` launch computes the linked-leader
      chain and only its W bools come back to the host.
    - **Commit** (``_win_shift``): the window's :class:`WindowRing` moves
      its origin to the new ``last_committed_round`` with no launch (the
      retired slots are zeroed by the next flush's launch); host maps
      prune below the new base; certificates that arrived beyond the
      window during a stall re-stage.

    One static window shape, the smallest power of two covering
    gc_depth+2 rounds; a span beyond it (a commit stall racing GC) takes
    the Python walk, counted in ``python_fallbacks``."""

    def __init__(self, committee, gc_depth, fixed_coin: bool = False,
                 device=None) -> None:
        super().__init__(committee, gc_depth, fixed_coin=fixed_coin)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            open_context(self.device)
        w = 8
        while w < gc_depth + 2:
            w <<= 1
        self.max_window = w
        self.python_fallbacks = 0  # observability: stalls beyond the window
        n = len(self._sorted_keys)
        self._n = n
        self._index = {name: i for i, name in enumerate(self._sorted_keys)}
        self._win_base = 0  # round held by slot 0; == last_committed_round
        # Static flush-chunk shape: a steady-state commit opportunity
        # covers ~2 rounds (≤ 2N certificates + a few repair rows), so one
        # chunk is one launch; a long catch-up flush loops chunks.
        cap = 64
        while cap < 4 * n:
            cap <<= 1
        self._cap = cap
        # The device-resident window (presence COUNTS, nonzero = present).
        self._ring = WindowRing(w, n, self.device)
        self._pending: List = []
        # digest → (absolute round, authority index), resolved at flush for
        # every certificate at or above the window base (pruned on shift)
        self._digest_pos: Dict[bytes, Tuple[int, int]] = {}
        # parent digest → [(child round, child index)]: children that
        # arrived before their parent (edge repaired on parent flush)
        self._waiting_child: Dict[bytes, List[Tuple[int, int]]] = {}
        # certificates at slots ≥ window during a stall; re-staged when a
        # commit shifts the window down far enough
        self._overflow: List = []
        self._pending.extend(genesis(committee))

    @property
    def _dev_exists(self):
        """The logical window's exists counts, int32[W, n] on the device
        (runs a pending clear first)."""
        return self._ring.exists

    @property
    def _dev_parent(self):
        """The logical window's parent counts, int32[W, n, n]."""
        return self._ring.parent

    # -- arrival path: O(1) staging ------------------------------------

    def insert_certificate(self, certificate) -> None:
        super().insert_certificate(certificate)
        self._pending.append(certificate)

    def process_certificate(self, certificate) -> List:
        sequence = super().process_certificate(certificate)
        if sequence:
            self._win_shift()
        return sequence

    # -- flush: one launch per chunk of C staged rows ------------------

    def _flush_pending(self) -> None:
        # With nothing staged, a pending clear runs when the scan reads the
        # window.
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        _m_flush_batch.observe(len(pending))
        # Parents (round r-1) before children (round r) within one flush;
        # cross-flush out-of-order arrivals go through the waiting map.
        pending.sort(key=lambda c: c.round)
        W = self.max_window
        n = self._n
        base = self._win_base
        digest_pos = self._digest_pos
        index = self._index
        ins_w: List[int] = []
        ins_i: List[int] = []
        rows: List[Tuple[int, int, List[int]]] = []  # (slot, child, parents)
        for cert in pending:
            r = cert.round
            if r < base:
                # Below the window: slot-0 certificates resolve no parent
                # edges, so nothing below base is ever referenced.
                continue
            i = index[cert.origin]
            d = cert.digest()
            digest_pos[d] = (r, i)
            w = r - base
            if w >= W:
                self._overflow.append(cert)
                continue
            ins_w.append(w)
            ins_i.append(i)
            if w >= 1:
                parents = cert.header.parents
                prow = [
                    pos[1]
                    for pd in parents
                    if (pos := digest_pos.get(pd)) is not None
                    and pos[0] == r - 1
                ]
                if len(prow) != len(parents):
                    for pd in parents:
                        pos = digest_pos.get(pd)
                        if pos is None or pos[0] != r - 1:
                            self._waiting_child.setdefault(pd, []).append(
                                (r, i)
                            )
                if prow:
                    rows.append((w, i, prow))
            # Repair rows for children that arrived in earlier flushes.
            for cr, ci in self._waiting_child.pop(d, ()):
                cw = cr - base
                if cr == r + 1 and 0 <= cw < W:
                    rows.append((cw, ci, [i]))
        if not ins_w and not rows:
            return
        C = self._cap
        chunks = max(-(-len(ins_w) // C), -(-len(rows) // C), 1)
        # Padding entries target slot W — out of bounds, dropped.
        iw = np.full(chunks * C, W, dtype=np.int32)
        ii = np.zeros(chunks * C, dtype=np.int32)
        iw[: len(ins_w)] = ins_w
        ii[: len(ins_i)] = ins_i
        rw = np.full(chunks * C, W, dtype=np.int32)
        rc = np.zeros(chunks * C, dtype=np.int32)
        rv = np.zeros((chunks * C, n), dtype=np.int32)
        for j, (w, i, prow) in enumerate(rows):
            rw[j] = w
            rc[j] = i
            rv[j, prow] = 1
        # One packed host buffer → one transfer per flush; chunk k's row
        # is [ins_w | ins_i | row_w | row_c | row_v (C×n)].
        buf = np.concatenate(
            [a.reshape(chunks, -1) for a in (iw, ii, rw, rc, rv)], axis=1
        )
        dev_buf = torch.from_numpy(buf).to(self.device)
        for k in range(chunks):
            row = dev_buf[k]
            _m_dispatches.inc()
            # The first chunk's launch also runs the pending clears.
            self._ring.update((
                row[0:C],
                row[C : 2 * C],
                row[2 * C : 3 * C],
                row[3 * C : 4 * C],
                row[4 * C :].view(C, n),
            ))

    def _win_shift(self) -> None:
        new_base = max(0, self.state.last_committed_round)
        d = new_base - self._win_base
        if d <= 0:
            return
        if d < self.max_window:
            _m_shifts.inc()
        # No launch: the origin moves and the next flush zeroes the retired
        # slots (a shift past the whole window zeroes it at once).
        self._ring.shift(d)
        self._win_base = new_base
        # Prune host maps below the window (slot-0 certs resolve no parents).
        self._digest_pos = {
            k: v for k, v in self._digest_pos.items() if v[0] >= new_base
        }
        self._waiting_child = {
            k: kept
            for k, v in self._waiting_child.items()
            if (kept := [e for e in v if e[0] > new_base])
        }
        # Certificates that arrived beyond the window during the stall now
        # (possibly) fit: re-stage them for the next flush.
        overflow, self._overflow = self._overflow, []
        self._pending.extend(overflow)

    # -- device order_leaders ------------------------------------------

    def prewarm(self) -> None:
        """Build the kernel library and launch every kernel of the commit
        path once on scratch buffers, off the critical path (call at node
        boot).  The instance window is untouched."""
        n, W, C = self._n, self.max_window, self._cap
        ring = WindowRing(W, n, self.device)
        pad = torch.full((C,), W, dtype=torch.int32, device=self.device)
        zero = torch.zeros((C,), dtype=torch.int32, device=self.device)
        rv = torch.zeros((C, n), dtype=torch.int32, device=self.device)
        flags = torch.zeros((W, n), dtype=torch.bool, device=self.device)
        with warming():
            ring.shift(1)
            ring.update((pad, zero, pad, zero, rv))  # both phases of the launch
            leader_commit_scan(
                ring.parent, ring.exists, flags, flags[:, 0].contiguous(), 0,
                flags[0].contiguous(),
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def leader_flags(self, leader):
        """The scan's leader inputs for the commit opportunity at
        ``leader``, on the window's device, from one packed bool transfer:
        (leader_onehot bool[W, n], is_leader_slot bool[W], anchor_slot,
        anchor_onehot bool[n]).  Slot w holds round ``_win_base + w``."""
        state = self.state
        n, window, base = self._n, self.max_window, self._win_base
        # [leader_onehot (W×n) | is_leader_slot (W) | anchor_onehot (n)]
        flags = np.zeros(window * n + window + n, dtype=bool)
        leader_onehot = flags[: window * n].reshape(window, n)
        is_leader_slot = flags[window * n : window * n + window]
        for r in range(leader.round - 2, state.last_committed_round, -2):
            name = self._leader_name(r)
            if state.dag.get(r, {}).get(name) is not None:
                leader_onehot[r - base, self._index[name]] = True
                is_leader_slot[r - base] = True
        flags[window * n + window + self._index[leader.origin]] = True
        dev_flags = torch.from_numpy(flags).to(self.device)
        return (
            dev_flags[: window * n].view(window, n),
            dev_flags[window * n : window * n + window],
            leader.round - base,
            dev_flags[window * n + window :],
        )

    def order_leaders(self, leader) -> List:
        state = self.state
        base = max(0, state.last_committed_round)
        span = leader.round - base + 1
        window = self.max_window
        if span > window or base != self._win_base:
            self.python_fallbacks += 1
            _m_fallbacks.inc()
            return super().order_leaders(leader)

        self._flush_pending()

        # The ONLY device→host transfer on the commit path: W bools.
        committed = leader_commit_scan(
            self._dev_parent, self._dev_exists, *self.leader_flags(leader)
        ).cpu().numpy()

        # Newest-first chain, exactly as the Python order_leaders returns it.
        to_commit = [leader]
        for w in range(window - 1, -1, -1):
            if committed[w]:
                r = base + w
                _, cert = state.dag[r][self._leader_name(r)]
                to_commit.append(cert)
        return to_commit
