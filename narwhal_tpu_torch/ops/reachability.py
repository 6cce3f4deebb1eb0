"""Tusk's DAG window on the card: five hand-written CUDA kernels.

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

Three more take the window as bools, as the JAX programs do:

- :func:`leader_chain_scan`, the same chain (one scan body with
  :func:`leader_commit_scan` in the CUDA source) that also returns the
  per-slot reach masks (replaces ``leader_chain_scan``);
- :func:`causal_mask_scan`, the causal cone of one certificate (replaces
  ``causal_mask_scan``);
- :func:`support_stake`, the f+1 support gate's stake sum (replaces
  ``support_stake``).

The flagship commit step (``narwhal_tpu_torch/commit_step.py``) composes
the last and the first of these.

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
carried across them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import metrics
from . import check_launch, kernel_fn, ptr, require, resolve_device, stream_handle

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
    flush by index_add_ on flat views, in each copy.  Flush entries whose
    slot or authority falls outside the window are dropped (the JAX
    ``mode="drop"``)."""
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
    ins_w, ins_i, row_w, row_c, row_v = flush
    keep = (ins_w >= 0) & (ins_w < W) & (ins_i >= 0) & (ins_i < N)
    slot = (ins_w[keep].long() + origin) % W
    ones = torch.ones(slot.shape, dtype=exists.dtype, device=dev)
    keep_r = (row_w >= 0) & (row_w < W) & (row_c >= 0) & (row_c < N)
    slot_r = (row_w[keep_r].long() + origin) % W
    for c in range(copies):
        exists.view(-1).index_add_(0, (slot + c * W) * N + ins_i[keep].long(), ones)
        parent.view(S * N, N).index_add_(
            0, (slot_r + c * W) * N + row_c[keep_r].long(), row_v[keep_r])
    return exists, parent


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
    parent[row_w, row_c, :] += row_v at logical slots, dropping entries
    whose slot is outside [0, W).  Counts make duplicate and late
    (waiting-child repair) rows order-independent.  Returns the two
    tensors."""
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
    dropping entries whose slot is outside [0, W).  The
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


def _support_slot(leader_slot: int, window: int) -> int:
    """The child slot the JAX ``support_stake`` reads for ``leader_slot``:
    its dynamic index ``leader_slot + 1`` counts from the end once when
    negative and is then clamped into [0, W) (JAX does not raise on an
    index out of range)."""
    s = leader_slot + 1
    if s < 0:
        s += window
    return min(max(s, 0), window - 1)


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
    rc = fn(ptr(parent), ptr(exists), ptr(stake), int(leader_slot),
            ptr(leader_onehot), ptr(out), W, N,
            ctypes.c_void_p(stream_handle(dev)))
    check_launch("support_stake", rc)
    return out


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
        ring.shift(1)
        ring.update((pad, zero, pad, zero, rv))  # both phases of the launch
        flags = torch.zeros((W, n), dtype=torch.bool, device=self.device)
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
