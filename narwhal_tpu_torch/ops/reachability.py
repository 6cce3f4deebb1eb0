"""Tusk's commit-path window on the card: three hand-written CUDA kernels.

The port of ``narwhal_tpu/ops/reachability.py``.  The window is a pair of
int32 presence-COUNT tensors that live on ``device`` across calls —
``exists[W, N]`` (certificate present at slot w, authority n) and
``parent[W, N, N]`` (cert (w, n) references cert (w-1, m)) — maintained
and read by three kernels (csrc/reachability.cu):

- :func:`window_apply` scatter-adds a flush of staged certificates
  (replaces the JAX ``window_apply``);
- :func:`window_shift` shifts the window down after a commit (replaces
  ``window_shift_op``);
- :func:`leader_commit_scan` runs the whole linked-leader chain in one
  launch and returns the W-bool committed bitmap (replaces
  ``leader_commit_scan_counts`` and its body ``_chain_scan``).

Where the JAX programs donate their buffers, the port updates the
window tensors in place (apply) or writes into a second pair of buffers
that the caller swaps in (shift).  Each wrapper launches its kernel for a
CUDA tensor and runs the plain PyTorch twin beside it only for a CPU
tensor; the twin is what the CPU tests hold against the JAX programs.
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


# ---------------------------------------------------------------- window_apply


def window_apply_plain(exists, parent, ins_w, ins_i, row_w, row_c, row_v):
    """Plain twin of :func:`window_apply`: index_add_ on flat views.
    Entries whose slot or authority falls outside the window are dropped
    (the JAX ``mode="drop"``)."""
    W, N = exists.shape
    keep = (ins_w >= 0) & (ins_w < W) & (ins_i >= 0) & (ins_i < N)
    flat = (ins_w * N + ins_i)[keep].long()
    exists.view(-1).index_add_(0, flat, torch.ones_like(flat, dtype=exists.dtype))
    keep = (row_w >= 0) & (row_w < W) & (row_c >= 0) & (row_c < N)
    flat = (row_w * N + row_c)[keep].long()
    parent.view(W * N, N).index_add_(0, flat, row_v[keep])
    return exists, parent


def window_apply(exists, parent, ins_w, ins_i, row_w, row_c, row_v):
    """One batched insert flush, in place: exists[ins_w, ins_i] += 1 and
    parent[row_w, row_c, :] += row_v, dropping entries whose slot is
    outside [0, W).  Counts make duplicate and late (waiting-child repair)
    rows order-independent.  Returns the same two tensors."""
    if exists.device.type == "cpu":
        return window_apply_plain(exists, parent, ins_w, ins_i, row_w, row_c, row_v)
    W, N = exists.shape
    C = ins_w.shape[0]
    dev = exists.device
    require(exists, torch.int32, (W, N), dev, "window_apply exists")
    require(parent, torch.int32, (W, N, N), dev, "window_apply parent")
    for name, t in (("ins_w", ins_w), ("ins_i", ins_i), ("row_w", row_w), ("row_c", row_c)):
        require(t, torch.int32, (C,), dev, f"window_apply {name}")
    require(row_v, torch.int32, (C, N), dev, "window_apply row_v")
    fn = kernel_fn("nt_window_apply", _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP)
    rc = fn(ptr(exists), ptr(parent), ptr(ins_w), ptr(ins_i), ptr(row_w),
            ptr(row_c), ptr(row_v), W, N, C, ctypes.c_void_p(stream_handle(dev)))
    check_launch("window_apply", rc)
    return exists, parent


# ---------------------------------------------------------------- window_shift


def window_shift_plain(exists, parent, d, out_exists, out_parent):
    """Plain twin of :func:`window_shift`."""
    W = exists.shape[0]
    out_exists.zero_()
    out_parent.zero_()
    if d < W:
        out_exists[: W - d] = exists[d:]
        # Slot 0 keeps no parent edges (the scan never reads parent[0]).
        out_parent[1 : W - d] = parent[1 + d :]
    return out_exists, out_parent


def window_shift(exists, parent, d: int, out_exists, out_parent):
    """Shift the window down by ``d`` ≥ 0 slots into the second pair of
    buffers (slot w takes slot w+d; vacated top slots and parent slot 0
    are zero).  Out of place: a parallel in-place shift would read slot
    w+d while another thread writes it.  Returns (out_exists, out_parent);
    the caller swaps them in."""
    if d < 0:
        raise ValueError(f"window_shift: d must be >= 0, got {d}")
    if exists.device.type == "cpu":
        return window_shift_plain(exists, parent, d, out_exists, out_parent)
    W, N = exists.shape
    dev = exists.device
    require(exists, torch.int32, (W, N), dev, "window_shift exists")
    require(parent, torch.int32, (W, N, N), dev, "window_shift parent")
    require(out_exists, torch.int32, (W, N), dev, "window_shift out_exists")
    require(out_parent, torch.int32, (W, N, N), dev, "window_shift out_parent")
    fn = kernel_fn("nt_window_shift", _VP, _VP, _VP, _VP, _I, _I, _I, _VP)
    rc = fn(ptr(exists), ptr(parent), ptr(out_exists), ptr(out_parent),
            int(d), W, N, ctypes.c_void_p(stream_handle(dev)))
    check_launch("window_shift", rc)
    return out_exists, out_parent


# ----------------------------------------------------------- leader_commit_scan


def leader_commit_scan_plain(parent, exists, leader_onehot, is_leader_slot,
                             anchor_slot: int, anchor_onehot):
    """Plain twin of :func:`leader_commit_scan`: the JAX ``_chain_scan``
    step by step, descending over the W slots."""
    W, N = exists.shape
    present = exists > 0
    linked = parent > 0
    frontier = torch.zeros(N, dtype=torch.bool, device=exists.device)
    committed = torch.zeros(W, dtype=torch.bool, device=exists.device)
    for w in range(W - 1, -1, -1):
        # Step w consumes parent[w+1] (edges slot w+1 → slot w).
        if w + 1 < W:
            hit = (frontier[:, None] & linked[w + 1]).any(dim=0)
        else:
            hit = torch.zeros_like(frontier)
        g = hit & present[w]
        if w == anchor_slot:
            g = anchor_onehot.clone()
        lead_here = bool(is_leader_slot[w]) and w < anchor_slot and bool(
            (g & leader_onehot[w]).any()
        )
        committed[w] = lead_here
        frontier = g & leader_onehot[w] if lead_here else g
    return committed


def leader_commit_scan(parent, exists, leader_onehot, is_leader_slot,
                       anchor_slot: int, anchor_onehot):
    """The whole linked-leader chain (``order_leaders``) over the count
    window in ONE launch: one block, one thread per authority, the
    frontier in shared memory, W steps in a loop.  Returns committed
    bool[W] on the window's device."""
    if exists.device.type == "cpu":
        return leader_commit_scan_plain(
            parent, exists, leader_onehot, is_leader_slot, anchor_slot,
            anchor_onehot,
        )
    W, N = exists.shape
    if N > 1024:
        raise ValueError(f"leader_commit_scan: N={N} > 1024 (one block)")
    dev = exists.device
    require(parent, torch.int32, (W, N, N), dev, "leader_commit_scan parent")
    require(exists, torch.int32, (W, N), dev, "leader_commit_scan exists")
    require(leader_onehot, torch.bool, (W, N), dev, "leader_commit_scan leader_onehot")
    require(is_leader_slot, torch.bool, (W,), dev, "leader_commit_scan is_leader_slot")
    require(anchor_onehot, torch.bool, (N,), dev, "leader_commit_scan anchor_onehot")
    committed = torch.empty(W, dtype=torch.bool, device=dev)
    fn = kernel_fn("nt_leader_commit_scan", _VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _VP)
    rc = fn(ptr(parent), ptr(exists), ptr(leader_onehot), ptr(is_leader_slot),
            ptr(anchor_onehot), int(anchor_slot), ptr(committed), W, N,
            ctypes.c_void_p(stream_handle(dev)))
    check_launch("leader_commit_scan", rc)
    return committed


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
      waiting-child map), copied to the card in one packed transfer per
      chunk of C rows and applied by :func:`window_apply`; then ONE
      :func:`leader_commit_scan` launch computes the linked-leader chain
      and only its W bools come back to the host.
    - **Commit** (``_win_shift``): :func:`window_shift` moves the window
      down to the new ``last_committed_round`` into the spare buffers,
      which are swapped in; host maps prune below the new base;
      certificates that arrived beyond the window during a stall re-stage.

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
        # The device-resident window (presence COUNTS, nonzero = present)
        # and the spare pair window_shift writes into.
        self._dev_exists, self._dev_parent = self._zero_window()
        self._spare_exists, self._spare_parent = self._zero_window()
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

    def _zero_window(self):
        W, n = self.max_window, self._n
        return (
            torch.zeros((W, n), dtype=torch.int32, device=self.device),
            torch.zeros((W, n, n), dtype=torch.int32, device=self.device),
        )

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
            window_apply(
                self._dev_exists,
                self._dev_parent,
                row[0:C],
                row[C : 2 * C],
                row[2 * C : 3 * C],
                row[3 * C : 4 * C],
                row[4 * C :].view(C, n),
            )

    def _win_shift(self) -> None:
        new_base = max(0, self.state.last_committed_round)
        d = new_base - self._win_base
        if d <= 0:
            return
        if d >= self.max_window:
            # Nothing in the old window survives: zero it, no shift launch.
            self._dev_exists.zero_()
            self._dev_parent.zero_()
        else:
            _m_shifts.inc()
            window_shift(
                self._dev_exists, self._dev_parent, d,
                self._spare_exists, self._spare_parent,
            )
            self._dev_exists, self._spare_exists = (
                self._spare_exists, self._dev_exists,
            )
            self._dev_parent, self._spare_parent = (
                self._spare_parent, self._dev_parent,
            )
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
        e, p = self._zero_window()
        e2, p2 = self._zero_window()
        pad = torch.full((C,), W, dtype=torch.int32, device=self.device)
        zero = torch.zeros((C,), dtype=torch.int32, device=self.device)
        rv = torch.zeros((C, n), dtype=torch.int32, device=self.device)
        window_apply(e, p, pad, zero, pad, zero, rv)
        window_shift(e, p, 1, e2, p2)
        flags = torch.zeros((W, n), dtype=torch.bool, device=self.device)
        leader_commit_scan(
            p2, e2, flags, flags[:, 0].contiguous(), 0,
            flags[0].contiguous(),
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def order_leaders(self, leader) -> List:
        state = self.state
        n = self._n
        base = max(0, state.last_committed_round)
        span = leader.round - base + 1
        window = self.max_window
        if span > window or base != self._win_base:
            self.python_fallbacks += 1
            _m_fallbacks.inc()
            return super().order_leaders(leader)

        self._flush_pending()

        # One packed bool host buffer → one transfer: [leader_onehot (W×n)
        # | is_leader_slot (W) | anchor_onehot (n)].
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
        # The ONLY device→host transfer on the commit path: W bools.
        committed = leader_commit_scan(
            self._dev_parent,
            self._dev_exists,
            dev_flags[: window * n].view(window, n),
            dev_flags[window * n : window * n + window],
            leader.round - base,
            dev_flags[window * n + window :],
        ).cpu().numpy()

        # Newest-first chain, exactly as the Python order_leaders returns it.
        to_commit = [leader]
        for w in range(window - 1, -1, -1):
            if committed[w]:
                r = base + w
                _, cert = state.dag[r][self._leader_name(r)]
                to_commit.append(cert)
        return to_commit
