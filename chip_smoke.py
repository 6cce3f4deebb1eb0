#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``narwhal_tpu_torch``) on one GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (the window
scans also with rows of several words and in chunks of slots, and the
verifier's batch split against its single launch), then drives two paths
at the N=50 committee size, each with the launch counts set to 0 just
before it and read just after:

- ``commit_step``: the flagship commit step
  (``narwhal_tpu_torch.commit_step.entry()``, W=64), whose support,
  committed chain and reach masks must equal the plain twins' and the
  reference program's values;
- ``main_path``: a primary's certificate path — every round's signature
  claims verified in one batch on the ``cuda`` crypto backend, then the
  certificates through ``Consensus(use_kernel=True)`` on the card, whose
  commit sequence must equal the Python Tusk's; at every commit
  opportunity the bool-window kernels are held against the Tusk on the
  live device window (:class:`LiveWindowCheck`), outside the timings,
  with its launches counted apart from the path's.

One JSON line per phase; the line before the last is the card's name and
power limit as nvidia-smi reports them, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python3 chip_smoke.py

Needs one CUDA GPU; exits non-zero without one, or when run outside a
checkout of the repository.  Imports nothing of JAX or ``narwhal_tpu``.
"""

from __future__ import annotations

import asyncio
import ctypes
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The main path's size: BASELINE.json's 50-node committee (f = 16, a
# quorum of 34 by stake) at the default gc_depth of 50.
N_COMMITTEE = 50
GC_DEPTH = 50
SIGNED_ROUNDS = 10
UNSIGNED_ROUNDS = 150
VERIFY_BATCH = 2048  # one N=50 round's ~1,750 claims, padded
SEED = 20261017

# Published H100 SXM peaks (NVIDIA's H100 datasheet), for
# the least time the card could take: HBM at 3.35 TB/s; 32-bit integer
# multiply-adds at 64 INT32 lanes per SM (half the 128 FP32 lanes behind
# the table's 67 TFLOP/s float32) × 132 SMs × 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 64 * 132 * 1.98e9
# The verifier's field (csrc/field25519.cuh) has 10 limbs of 26/25 bits
# (radix 2^25.5), so a limb product is one 32×32→64-bit multiply-add: a
# general multiply takes 10 × 10 of them, a square 55 (each cross
# product once, doubled).
MADS_PER_FIELD_MUL = 10 * 10
MADS_PER_FIELD_SQ = 55
# Spin-kernel cycles per enqueued call when timing launch-bound kernels:
# ~100 µs at 1.98 GHz, above one wrapper call's host cost.
SPIN_CYCLES_PER_CALL = 200_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def diff(a, b):
    """(mismatching elements, max |a - b|) of two int or bool tensors."""
    d = (a.long() - b.long()).abs()
    return int((d != 0).sum()), float(d.max()) if d.numel() else 0.0


def cuda_ms(fn, iters: int, warmup: int = 1, prefill: bool = False) -> float:
    """Mean time of ``fn`` by CUDA events around ``iters`` calls.  With
    ``prefill`` the stream first runs a spin kernel long enough for the
    host to enqueue every call, so the events time the launches back to
    back on the device, not the host's launch rate (for kernels shorter
    than their host-side call; ``fn`` must not synchronize)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(int(SPIN_CYCLES_PER_CALL * iters))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, iters: int) -> float:
    """Mean wall time of one call of ``fn`` on the host, synchronized."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / iters


# ------------------------------------------------------------ the committee


def make_committee(n: int):
    from narwhal_tpu_torch.config import (
        Authority, Committee, PrimaryAddresses, WorkerAddresses,
    )
    from narwhal_tpu_torch.crypto import KeyPair

    keys = [KeyPair.generate(SEED.to_bytes(8, "little") + bytes([i]) * 24) for i in range(n)]
    authorities = {}
    for i, kp in enumerate(keys):
        addr = f"127.0.0.1:{10000 + 4 * i}"
        authorities[kp.name] = Authority(
            stake=1,
            primary=PrimaryAddresses(primary_to_primary=addr, worker_to_primary=addr),
            workers={0: WorkerAddresses(
                transactions=addr, worker_to_worker=addr, primary_to_worker=addr,
            )},
        )
    return keys, Committee(authorities)


def signed_rounds(keys, committee, rounds: int, rng: random.Random):
    """Fully signed rounds: every authority's header cites all of the
    previous round, and a random quorum of voters signs each certificate."""
    from narwhal_tpu_torch.primary.messages import Certificate, Header, Vote, genesis

    by_name = {kp.name: kp for kp in keys}
    names = sorted(by_name)
    quorum = committee.quorum_threshold()
    parents = [c.digest() for c in genesis(committee)]
    out = []
    for r in range(1, rounds + 1):
        certs = []
        for name in names:
            h = Header(author=name, round=r, payload={}, parents=set(parents))
            h.id = h.compute_digest()
            h.signature = by_name[name].sign(h.id)
            votes = []
            for voter in sorted(rng.sample(names, quorum)):
                v = Vote(id=h.id, round=r, origin=name, author=voter)
                votes.append((voter, by_name[voter].sign(v.digest())))
            certs.append(Certificate(header=h, votes=votes))
        out.append(certs)
        parents = [c.digest() for c in certs]
    return out


def unsigned_rounds(names, start_round, parents, rounds, leader_of, rng):
    """Consensus-only rounds (consensus never reads signatures): random
    parent quorums, and every seventh even round's leader missing, so
    linked-leader chains span several rounds."""
    from narwhal_tpu_torch.primary.messages import Certificate, Header

    n = len(names)
    quorum = 2 * ((n - 1) // 3) + 1
    out = []
    for r in range(start_round, start_round + rounds):
        authors = list(names)
        if r % 14 == 0:
            authors.remove(leader_of(r))
        certs = []
        for name in authors:
            chosen = rng.sample(parents, rng.randint(quorum, len(parents)))
            h = Header(author=name, round=r, payload={}, parents=set(chosen))
            h.id = h.compute_digest()
            certs.append(Certificate(header=h))
        rng.shuffle(certs)
        out.append(certs)
        parents = [c.digest() for c in certs]
    return out


# ----------------------------------------------------------- kernel inputs


def hostile_rows(keys):
    """The hostile encodings of the verifier's tests: S ≥ L, y ≥ p, a
    small-order key, an off-curve key, the wrong key, S = 0, a small-order
    R, and the x = 0 / sign = 1 key.  Returns (rows, small_order_flags)."""
    from narwhal_tpu_torch.crypto.digest import Digest
    from narwhal_tpu_torch.ops import ed25519 as E

    P = E.P
    m = bytes(range(32))
    sig = bytes(keys[0].sign(Digest(m)))
    pk0, pk1 = bytes(keys[0].name), bytes(keys[1].name)
    s_int = int.from_bytes(sig[32:], "little")
    rx, ry = E._ref_scalarmult(12345)
    small_r = (ry | ((rx & 1) << 255)).to_bytes(32, "little")
    y = 2
    while True:  # a y with no x on the curve
        u = (y * y - 1) % P
        v = (E.D_INT * y * y + 1) % P
        if pow(u * pow(v, P - 2, P) % P, (P - 1) // 2, P) == P - 1:
            break
        y += 1
    rows = [
        ((m, pk0, sig[:32] + (s_int + E.L_ORDER).to_bytes(32, "little")), False),
        ((m, (P + 3).to_bytes(32, "little"), sig), False),
        ((m, (1).to_bytes(32, "little"), small_r + (12345).to_bytes(32, "little")), True),
        ((m, y.to_bytes(32, "little"), sig), False),
        ((m, pk1, sig), False),
        ((m, pk0, sig[:32] + bytes(32)), False),
        ((m, pk0, (1).to_bytes(32, "little") + sig[32:]), True),
        ((m, (1 | (1 << 255)).to_bytes(32, "little"), sig), False),
    ]
    return [r for r, _ in rows], [s for _, s in rows]


def verify_rows(dag, keys, batch: int, rng: random.Random):
    """``batch`` rows: the DAG's first claims with ~10% corrupted by one
    bit flip, then the hostile rows.  Returns (rows, kind) with kind in
    honest / corrupted / hostile / hostile_small."""
    claims = [c for certs in dag for cert in certs for c in cert.signature_claims()]
    hostile, small = hostile_rows(keys)
    rows, kind = [], []
    for m, k, s in claims[: batch - len(hostile)]:
        m, k, s = bytes(m), bytes(k), bytes(s)
        if rng.random() < 0.1:
            which = rng.randrange(3)
            buf = bytearray((m, k, s)[which])
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            m, k, s = [bytes(buf) if i == which else x for i, x in enumerate((m, k, s))]
            kind.append("corrupted")
        else:
            kind.append("honest")
        rows.append((m, k, s))
    rows += hostile
    kind += ["hostile_small" if s else "hostile" for s in small]
    return rows, kind


def causal_window(rng, window: int, n: int):
    """A random-but-causal DAG window as int32 presence counts."""
    import numpy as np

    exists = rng.random((window, n)) < 0.9
    exists[0] = True
    parent = np.zeros((window, n, n), dtype=np.int32)
    quorum = 2 * ((n - 1) // 3) + 1
    for w in range(1, window):
        prev = np.flatnonzero(exists[w - 1])
        for i in np.flatnonzero(exists[w]):
            parent[w, i, prev[rng.permutation(len(prev))[:quorum]]] = 1
    return exists.astype(np.int32), parent


# ------------------------------------------------- the live-window check


class LiveWindowCheck:
    """Holds the bool-window kernels against the Tusk at every commit
    opportunity of a ``KernelTusk``, on its live device window cast
    ``> 0``, after the opportunity's own work (so outside its timing):

    - ``leader_chain_scan``'s committed slots are the chain that
      ``order_leaders`` (``leader_commit_scan``) returned;
    - ``support_stake`` at the leader's slot is the stake the host's f+1
      gate counted (``tusk._support``), where the child slot lies in the
      window;
    - for each committed leader, ``causal_mask_scan``'s mask is a host BFS
      over the Tusk's dict DAG restricted to the window's slots, and
      every certificate ``order_dag`` emits for it inside the window lies
      in the mask.  ``order_dag`` also skips by each authority's last
      committed round, so in-mask certificates it does not emit are
      counted (``in_mask_not_emitted``), not asserted on.

    Opportunities the Tusk answered with its Python walk are skipped.
    Disagreements are collected in ``failures``.  The node's own path
    launches none of the three kernels; the check counts its launches in
    ``launches`` so they can be told apart from the path's."""

    KERNELS = ("leader_chain_scan", "support_stake", "causal_mask_scan")

    def __init__(self, tusk) -> None:
        import torch

        self.tusk = tusk
        self.stake = torch.tensor(
            [tusk.committee.stake(k) for k in tusk._sorted_keys],
            dtype=torch.int32, device=tusk.device,
        )
        self.counts = dict(opportunities=0, skipped_python_walk=0,
                           chain_checked=0, support_checked=0,
                           cones_checked=0, emitted_in_window=0,
                           in_mask_not_emitted=0)
        self.launches = dict.fromkeys(self.KERNELS, 0)
        self.failures = []
        self._masks = {}

    def install(self) -> "LiveWindowCheck":
        order_leaders, order_dag = self.tusk.order_leaders, self.tusk.order_dag

        def checked_order_leaders(leader):
            fallbacks = self.tusk.python_fallbacks
            chain = order_leaders(leader)
            self.counts["opportunities"] += 1
            if self.tusk.python_fallbacks != fallbacks:
                self.counts["skipped_python_walk"] += 1
            else:
                self._check_opportunity(leader, chain)
            return chain

        def checked_order_dag(leader):
            ordered = order_dag(leader)
            self._check_emitted(leader, ordered)
            return ordered

        self.tusk.order_leaders = checked_order_leaders
        self.tusk.order_dag = checked_order_dag
        return self

    def _onehot(self, cert):
        import torch

        out = torch.zeros(self.tusk._n, dtype=torch.bool)
        out[self.tusk._index[cert.origin]] = True
        return out.to(self.tusk.device)

    def _host_cone(self, cert, base: int, window: int):
        """Host BFS from ``cert`` down the dict DAG to the window's base."""
        import numpy as np

        dag, index = self.tusk.state.dag, self.tusk._index
        cone = np.zeros((window, self.tusk._n), dtype=bool)
        level = [cert]
        for r in range(cert.round, base - 1, -1):
            for c in level:
                cone[r - base, index[c.origin]] = True
            wanted = set()
            for c in level:
                wanted.update(c.header.parents)
            level = [c for d, c in dag.get(r - 1, {}).values() if d in wanted]
        return cone

    def _check_opportunity(self, leader, chain) -> None:
        from narwhal_tpu_torch.ops import LAUNCHES

        before = dict(LAUNCHES)
        self._compare(leader, chain)
        for name in self.KERNELS:
            self.launches[name] += LAUNCHES[name] - before[name]

    def _compare(self, leader, chain) -> None:
        import numpy as np

        from narwhal_tpu_torch.ops import reachability as R

        tusk = self.tusk
        base, window = tusk._win_base, tusk.max_window
        parent, exists = tusk._dev_parent > 0, tusk._dev_exists > 0
        committed, _ = R.leader_chain_scan(parent, exists, *tusk.leader_flags(leader))
        want = np.zeros(window, dtype=bool)
        for c in chain[1:]:
            want[c.round - base] = True
        self.counts["chain_checked"] += 1
        if not np.array_equal(committed.cpu().numpy(), want):
            self.failures.append(("chain", leader.round))
        slot = leader.round - base
        if slot + 1 < window:
            got = int(R.support_stake(parent, exists, self.stake, slot,
                                      self._onehot(leader)))
            self.counts["support_checked"] += 1
            if got != tusk._support.get(leader.round, 0):
                self.failures.append(("support", leader.round, got,
                                      tusk._support.get(leader.round, 0)))
        for c in chain:
            mask = R.causal_mask_scan(parent, exists, c.round - base,
                                      self._onehot(c)).cpu().numpy()
            self.counts["cones_checked"] += 1
            if not np.array_equal(mask, self._host_cone(c, base, window)):
                self.failures.append(("cone", c.round))
            self._masks[bytes(c.digest())] = (base, mask)

    def _check_emitted(self, leader, ordered) -> None:
        entry = self._masks.pop(bytes(leader.digest()), None)
        if entry is None:
            return
        base, mask = entry
        index = self.tusk._index
        emitted = 0
        for x in ordered:
            w = x.round - base
            if 0 <= w < mask.shape[0]:
                emitted += 1
                if not mask[w, index[x.origin]]:
                    self.failures.append(("emitted", leader.round, x.round))
        self.counts["emitted_in_window"] += emitted
        self.counts["in_mask_not_emitted"] += int(mask.sum()) - emitted


# ------------------------------------------------------------------ phases


def phase_kernels(dag, keys, device, rng):
    """Each kernel against its plain version on the card, exactly; times
    at the main path's shapes.  Returns the per-kernel records."""
    import numpy as np
    import torch

    from narwhal_tpu_torch.crypto import _ed25519_py
    from narwhal_tpu_torch.ops import LAUNCHES, kernel_fn, ed25519 as E, reachability as R

    records = {}

    def tensors(arrays):
        return E.to_device(arrays, device)

    # -- the verifier, B = 2048 and the same rows tiled to 16384
    rows, kind = verify_rows(dag, keys, VERIFY_BATCH, rng)
    prep = E.prepare_batch(*zip(*rows), VERIFY_BATCH)
    args = tensors(prep)
    before = dict(LAUNCHES)
    got = E.verify_kernel(*args)
    torch.cuda.synchronize()
    want = E.verify_plain(*args)
    mism, err = diff(got, want)
    mask = got.cpu().numpy()
    honest = np.array([k == "honest" for k in kind])
    assert mask[honest].all(), "an honest signature was rejected"
    assert not mask[~honest & np.array([k.startswith("hostile") for k in kind])].any()
    # 64 honest and corrupted rows (8 of them corrupted at least), plus
    # the hostile rows where the pure-Python verifier is as strict.
    corrupted = [i for i, k in enumerate(kind) if k == "corrupted"][:8]
    sample = corrupted + [
        i for i, k in enumerate(kind) if k in ("honest", "corrupted")
        and i not in corrupted
    ][: 64 - len(corrupted)]
    sample += [i for i, k in enumerate(kind) if k == "hostile"]
    py_mism = sum(
        int(_ed25519_py.verify(rows[i][1], rows[i][0], rows[i][2]) != bool(mask[i]))
        for i in sample
    )
    tiled = tensors([np.concatenate([a] * 8, axis=0) for a in prep])
    got16 = E.verify_kernel(*tiled)
    want16 = E.verify_plain(*tiled)
    mism16, err16 = diff(got16, want16)
    assert bool((got16.view(8, -1) == got.view(1, -1)).all())
    check_launches = LAUNCHES["ed25519_verify"] - before["ed25519_verify"]
    t_plain0 = time.perf_counter()
    E.verify_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.perf_counter() - t_plain0)
    regs, local_bytes = ctypes.c_int(), ctypes.c_int()
    rc = kernel_fn("nt_ed25519_verify_attributes", ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int))(ctypes.byref(regs), ctypes.byref(local_bytes))
    assert rc == 0, f"cudaFuncGetAttributes failed: cudaError {rc}"
    # The design keeps every table on chip: no local memory at all.
    assert local_bytes.value == 0, f"verify kernel uses local memory: {local_bytes.value}"
    launch = {b: verify_launch_shape(b) for b in (VERIFY_BATCH, 8 * VERIFY_BATCH)}
    records["ed25519_verify"] = dict(
        replaces="narwhal_tpu/ops/ed25519.py:232",
        source="narwhal_tpu_torch/csrc/ed25519_verify.cu",
        mismatches=mism + mism16 + py_mism,
        max_abs_err=max(err, err16, float(py_mism > 0)),
        check_launches=check_launches,
        ms=cuda_ms(lambda: E.verify_kernel(*args), 20),
        host_ms_per_call=host_ms(lambda: E.verify_kernel(*args), 20),
        plain_ms=plain_ms,
        bound_ms=1000 * max(
            VERIFY_BATCH * (sum(a[0].nbytes for a in prep) + 1) / HBM_BYTES_PER_S,
            VERIFY_BATCH * ((E.FIELD_MULS_PER_VERIFY - E.FIELD_SQS_PER_VERIFY)
                            * MADS_PER_FIELD_MUL
                            + E.FIELD_SQS_PER_VERIFY * MADS_PER_FIELD_SQ)
            / INT32_MADS_PER_S,
        ),
        bound_by="operations",
        library_ms=None,
        extra=dict(
            ms_b16384=cuda_ms(lambda: E.verify_kernel(*tiled), 5),
            checked=dict(b2048=VERIFY_BATCH, b16384=8 * VERIFY_BATCH,
                         py_sample=len(sample),
                         corrupted=kind.count("corrupted"),
                         hostile=sum(k.startswith("hostile") for k in kind)),
            registers_per_thread=regs.value,
            local_bytes_per_thread=local_bytes.value,
            launch_b2048=launch[VERIFY_BATCH],
            grid_b16384=launch[8 * VERIFY_BATCH]["grid"],
        ),
    )

    # -- the window kernels at W = 64, N = 50
    nrng = np.random.default_rng(SEED)
    W, N = 64, N_COMMITTEE

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # The standalone apply's inputs first, drawn as before the ring so that
    # the scans below see the same windows as the parent's smoke.
    exists_np, parent_np = causal_window(nrng, W, N)
    flush_np = random_flush(nrng, W, N, 256)
    records["window_update"] = window_update_record(
        np.random.default_rng(SEED + 1), dev, exists_np, parent_np, flush_np)

    scan_mism, scan_err = 0, 0.0
    before = dict(LAUNCHES)
    committed_total = 0
    scan_args = None
    for trial in range(4):
        e_np, p_np = causal_window(nrng, W, N)
        leader, is_lead = leader_schedule(e_np)
        anchor_slot = W - 2 - 2 * trial
        anchor = np.zeros(N, dtype=bool)
        anchor[int(np.flatnonzero(e_np[anchor_slot])[0])] = True
        scan_args = (dev(p_np), dev(e_np), dev(leader), dev(is_lead), anchor_slot, dev(anchor))
        got = R.leader_commit_scan(*scan_args)
        want = R.leader_commit_scan_plain(*scan_args)
        m1, e1 = diff(got, want)
        scan_mism += m1
        scan_err = max(scan_err, e1)
        committed_total += int(got.sum())
    scan_launches = LAUNCHES["leader_commit_scan"] - before["leader_commit_scan"]
    assert committed_total > 0, "the scan check committed nothing"
    records["leader_commit_scan"] = dict(
        replaces="narwhal_tpu/ops/reachability.py:209",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=scan_mism,
        max_abs_err=scan_err,
        check_launches=scan_launches,
        ms=cuda_ms(lambda: R.leader_commit_scan(*scan_args), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: R.leader_commit_scan(*scan_args), 100),
        plain_ms=cuda_ms(lambda: R.leader_commit_scan_plain(*scan_args), 5),
        library_ms=None,
        bound_ms=1000 * (4 * (W * N * N + W * N) + (W * N + W + N) + W) / HBM_BYTES_PER_S,
        bound_by="bytes",
        committed_in_check=committed_total,
    )

    # -- the bool-window kernels of the commit step and the causal cone,
    #    at W = 64, N = 50, on fresh random causal windows
    chain_mism, chain_err, cases, committed_total = 0, 0.0, [], 0
    before = dict(LAUNCHES)
    for trial in range(3):
        e_np, p_np = causal_window(nrng, W, N)
        e_b, p_b = dev(e_np > 0), dev(p_np > 0)
        leader, is_lead = leader_schedule(e_np)
        none_w, none_s = np.zeros_like(leader), np.zeros_like(is_lead)
        for anchor_slot, lo, isl in ((W - 2, leader, is_lead),
                                     (W - 3 - 2 * trial, leader, is_lead),
                                     (W - 2, none_w, none_s),  # no linked leader
                                     (W, leader, is_lead)):  # outside the window
            anchor = np.zeros(N, dtype=bool)
            anchor[int(nrng.integers(N))] = True
            a = (p_b, e_b, dev(lo), dev(isl), anchor_slot, dev(anchor))
            (gc, gr), (wc, wr) = R.leader_chain_scan(*a), R.leader_chain_scan_plain(*a)
            (m1, e1), (m2, e2) = diff(gc, wc), diff(gr, wr)
            chain_mism += m1 + m2
            chain_err = max(chain_err, e1, e2)
            committed_total += int(gc.sum())
            if not lo.any():
                assert not bool(gc.any()), "a chain with no leader committed"
            cases.append((a, gc, gr))
    chain_launches = LAUNCHES["leader_chain_scan"] - before["leader_chain_scan"]
    assert committed_total > 0, "the chain scan check committed nothing"
    chain_args, chain_c, chain_r = cases[0]
    records["leader_chain_scan"] = dict(
        replaces="narwhal_tpu/ops/reachability.py:144",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=chain_mism,
        max_abs_err=chain_err,
        check_launches=chain_launches,
        ms=cuda_ms(lambda: R.leader_chain_scan(*chain_args), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: R.leader_chain_scan(*chain_args), 100),
        plain_ms=cuda_ms(lambda: R.leader_chain_scan_plain(*chain_args), 5),
        library_ms=None,
        bound_ms=1000 * chain_scan_bytes(chain_c, chain_r, chain_args[2], N)
        / HBM_BYTES_PER_S,
        bound_by="bytes",
        extra=dict(cases=len(cases), committed_in_check=committed_total),
    )

    cone_mism, cone_err, cone_cases = 0, 0.0, 0
    before = dict(LAUNCHES)
    e_np, p_np = causal_window(nrng, W, N)
    e_b, p_b = dev(e_np > 0), dev(p_np > 0)
    for start_slot in (W - 1, W - 2, W // 2, 1, 0, W, -1):
        onehot = np.zeros(N, dtype=bool)
        if 0 <= start_slot < W:
            onehot[int(np.flatnonzero(e_np[start_slot])[0])] = True
        else:
            onehot[0] = True
        a = (p_b, e_b, start_slot, dev(onehot))
        got, want = R.causal_mask_scan(*a), R.causal_mask_scan_plain(*a)
        m1, e1 = diff(got, want)
        cone_mism += m1
        cone_err = max(cone_err, e1)
        cone_cases += 1
        if not 0 <= start_slot < W:
            assert not bool(got.any()), "a cone from outside the window"
    cone_launches = LAUNCHES["causal_mask_scan"] - before["causal_mask_scan"]
    cone_args = (p_b, e_b, W - 2, dev(np.eye(N, dtype=bool)[int(np.flatnonzero(e_np[W - 2])[0])]))
    cone_mask = R.causal_mask_scan(*cone_args)
    records["causal_mask_scan"] = dict(
        replaces="narwhal_tpu/ops/reachability.py:230",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=cone_mism,
        max_abs_err=cone_err,
        check_launches=cone_launches,
        ms=cuda_ms(lambda: R.causal_mask_scan(*cone_args), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: R.causal_mask_scan(*cone_args), 100),
        plain_ms=cuda_ms(lambda: R.causal_mask_scan_plain(*cone_args), 5),
        library_ms=None,
        bound_ms=1000 * cone_bytes(cone_mask, N) / HBM_BYTES_PER_S,
        bound_by="bytes",
        extra=dict(cases=cone_cases, cone_cells=int(cone_mask.sum())),
    )

    # -- the three scans' launch and cycles at the main path's shape, and
    #    the scans at rows of several 32-bit words and in chunks of slots
    timed_scans = dict(
        leader_commit_scan=lambda: R.leader_commit_scan(*scan_args),
        leader_chain_scan=lambda: R.leader_chain_scan(*chain_args),
        causal_mask_scan=lambda: R.causal_mask_scan(*cone_args),
    )
    for name, shapes in scan_shape_checks(nrng, dev).items():
        rec = records[name]
        rec["mismatches"] += sum(x["mismatches"] for x in shapes)
        extra = rec.setdefault("extra", {})
        extra["launch_w64_n50"] = scan_launch(name, W, N)
        extra["cycles_w64_n50"] = scan_cycles(timed_scans[name])
        extra["shapes"] = shapes
        # One N for each row width the launch instantiates (1 to 32 words).
        extra["registers_by_n"] = {
            n: scan_launch(name, W, n)["registers_per_thread"]
            for n in (1, 33, 65, 129, 257, 513)}

    stake_mism, stake_err = 0, 0.0
    before = dict(LAUNCHES)
    stake = dev(nrng.integers(1, 100, N).astype(np.int32))
    for leader_slot in range(-1, W):
        onehot = np.zeros(N, dtype=bool)
        onehot[int(nrng.integers(N))] = True
        a = (p_b, e_b, stake, leader_slot, dev(onehot))
        got, want = R.support_stake(*a), R.support_stake_plain(*a)
        m1, e1 = diff(got, want)
        stake_mism += m1
        stake_err = max(stake_err, e1)
    stake_launches = LAUNCHES["support_stake"] - before["support_stake"]
    stake_args = (p_b, e_b, stake, W - 4, dev(np.eye(N, dtype=bool)[0]))
    records["support_stake"] = dict(
        replaces="narwhal_tpu/ops/reachability.py:267",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=stake_mism,
        max_abs_err=stake_err,
        check_launches=stake_launches,
        ms=cuda_ms(lambda: R.support_stake(*stake_args), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: R.support_stake(*stake_args), 100),
        plain_ms=cuda_ms(lambda: R.support_stake_plain(*stake_args), 20),
        library_ms=None,
        # One child slot's parent rows and exists row, the stake and the
        # leader's one-hot read once; the int32 sum written once.
        bound_ms=1000 * (N * N + N + 4 * N + N + 4) / HBM_BYTES_PER_S,
        bound_by="bytes",
        extra=dict(leader_slots=f"-1..{W - 1}"),
    )

    # -- the verifier's batch split (the reference's NARWHAL_VERIFY_MESH
    #    path) against the single launch, on the same B = 2048 rows
    routes = []
    cards = torch.cuda.device_count()
    splits = [[device, device]]
    if cards > 1:
        splits.append([torch.device("cuda", k) for k in range(cards)])
    for devices in splits:
        before = dict(LAUNCHES)
        split = E.verify_sharded(args, devices)
        torch.cuda.synchronize()
        launches = LAUNCHES["ed25519_verify"] - before["ed25519_verify"]
        assert launches == len(devices), launches
        m1 = int((split != mask).sum())
        routes.append(dict(
            launcher="verify_sharded",
            replaces="narwhal_tpu/ops/ed25519.py:387",
            shards=len(devices), cards=len({d.index for d in devices}),
            mismatches=m1, max_abs_err=float(m1 > 0), check_launches=launches,
            # Events around the whole call: the shards' launches and the
            # copies of their masks to the host.
            ms=cuda_ms(lambda: E.verify_sharded(args, devices), 10),
            host_ms_per_call=host_ms(lambda: E.verify_sharded(args, devices), 10),
        ))
    records["ed25519_verify"]["extra"]["routes"] = routes
    return records


# The ring's launch is checked at the main path's shape and at the scans'
# larger ones; C staged rows per launch as KernelTusk pads them.
UPDATE_SHAPES = ((64, N_COMMITTEE), (64, 200), (8, 1024))
UPDATE_ROWS = 256


def random_flush(nrng, W: int, N: int, C: int):
    """C flush entries at random logical slots in [0, W] (W is padding,
    dropped); one parent cell is hit by two rows."""
    import numpy as np

    ins_w = nrng.integers(0, W + 1, C).astype(np.int32)
    ins_i = nrng.integers(0, N, C).astype(np.int32)
    row_w = nrng.integers(0, W + 1, C).astype(np.int32)
    row_c = nrng.integers(0, N, C).astype(np.int32)
    row_v = (nrng.random((C, N)) < 0.7).astype(np.int32)
    row_w[1], row_c[1] = row_w[0] % W, row_c[0]
    row_w[0] = row_w[1]
    return ins_w, ins_i, row_w, row_c, row_v


def commit_flush(nrng, W: int, N: int, C: int, certs: int = 100):
    """A steady commit opportunity's flush: ``certs`` certificates of the
    rounds at logical slots 2 and up, each with a parent row of a quorum
    or more, padded to C entries whose rows hold junk values that the
    kernel must not read (their slot, W, drops them)."""
    import numpy as np

    quorum = 2 * ((N - 1) // 3) + 1
    ins_w = np.full(C, W, np.int32)
    ins_i = np.zeros(C, np.int32)
    row_v = nrng.integers(1, 4, (C, N)).astype(np.int32)
    k = np.arange(certs)
    ins_w[:certs] = np.minimum(2 + k // N, W - 1)
    ins_i[:certs] = k % N
    row_v[:certs] = 0
    for j in range(certs):
        row_v[j, nrng.permutation(N)[: int(nrng.integers(quorum, N + 1))]] = 1
    return ins_w, ins_i, ins_w.copy(), ins_i.copy(), row_v


def window_update_record(nrng, dev, exists_np, parent_np, flush_np) -> dict:
    """``window_update`` against its plain twin on the card: the
    standalone apply (no ring) on the parent smoke's inputs, then the
    mirrored ring at UPDATE_SHAPES with origins whose views wrap, a
    retired run that wraps below slot 0, flushes that land in the retired
    slots or span several rounds of a block's entries, a clear with no
    flush and a flush with no clear.  Times the three forms of the ring's
    launch — the flush alone (JAX ``window_apply``), the clear of a shift
    by 2 alone (``window_shift_op``) and both (the main path's launch) —
    at every shape, and at N = 50 also its host cost, its plain twin and
    the PyTorch calls for the same function."""
    import numpy as np
    import torch

    from narwhal_tpu_torch.ops import LAUNCHES, reachability as R

    before = dict(LAUNCHES)
    mism, err = 0, 0.0

    def check(got, want):
        nonlocal mism, err
        for a, b in zip(got, want):
            m, e = diff(a, b)
            mism += m
            err = max(err, e)

    flush = [dev(a) for a in flush_np]
    ke, kp, pe, pp = (dev(a) for a in (exists_np, parent_np, exists_np, parent_np))
    R.window_apply(ke, kp, *flush)
    R.window_apply_plain(pe, pp, *flush)
    check((ke, kp), (pe, pp))
    apply_args = (dev(exists_np), dev(parent_np), *flush)
    apply_ms = cuda_ms(lambda: R.window_apply(*apply_args), 100, prefill=True)

    shapes, forms = [], {}
    for W, N in UPDATE_SHAPES:
        e_np, p_np = causal_window(nrng, W, N)
        p_np *= nrng.integers(1, 4, p_np.shape, dtype=np.int32)
        e2_np, p2_np = np.concatenate([e_np, e_np]), np.concatenate([p_np, p_np])
        rand = [dev(a) for a in random_flush(nrng, W, N, UPDATE_ROWS)]
        long = [dev(a) for a in random_flush(nrng, W, N, 2 * UPDATE_ROWS + 88)]
        cases = ((W - 1, 2, True, rand), (1, 3, True, rand), (W // 2, 0, False, rand),
                 (3, W - 1, True, None), (0, 0, True, None), (5, 1, True, long))
        for origin, retired, slot0, fl in cases:
            k2, q2 = dev(e2_np), dev(p2_np)
            R.window_update(k2, q2, fl, window=W, origin=origin, retired=retired,
                            clear_slot0=slot0)
            want = R.window_update_plain(dev(e2_np), dev(p2_np), fl, window=W,
                                         origin=origin, retired=retired,
                                         clear_slot0=slot0)
            check((k2, q2), want)
        # The three forms at origin W - 1, a shift by 2 where a clear runs.
        steady = [dev(a) for a in commit_flush(nrng, W, N, UPDATE_ROWS)]
        e2, p2 = dev(e2_np), dev(p2_np)
        o = W - 1
        form_args = dict(flush=(steady, 0, False), clear=(None, 2, True),
                         both=(steady, 2, True))
        shape = dict(window=W, committee=N, cases=len(cases))
        for name, (fl, retired, slot0) in form_args.items():
            def call(fl=fl, retired=retired, slot0=slot0):
                R.window_update(e2, p2, fl, window=W, origin=o, retired=retired,
                                clear_slot0=slot0)
            shape[f"ms_{name}"] = cuda_ms(call, 100, prefill=True)
            if W == 64 and N == N_COMMITTEE:
                forms[name] = update_form(e2, p2, fl, W, o, retired, slot0, call)
        shapes.append(shape)
    main = forms["both"]
    return dict(
        replaces="narwhal_tpu/ops/reachability.py:187 (window_shift_op), :163 (window_apply)",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=mism, max_abs_err=err,
        check_launches=LAUNCHES["window_update"] - before["window_update"],
        ms=main["ms"], host_ms_per_call=main["host_ms_per_call"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        bound_ms=main["bound_ms"], bound_by="bytes",
        extra=dict(forms=forms, shapes=shapes, apply_no_ring_ms=apply_ms),
    )


def update_form(e2, p2, flush, W, origin, retired, clear_slot0, call) -> dict:
    """One form of the ring's launch at the main path's shape: its time,
    host cost, plain twin's time, the PyTorch calls for the same function
    (``index_fill_`` on the two buffers for the clear,
    ``index_put_(accumulate=True)`` on both copies for the flush) and its
    bound: the flush's index vectors, the values of its kept rows, and each
    cell it changes read once and written to both copies; the cleared
    slots written once in each copy."""
    import torch

    from narwhal_tpu_torch.ops import reachability as R

    N = e2.shape[1]
    lib, nbytes = [], 0
    if retired or clear_slot0:
        gone = torch.arange(origin - retired, origin, device=e2.device) % W
        gone2 = torch.cat([gone, gone + W])
        slot0 = torch.tensor([origin, origin + W], device=e2.device)
        gone_p = torch.cat([gone2, slot0]) if clear_slot0 else gone2
        lib.append(lambda: (e2.index_fill_(0, gone2, 0), p2.index_fill_(0, gone_p, 0)))
        nbytes += 4 * (gone2.numel() * N + gone_p.numel() * N * N)
    if flush is not None:
        ins_w, ins_i, row_w, row_c, row_v = flush
        keep_i, keep_r = ins_w < W, row_w < W
        si = (ins_w[keep_i].long() + origin) % W
        sr = (row_w[keep_r].long() + origin) % W
        ii, rc, rv = ins_i[keep_i].long(), row_c[keep_r].long(), row_v[keep_r]
        e_idx = (torch.cat([si, si + W]), torch.cat([ii, ii]))
        p_idx = (torch.cat([sr, sr + W]), torch.cat([rc, rc]))
        ones, rv2 = torch.ones_like(e_idx[0], dtype=torch.int32), torch.cat([rv, rv])
        lib.append(lambda: (e2.index_put_(e_idx, ones, accumulate=True),
                            p2.index_put_(p_idx, rv2, accumulate=True)))
        touched = int((rv != 0).sum()) + int(keep_i.sum())
        nbytes += 16 * ins_w.numel() + 4 * rv.numel() + 4 * 3 * touched

    def library():
        for f in lib:
            f()

    def plain():
        R.window_update_plain(e2, p2, flush, window=W, origin=origin,
                              retired=retired, clear_slot0=clear_slot0)

    return dict(
        ms=cuda_ms(call, 100, prefill=True),
        host_ms_per_call=host_ms(call, 100),
        plain_ms=cuda_ms(plain, 20),
        library_ms=cuda_ms(library, 100, prefill=True),
        bound_ms=1000 * nbytes / HBM_BYTES_PER_S,
    )


def verify_launch_shape(batch: int) -> dict:
    """The verify kernel's launch for ``batch`` signatures: grid, block,
    static shared memory per block, and blocks resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from narwhal_tpu_torch.ops import kernel_fn

    out = [ctypes.c_int() for _ in range(4)]
    rc = kernel_fn("nt_ed25519_verify_launch", ctypes.c_int,
                   *[ctypes.POINTER(ctypes.c_int)] * 4)(
        batch, *[ctypes.byref(o) for o in out])
    assert rc == 0, f"nt_ed25519_verify_launch failed: cudaError {rc}"
    return dict(zip(("grid", "block", "shared_bytes_per_block", "blocks_per_sm"),
                    (o.value for o in out)))


SCAN_KERNELS = ("leader_commit_scan", "leader_chain_scan", "causal_mask_scan")
# Rows of 3 and 7 words of 32 bits, and a window whose slots fill a
# block's shared memory one at a time (csrc/window_bits.cuh's chunks).
SCAN_SHAPES = ((64, 65), (64, 200), (8, 1024))


def scan_launch(name: str, W: int, N: int) -> dict:
    """A scan's launch at (W, N) (``nt_window_scan_attributes``):
    registers, local and static shared bytes per thread, block size,
    dynamic shared bytes per block, slots per chunk and blocks (one
    cluster)."""
    from narwhal_tpu_torch.ops import kernel_fn

    out = (ctypes.c_int * 7)()
    rc = kernel_fn("nt_window_scan_attributes", ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int))(
        SCAN_KERNELS.index(name), W, N, out)
    assert rc == 0, f"nt_window_scan_attributes failed: cudaError {rc}"
    launch = dict(zip(("registers_per_thread", "local_bytes_per_thread",
                       "static_shared_bytes", "block", "dynamic_shared_bytes",
                       "slots_per_chunk", "blocks"), out))
    # The design keeps the frontier and the rows in registers.
    assert launch["local_bytes_per_thread"] == 0, (name, W, N, launch)
    return launch


def scan_cycles(fn) -> dict:
    """Where one scan's time goes (``nt_window_scan_cycles``): SM clock
    cycles of the pack (to the barrier that ends it), the scan, the
    whole, and the chunks, from one launch of ``fn`` after a warm-up."""
    import torch

    from narwhal_tpu_torch.ops import kernel_fn

    fn()
    fn()
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 4)()
    rc = kernel_fn("nt_window_scan_cycles", ctypes.POINTER(ctypes.c_ulonglong))(out)
    assert rc == 0, f"nt_window_scan_cycles failed: cudaError {rc}"
    return dict(zip(("pack", "scan", "whole", "chunks"), out))


def scan_shape_checks(nrng, dev) -> dict:
    """The three scans against their plain versions at SCAN_SHAPES (counts
    up to 3 in the int32 window), from an anchor (start) near the top, in
    the middle and outside the window.  Returns per scan one record a
    shape: mismatches, the time of one call, and the launch."""
    import numpy as np

    from narwhal_tpu_torch.ops import reachability as R

    out = {name: [] for name in SCAN_KERNELS}
    for W, N in SCAN_SHAPES:
        e_np, p_np = causal_window(nrng, W, N)
        p_np *= nrng.integers(1, 4, p_np.shape, dtype=np.int32)
        leader, is_lead = leader_schedule(e_np)
        pc, ec, pb, eb = dev(p_np), dev(e_np), dev(p_np > 0), dev(e_np > 0)
        mism = dict.fromkeys(SCAN_KERNELS, 0)
        committed, cone_cells = 0, 0
        timed = {}
        for slot in (W - 2, W // 2, W):
            onehot = np.zeros(N, dtype=bool)
            onehot[int(np.flatnonzero(e_np[min(slot, W - 1)])[0])] = True
            a = (dev(leader), dev(is_lead), slot, dev(onehot))
            mism["leader_commit_scan"] += diff(R.leader_commit_scan(pc, ec, *a),
                                               R.leader_commit_scan_plain(pc, ec, *a))[0]
            (gc, gr), (wc, wr) = R.leader_chain_scan(pb, eb, *a), R.leader_chain_scan_plain(pb, eb, *a)
            mism["leader_chain_scan"] += diff(gc, wc)[0] + diff(gr, wr)[0]
            got = R.causal_mask_scan(pb, eb, slot, a[3])
            mism["causal_mask_scan"] += diff(got, R.causal_mask_scan_plain(pb, eb, slot, a[3]))[0]
            committed += int(gc.sum())
            cone_cells += int(got.sum())
            if slot == W - 2:
                timed = dict(
                    leader_commit_scan=lambda a=a: R.leader_commit_scan(pc, ec, *a),
                    leader_chain_scan=lambda a=a: R.leader_chain_scan(pb, eb, *a),
                    causal_mask_scan=lambda a=a: R.causal_mask_scan(pb, eb, a[2], a[3]),
                )
        for name in SCAN_KERNELS:
            out[name].append(dict(
                window=W, committee=N, mismatches=mism[name],
                ms=cuda_ms(timed[name], 20, prefill=True),
                committed=committed, cone_cells=cone_cells,
                **scan_launch(name, W, N)))
    return out


def leader_schedule(exists):
    """Leaders on the even slots 2..W-2, present where the slot's
    authority w mod N has a certificate."""
    import numpy as np

    W, N = exists.shape
    leader = np.zeros((W, N), dtype=bool)
    is_lead = np.zeros(W, dtype=bool)
    for w in range(2, W - 1, 2):
        leader[w, w % N] = bool(exists[w, w % N])
        is_lead[w] = bool(exists[w, w % N])
    return leader, is_lead


def chain_scan_bytes(committed, reach, leader_onehot, n: int) -> int:
    """Bytes the chain scan must move on these inputs: the N-byte parent
    rows of the certificates its frontier holds (step w reads the rows of
    slot w+1's frontier), exists, the leader one-hots and the anchor read
    once; committed and reach written once."""
    W = reach.shape[0]
    # The frontier after step w: reach[w], cut to the leader where the
    # step committed one.
    frontier = reach & (~committed[:, None] | leader_onehot)
    return int(frontier[1:].sum()) * n + 2 * W * n + W + n + W + W * n


def cone_bytes(mask, n: int) -> int:
    """Bytes the causal-cone scan must move: the parent rows of the cone's
    certificates above slot 0, exists and the start one-hot read once,
    the mask written once."""
    W = mask.shape[0]
    return int(mask[1:].sum()) * n + W * n + n + W * n


async def drive_main_path(committee, signed, unsigned, expected, timings):
    """Verify each signed round's claims in one batch on the cuda backend
    and feed the certificates to Consensus(use_kernel=True); then feed the
    unsigned stretch.  Returns the committed certificates."""
    import torch

    from narwhal_tpu_torch.consensus import Consensus
    from narwhal_tpu_torch.crypto import backend as cb
    from narwhal_tpu_torch.ops import ed25519 as E

    rx, tx_primary, tx_output = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()
    consensus = Consensus(
        committee, GC_DEPTH, rx, tx_primary, tx_output, use_kernel=True,
    )
    tusk = consensus.tusk
    tusk.prewarm()
    order_leaders = tusk.order_leaders

    def timed_order_leaders(leader):
        t0 = time.perf_counter()
        out = order_leaders(leader)  # flush + scan + the W-bool fetch
        timings["commit_opportunity_s"].append(time.perf_counter() - t0)
        return out

    tusk.order_leaders = timed_order_leaders
    flush_pending = tusk._flush_pending

    def timed_flush():
        t0 = time.perf_counter()
        flush_pending()  # staged rows → one packed copy → window_update
        timings["flush_s"].append(time.perf_counter() - t0)

    tusk._flush_pending = timed_flush
    win_shift = tusk._win_shift

    def timed_shift():
        t0 = time.perf_counter()
        win_shift()  # after a commit: the window's shift
        timings["shift_s"].append(time.perf_counter() - t0)

    tusk._win_shift = timed_shift
    # The live-window check wraps the timed call, so its work stays out of
    # the commit-opportunity figures.
    timings["live_check"] = LiveWindowCheck(tusk).install()
    from narwhal_tpu_torch.ops import reset_launches

    committed = []

    async def collect(n_total):
        while len(committed) < n_total:
            committed.append(await asyncio.wait_for(tx_output.get(), 120))

    reset_launches()  # the main path's launches start here
    runner = asyncio.ensure_future(consensus.run())
    try:
        for certs in signed:
            claims = [c for cert in certs for c in cert.signature_claims()]
            t0 = time.perf_counter()  # host prep alone, off the clock below
            E.prepare_batch(*zip(*claims), E.pad_size(len(claims)))
            timings["prep_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            mask = await cb.averify_batch_mask(
                [m for m, _, _ in claims], [k for _, k, _ in claims],
                [s for _, _, s in claims], site="batch_burst",
            )
            timings["verify_s"].append(time.perf_counter() - t0)
            timings["claims"].append(len(claims))
            assert all(mask), "an honest round was rejected"
            for cert in certs:
                await rx.put(cert)
        await collect(expected["signed"])
        timings["after_signed"] = len(committed)
        for certs in unsigned:
            for cert in certs:
                await rx.put(cert)
        await collect(expected["total"])
        torch.cuda.synchronize()
    finally:
        runner.cancel()
        try:
            await runner
        except asyncio.CancelledError:
            pass
    return committed, tusk


def phase_commit_step(device):
    """The flagship commit step (``narwhal_tpu_torch.commit_step.entry``)
    at N = 50, W = 64: a few steps with the launch counts set to 0 just
    before and read just after, the outputs against the plain twins on
    the card and against the reference program's values."""
    import torch

    from narwhal_tpu_torch import commit_step as CS
    from narwhal_tpu_torch.ops import LAUNCHES, reset_launches
    from narwhal_tpu_torch.ops import reachability as R

    step, args = CS.entry()
    parent, exists, leader_onehot, is_leader_slot, stake, anchor_slot, anchor = args
    assert parent.device == device, parent.device
    steps = 3
    reset_launches()
    outs = [step(*args) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = {name: steps if name in ("support_stake", "leader_chain_scan") else 0
            for name in launches}
    assert launches == want, launches

    def plain():
        support = R.support_stake_plain(parent, exists, stake, anchor_slot - 2,
                                        leader_onehot[anchor_slot - 2])
        return (support, *R.leader_chain_scan_plain(
            parent, exists, leader_onehot, is_leader_slot, anchor_slot, anchor))

    p_support, p_committed, p_reach = plain()
    mism = 0
    for support, committed, reach in outs:
        mism += sum(diff(a, b)[0] for a, b in ((support, p_support),
                                                (committed, p_committed),
                                                (reach, p_reach)))
    support, committed, reach = outs[-1]
    values = (int(support), int(committed.sum()), int(reach.sum()))
    # The reference program's values on this fixture (seed 0, W = 64,
    # N = 50), which tests/test_torch_commit_step.py holds on the CPU.
    assert mism == 0, f"commit step != plain twins: {mism} mismatches"
    assert values == (28, 26, 2477), values
    result = dict(
        phase="commit_step", committee=exists.shape[1], window=exists.shape[0],
        anchor_slot=anchor_slot, steps=steps, mismatches=mism, tolerance=0,
        support=values[0], committed=values[1], reach_cells=values[2],
        launches=launches,
        launches_per_step={name: launches[name] / steps
                           for name in ("support_stake", "leader_chain_scan")},
        ms_per_step=cuda_ms(lambda: step(*args), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: step(*args), 100),
        plain_ms_per_step=cuda_ms(plain, 5),
    )
    emit(result)
    return result


def phase_main_path(keys, committee, signed, rng):
    from narwhal_tpu_torch.consensus import Tusk
    from narwhal_tpu_torch.crypto import backend as cb
    from narwhal_tpu_torch.ops import LAUNCHES

    cb.set_backend("cuda")  # strict: a broken build raises here
    assert cb.get_backend().name == "cuda"
    cb.get_backend().warmup(shapes=[VERIFY_BATCH])

    golden = Tusk(committee, GC_DEPTH)
    want = []
    for certs in signed:
        for cert in certs:
            want += golden.process_certificate(cert)
    n_signed = len(want)
    names = sorted(committee.authorities)
    unsigned = unsigned_rounds(
        names, SIGNED_ROUNDS + 1, [c.digest() for c in signed[-1]],
        UNSIGNED_ROUNDS, golden._leader_name, rng,
    )
    for certs in unsigned:
        for cert in certs:
            want += golden.process_certificate(cert)
    timings = {"verify_s": [], "prep_s": [], "claims": [],
               "commit_opportunity_s": [], "flush_s": [], "shift_s": []}
    t0 = time.perf_counter()
    committed, tusk = asyncio.run(drive_main_path(
        committee, signed, unsigned,
        {"signed": n_signed, "total": len(want)}, timings,
    ))
    wall = time.perf_counter() - t0
    check = timings["live_check"]
    # The path's own launches: the live check's are counted apart.
    launches = {name: n - check.launches.get(name, 0)
                for name, n in LAUNCHES.items()}
    got_digests = [bytes(c.digest()) for c in committed]
    want_digests = [bytes(c.digest()) for c in want]
    assert got_digests == want_digests, "kernel commit sequence != Python Tusk"
    assert tusk.python_fallbacks == 0, tusk.python_fallbacks
    assert all(launches[name] == 0 for name in check.KERNELS), launches
    assert all(n > 0 for name, n in launches.items()
               if name not in check.KERNELS), launches
    assert all(n > 0 for n in check.launches.values()), check.launches
    assert check.failures == [], check.failures[:10]
    assert check.counts["chain_checked"] == len(timings["commit_opportunity_s"]) > 0
    verify_s = timings["verify_s"]
    opp = timings["commit_opportunity_s"]
    result = dict(
        phase="main_path",
        committee=N_COMMITTEE, gc_depth=GC_DEPTH, window=tusk.max_window,
        signed_rounds=SIGNED_ROUNDS, unsigned_rounds=UNSIGNED_ROUNDS,
        verify_batches=len(verify_s),
        claims_per_batch=timings["claims"],
        ms_per_verify_batch=1000 * sum(verify_s) / len(verify_s),
        ms_per_verify_batch_each=[round(1000 * s, 3) for s in verify_s],
        verifies_per_s=sum(timings["claims"]) / sum(verify_s),
        ms_host_prep_per_batch=1000 * sum(timings["prep_s"]) / len(verify_s),
        commit_opportunities=len(opp),
        ms_per_commit_opportunity=1000 * sum(opp) / max(1, len(opp)),
        ms_flush_per_commit_opportunity=1000 * sum(timings["flush_s"]) / max(1, len(opp)),
        # A commit's whole window work on the host: the opportunity and the
        # shift that follows the commit (outside the opportunity's timer).
        commits_shifted=len(timings["shift_s"]),
        ms_shift_per_commit_opportunity=1000 * sum(timings["shift_s"]) / max(1, len(opp)),
        ms_per_commit=1000 * (sum(opp) + sum(timings["shift_s"])) / max(1, len(opp)),
        committed=len(committed), committed_after_signed=timings["after_signed"],
        last_committed_round=tusk.state.last_committed_round,
        python_fallbacks=tusk.python_fallbacks,
        sequence_equal=True,
        launches=launches,
        # Launches per main-path step: one verify per round burst, and per
        # commit opportunity those of the window's kernels (one update,
        # which also runs the last commit's shift, and one scan).
        launches_per_verify_batch=launches["ed25519_verify"] / len(verify_s),
        launches_per_commit_opportunity={
            name: n / max(1, len(opp)) for name, n in launches.items()
            if name != "ed25519_verify" and name not in check.KERNELS
        },
        # The live-window check, outside the timed figures: opportunities
        # checked, and the bool-window kernels' launches per opportunity.
        live_window=check.counts,
        live_check_launches=check.launches,
        live_check_launches_per_commit_opportunity={
            name: n / max(1, len(opp)) for name, n in check.launches.items()
        },
        wall_s=wall,
    )
    emit(result)
    return result


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "narwhal_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(narwhal_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from narwhal_tpu_torch import ops

    t0 = time.perf_counter()
    ops.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "build_dir": os.path.relpath(ops.BUILD_DIR, HERE)})

    smi = nvidia_smi_line()
    device = ops.resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    rng = random.Random(SEED)
    t0 = time.perf_counter()
    keys, committee = make_committee(N_COMMITTEE)
    signed = signed_rounds(keys, committee, SIGNED_ROUNDS, rng)
    emit({"phase": "setup", "signatures": sum(
        1 + len(c.votes) for certs in signed for c in certs),
        "seconds": time.perf_counter() - t0})

    records = phase_kernels(signed, keys, device, rng)
    emit({"phase": "kernels", "kernels": [
        {"name": name, "replaces": r["replaces"], "launches": r["check_launches"],
         "tolerance": 0, "mismatches": r["mismatches"], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "host_ms_per_call": r["host_ms_per_call"],
         "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
         "bound_ms": r["bound_ms"], **r.get("extra", {})}
        for name, r in records.items()
    ]})
    bad = {n: r["mismatches"] for n, r in records.items() if r["mismatches"]}
    bad.update({f"verify_sharded x{r['shards']}": r["mismatches"]
                for r in records["ed25519_verify"]["extra"]["routes"]
                if r["mismatches"]})
    if bad:
        print(f"chip_smoke: kernels disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1

    step = phase_commit_step(device)
    main = phase_main_path(keys, committee, signed, rng)

    # Each kernel's launches on the path that carries it: the flagship
    # commit step for its two kernels, the main path's live-window check
    # for the cone scan, the node's main path for the others.
    paths = {name: ("main_path", main["launches"]) for name in records}
    paths.update(support_stake=("commit_step", step["launches"]),
                 leader_chain_scan=("commit_step", step["launches"]),
                 causal_mask_scan=("main_path_live_check",
                                   main["live_check_launches"]))
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": paths[name][1][name],
         "path": paths[name][0],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         **({"routes": [
             {k: v for k, v in route.items() if k != "check_launches"}
             for route in r["extra"]["routes"]],
             **{k: r["extra"][k] for k in (
                 "ms_b16384", "registers_per_thread", "local_bytes_per_thread",
                 "launch_b2048")}}
            if name == "ed25519_verify" else {}),
         **({k: r["extra"][k] for k in ("launch_w64_n50", "cycles_w64_n50", "shapes",
                                        "registers_by_n")}
            if name in SCAN_KERNELS else {}),
         **({k: r["extra"][k] for k in ("forms", "shapes", "apply_no_ring_ms")}
            if name == "window_update" else {})}
        for name, r in records.items()
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
