#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``narwhal_tpu_torch``) on one GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (the window
scans also with rows of several words and in chunks of slots, the
verifier's staged launcher against its single launch (the batch split
over two shards, and its one-shard case at B = 2048 and 16,384, each
shard on its own stream from a pinned buffer), and the verifier, the
commit scan and the ring update at the ``committee`` phase's burst pads
and window), then drives three
paths in this process, each with the launch counts set to 0 just before
it and read just after, and then the node CLI in processes of its own:

- ``commit_step``: the flagship commit step
  (``narwhal_tpu_torch.commit_step.entry()``, W=64), one launch a step,
  whose support, committed chain and reach masks must equal the plain
  twins' and the reference program's values, then the same launch against
  its plain twin at other anchors and at N=65, 200 and 1024;
- ``main_path``: a primary's certificate path — every round's signature
  claims verified in one batch on the ``cuda`` crypto backend, then the
  certificates through ``Consensus(use_kernel=True)`` on the card, whose
  commit sequence must equal the Python Tusk's; at every commit
  opportunity the bool-window kernels are held against the Tusk on the
  live device window (:class:`LiveWindowCheck`), outside the timings,
  with its launches counted apart from the path's;
- ``committee``: 10 port primaries in this process on loopback TCP
  (:class:`PortNode`, booted by the port's ``spawn_primary_node``), each
  verifying its drained bursts on the ``cuda`` crypto backend and
  committing through ``Consensus(use_kernel=True)``, until every node
  has committed 50 leaders (120 s at most); every pair of nodes must
  agree on their common prefix, each node's sequence must be what the
  plain ``Tusk`` commits from the certificates in the order its
  Consensus took them, and no background task may die;
- ``node``: ten validators started through the port's node CLI as the
  reference's local bench starts them (``prewarm``, then a process per
  primary and per worker, then a benchmark client per worker at 1,000
  tx/s for 30 s; :func:`run_node_committee`), every primary on the card
  (``--crypto-backend cuda --experimental-consensus-kernel``); every
  process must exit 0, no log may hold an error, the reference's
  ``benchmark/logs.py`` must read committed samples from the logs, the
  primaries' commit sequences must agree and hold 20 leaders, each must
  be what the plain ``Tusk`` commits from the certificates of that
  primary's store, and every primary's snapshot must show each of the
  three kernels launched on the card outside the boot's warm-ups;
- ``faults``: the node phase's deployment under the fault suite's
  published plans (:func:`faults_scenario`): authority 2 signs its
  headers with a wrong key, authority 3 equivocates, and authority 6 is
  SIGKILLed at 12 s and restarted at 18 s over its store, every primary
  on the card; every honest authority's audit segments must replay
  cleanly through the port's golden oracle, their commits must form one
  prefix, the wrong-key headers must be rejected by the card's verifier
  and the equivocation detected, authority 6 must restore its consensus
  frontier on the card and commit again, and the ``invalid_signature``,
  ``equivocation`` and ``peer_unreachable`` rules must fire;
- ``multichip``: the committee-sharded commit step
  (``narwhal_tpu_torch.commit_step.dryrun_multichip``): four gloo rank
  processes sharing the card, each holding a block of the window's
  columns, at W=16/N=16, the flagship W=64/N=50 and W=8/N=1024, then an
  NCCL world of one rank a visible card; every rank's result must equal
  ``commit_step_fused`` on the whole window, and both block kernels must
  launch in every rank.

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
import re
import signal
import subprocess
import sys
import threading
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


def compute_mode() -> str:
    """The card's compute mode (``Default``, or ``Exclusive_Process`` under
    MPS), beside the figures of phases that share it among processes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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


class Mismatch:
    """Mismatching elements and the largest |a - b|, over pairs of
    tensors added with :meth:`add`."""

    def __init__(self) -> None:
        self.count, self.err = 0, 0.0

    def add(self, got, want) -> None:
        for a, b in zip(got, want):
            m, e = diff(a, b)
            self.count += m
            self.err = max(self.err, e)


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


def verify_route(E, arrays, devices, want) -> dict:
    """The staged launcher (``verify_sharded``) over ``devices`` on the
    nine prep arrays ``arrays``, against the single launch's mask
    ``want``: one launch a shard, each on a stream of its own that is not
    its card's default stream (read off the launch itself, through
    ``stream_handle``), a pinned staging buffer; then the whole call's
    time by events and on the host, each shard's copy in, kernel and
    copy out by the launcher's own events, averaged over the timed calls,
    and the host ms of the same launches alone."""
    import torch

    from narwhal_tpu_torch.ops import LAUNCHES

    launched = []
    stream_handle = E.stream_handle

    def seen(dev):
        handle = stream_handle(dev)
        launched.append((dev, handle))
        return handle

    report = []
    before = LAUNCHES["ed25519_verify"]
    E.stream_handle = seen
    try:
        got = E.verify_sharded(arrays, devices, report=report)
    finally:
        E.stream_handle = stream_handle
    launches = LAUNCHES["ed25519_verify"] - before
    assert launches == len(devices) == len(launched) == len(report), (
        launches, len(launched), len(report))
    defaults = {torch.cuda.default_stream(d).cuda_stream for d in devices}
    streams = [h for _, h in launched]
    assert len(set(streams)) == len(devices), streams
    assert not set(streams) & defaults, (streams, defaults)
    assert streams == [r["stream"] for r in report], (streams, report)
    assert all(r["pinned"] for r in report), report
    m1 = int((got != want).sum())
    timed = []

    def call():
        return E.verify_sharded(arrays, devices, report=timed)

    def mean(key, k):
        picked = [r[key] for r in timed[k :: len(devices)]]
        return sum(picked) / len(picked)

    rows = int(arrays[0].shape[0])
    step = rows // len(devices)
    streams = [torch.cuda.Stream(d) for d in devices]
    parts = [E.to_device([a[k * step : (k + 1) * step] for a in arrays], d)
             for k, d in enumerate(devices)]

    def launches_alone():
        # The floor under the call: the same launches on streams of their
        # own from tensors already on the card, no fill and no copies.
        for s, d, part in zip(streams, devices, parts):
            with torch.cuda.device(d), torch.cuda.stream(s):
                E.verify_kernel(*part)
        for s in streams:
            s.synchronize()

    return dict(
        launcher="verify_sharded",
        replaces=("narwhal_tpu/ops/ed25519.py:387" if len(devices) > 1
                  else "narwhal_tpu/ops/ed25519.py:442"),
        rows=rows, shards=len(devices), cards=len({d.index for d in devices}),
        mismatches=m1, max_abs_err=float(m1 > 0), check_launches=launches,
        pinned=True, own_streams=True,
        # Events on the default stream around the whole call: the
        # launcher waits for its shards before it returns, so this holds
        # the host fill, both copies, the launches and the wait.
        ms=cuda_ms(call, 10),
        host_ms_per_call=host_ms(call, 10),
        launches_alone_host_ms=host_ms(launches_alone, 10),
        shards_ms=[{key: mean(key, k) for key in ("copy_in_ms", "kernel_ms", "copy_out_ms")}
                   for k in range(len(devices))],
        staged_bytes_per_shard=E.stage_layout(step)[1],
    )


def stage_host_ms(E, rows) -> dict:
    """Host ms of filling a pinned staging buffer at the node's burst pads
    and at B = 2048: the host prep alone, and the prep then its copy into
    the buffer's views (what a verify does before its copy in), in turns
    (prep, prep and copy, prep and copy, prep); beside them the copy
    alone."""
    import numpy as np
    import torch

    out = {}
    for pad in (16, 32, 64, VERIFY_BATCH):
        cols = list(zip(*rows[:pad]))
        buf = torch.empty(E.stage_layout(pad)[1], dtype=torch.uint8, pin_memory=True)
        views = [v.numpy() for v in E.stage_views(buf, pad)]
        arrays = E.prepare_batch(*cols, pad)
        iters = 5 if pad >= VERIFY_BATCH else 100

        def prep():
            E.prepare_batch(*cols, pad)

        def prep_and_copy():
            for dst, src in zip(views, E.prepare_batch(*cols, pad)):
                np.copyto(dst, src)

        def copy_alone():
            for dst, src in zip(views, arrays):
                np.copyto(dst, src)

        times = {"prep": [], "prep_and_copy": []}
        for name in ("prep", "prep_and_copy", "prep_and_copy", "prep"):
            fn = prep if name == "prep" else prep_and_copy
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times[name].append(1000 * (time.perf_counter() - t0) / iters)
        t0 = time.perf_counter()
        for _ in range(iters):
            copy_alone()
        out[f"b{pad}"] = dict(prep_ms=times["prep"],
                              prep_then_copy_ms=times["prep_and_copy"],
                              copy_alone_ms=1000 * (time.perf_counter() - t0) / iters)
    return out


def phase_kernels(dag, keys, device, rng):
    """Each kernel against its plain version on the card, exactly; times
    at the main path's shapes.  Returns the per-kernel records."""
    import numpy as np
    import torch

    from narwhal_tpu_torch import commit_step as CS
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
            # The pads the committee's small bursts take, back to back.
            ms_b16=cuda_ms(lambda: E.verify_kernel(*[a[:16].contiguous() for a in args]), 20),
            ms_b32=cuda_ms(lambda: E.verify_kernel(*[a[:32].contiguous() for a in args]), 20),
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
    # Every slot, and beyond the window on both sides, where JAX's traced
    # index counts from the end once and then clamps.
    for leader_slot in range(-W - 3, W + 2):
        onehot = np.zeros(N, dtype=bool)
        onehot[int(nrng.integers(N))] = True
        a = (p_b, e_b, stake, leader_slot, dev(onehot))
        got, want = R.support_stake(*a), R.support_stake_plain(*a)
        m1, e1 = diff(got, want)
        stake_mism += m1
        stake_err = max(stake_err, e1)
    stake_launches = LAUNCHES["support_stake"] - before["support_stake"]
    stake_args = (p_b, e_b, stake, W - 4, dev(np.eye(N, dtype=bool)[0]))
    one = torch.zeros(1, dtype=torch.int32, device=device)
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
        bound_ms=1000 * support_bytes(N) / HBM_BYTES_PER_S,
        bound_by="bytes",
        extra=dict(leader_slots=f"{-W - 3}..{W + 1}",
                   launch_n50=support_launch(N),
                   launch_n1024=support_launch(1024),
                   # A launch's floor on this card: a one-element fill.
                   fill_one_ms=cuda_ms(lambda: one.fill_(1), 100, prefill=True)),
    )

    # -- the flagship commit step in one launch, on its own fixture (seed
    #    0, W = 64, N = 50), against its plain twin (the two plain twins)
    step, cargs = CS.entry(device)
    before = dict(LAUNCHES)
    got, want = R.commit_step_fused(*cargs), R.commit_step_plain(*cargs)
    commit_mism, commit_err = 0, 0.0
    for a, b in zip(got, want):
        m1, e1 = diff(a, b)
        commit_mism += m1
        commit_err = max(commit_err, e1)
    commit_launches = LAUNCHES["commit_step"] - before["commit_step"]
    c_parent, c_exists, c_leader, c_is_lead, c_stake, c_anchor, c_onehot = cargs
    row = c_leader[c_anchor - 2]
    records["commit_step"] = dict(
        replaces="__graft_entry__.py:61 (make_commit_step: support_stake, "
                 "narwhal_tpu/ops/reachability.py:267, and leader_chain_scan, :144)",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=commit_mism,
        max_abs_err=commit_err,
        check_launches=commit_launches,
        ms=cuda_ms(lambda: step(*cargs), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: step(*cargs), 100),
        plain_ms=cuda_ms(lambda: R.commit_step_plain(*cargs), 5),
        library_ms=None,
        bound_ms=1000 * (chain_scan_bytes(got[1], got[2], c_leader, N) + support_bytes(N)
                         - 2 * N) / HBM_BYTES_PER_S,
        bound_by="bytes",
        extra=dict(
            launch_w64_n50=scan_launch("commit_step", W, N),
            registers_by_n={n: scan_launch("commit_step", W, n)["registers_per_thread"]
                            for n in (1, 33, 65, 129, 257, 513)},
            # On the same fixture: the step as two launches back to back
            # (its form before this kernel), and the chain scan alone.
            ms_two_launches=cuda_ms(lambda: (
                R.support_stake(c_parent, c_exists, c_stake, c_anchor - 2, row),
                R.leader_chain_scan(c_parent, c_exists, c_leader, c_is_lead, c_anchor,
                                    c_onehot)), 100, prefill=True),
            ms_chain_scan_alone=cuda_ms(lambda: R.leader_chain_scan(
                c_parent, c_exists, c_leader, c_is_lead, c_anchor, c_onehot),
                100, prefill=True),
        ),
    )

    # -- the committee-sharded step's slot kernel, every rank's block at
    #    every slot of the multichip phase's cases
    records.update(block_records(device))

    # -- the staged launcher (row 8): the batch split (the reference's
    #    NARWHAL_VERIFY_MESH path) over two shards on this card, and over
    #    every card where there are several, against the single launch on
    #    the same B = 2048 rows; and its one-shard case, the single-card
    #    verify, at B = 2048 and 16,384
    records["ed25519_verify"]["extra"]["routes"] = [
        verify_route(E, prep, devices, mask)
        for devices in ([device, device], *(
            [[torch.device("cuda", k) for k in range(torch.cuda.device_count())]]
            if torch.cuda.device_count() > 1 else []))]
    tiled_np = [np.concatenate([a] * 8, axis=0) for a in prep]
    records["ed25519_verify"]["extra"]["routes"] += [
        verify_route(E, prep, [device], mask),
        verify_route(E, tiled_np, [device], got16.cpu().numpy())]
    records["ed25519_verify"]["extra"]["stage_host_ms"] = stage_host_ms(E, rows)

    # -- the committee phase's shapes: the verifier at every burst pad its
    #    nodes warm, the scan and the ring update at its window (N = 10)
    _, small = loopback_committee(COMMITTEE_N, COMMITTEE_BASE_PORT, 1)
    before = dict(LAUNCHES)
    pads = committee_pad_checks(rows, kind, mask, device, committee_pads(small))
    shapes = committee_window_checks(small, device)
    shapes["ed25519_verify"] = dict(
        pads=pads, mismatches=sum(p["mismatches"] for p in pads),
        max_abs_err=max(p["max_abs_err"] for p in pads),
        launches=LAUNCHES["ed25519_verify"] - before["ed25519_verify"])
    for name, shape in shapes.items():
        rec = records[name]
        rec["mismatches"] += shape["mismatches"]
        rec["max_abs_err"] = max(rec["max_abs_err"], shape["max_abs_err"])
        rec["check_launches"] += shape["launches"]
        rec.setdefault("extra", {})["committee_shape"] = shape
    return records


# The ring's launch is checked at the main path's shape and at the scans'
# larger ones; C staged rows per launch as KernelTusk pads them.
UPDATE_SHAPES = ((64, N_COMMITTEE), (64, 200), (8, 1024))
UPDATE_ROWS = 256


def random_flush(nrng, W: int, N: int, C: int, negative: bool = False):
    """C flush entries at random logical slots in [0, W] (W is padding,
    dropped); one parent cell is hit by two rows.  With ``negative``,
    slots from [-W-1, W] and authorities from [-N-1, N] (JAX counts
    [-W, 0) and [-N, 0) from the end and drops the rest)."""
    import numpy as np

    lo_w, lo_n, hi_n = (-W - 1, -N - 1, N + 1) if negative else (0, 0, N)
    ins_w = nrng.integers(lo_w, W + 1, C).astype(np.int32)
    ins_i = nrng.integers(lo_n, hi_n, C).astype(np.int32)
    row_w = nrng.integers(lo_w, W + 1, C).astype(np.int32)
    row_c = nrng.integers(lo_n, hi_n, C).astype(np.int32)
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
    acc = Mismatch()
    check = acc.add

    flush = [dev(a) for a in flush_np]
    ke, kp, pe, pp = (dev(a) for a in (exists_np, parent_np, exists_np, parent_np))
    R.window_apply(ke, kp, *flush)
    R.window_apply_plain(pe, pp, *flush)
    check((ke, kp), (pe, pp))
    apply_args = (dev(exists_np), dev(parent_np), *flush)
    apply_ms = cuda_ms(lambda: R.window_apply(*apply_args), 100, prefill=True)

    shapes, forms = [], {}
    for W, N in UPDATE_SHAPES:
        e2_np, p2_np, cases = ring_checks(nrng, dev, W, N, UPDATE_ROWS, check)
        # The three forms at origin W - 1, a shift by 2 where a clear runs.
        steady = [dev(a) for a in commit_flush(nrng, W, N, UPDATE_ROWS)]
        e2, p2 = dev(e2_np), dev(p2_np)
        o = W - 1
        form_args = dict(flush=(steady, 0, False), clear=(None, 2, True),
                         both=(steady, 2, True))
        shape = dict(window=W, committee=N, cases=cases)
        for name, (fl, retired, slot0) in form_args.items():
            def call(fl=fl, retired=retired, slot0=slot0):
                R.window_update(e2, p2, fl, window=W, origin=o, retired=retired,
                                clear_slot0=slot0)
            shape[f"ms_{name}"] = cuda_ms(call, 100, prefill=True)
            if W == 64 and N == N_COMMITTEE:
                forms[name] = update_form(e2, p2, fl, W, o, retired, slot0, call)
        shapes.append(shape)
    # Negative slots and authorities: the standalone apply, and the ring
    # with a clear pending at an origin whose view wraps, at every shape.
    negative_cases = sum(negative_ring_checks(nrng, dev, W, N, UPDATE_ROWS, check)
                         for W, N in UPDATE_SHAPES)
    main = forms["both"]
    return dict(
        replaces="narwhal_tpu/ops/reachability.py:187 (window_shift_op), :163 (window_apply)",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=acc.count, max_abs_err=acc.err,
        check_launches=LAUNCHES["window_update"] - before["window_update"],
        ms=main["ms"], host_ms_per_call=main["host_ms_per_call"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        bound_ms=main["bound_ms"], bound_by="bytes",
        extra=dict(forms=forms, shapes=shapes, apply_no_ring_ms=apply_ms,
                   negative_index_cases=negative_cases),
    )


def ring_checks(nrng, dev, W: int, N: int, rows: int, check):
    """``window_update`` against its plain twin on the mirrored ring at
    (W, N): origins whose views wrap, a retired run that wraps below slot
    0, flushes of ``rows`` entries and of more than two chunks of them
    that land in the retired slots, a clear with no flush and a flush
    with no clear.  ``check(got, want)`` takes each pair.  Returns the
    ring's two copies as numpy arrays and the number of cases."""
    import numpy as np

    from narwhal_tpu_torch.ops import reachability as R

    e_np, p_np = causal_window(nrng, W, N)
    p_np *= nrng.integers(1, 4, p_np.shape, dtype=np.int32)
    e2_np, p2_np = np.concatenate([e_np, e_np]), np.concatenate([p_np, p_np])
    rand = [dev(a) for a in random_flush(nrng, W, N, rows)]
    long = [dev(a) for a in random_flush(nrng, W, N, 2 * rows + 88)]
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
    return e2_np, p2_np, len(cases)


def negative_ring_checks(nrng, dev, W: int, N: int, rows: int, check) -> int:
    """Negative slots and authorities at (W, N): the standalone apply, and
    the ring with a clear pending at an origin whose view wraps.  Returns
    the number of cases."""
    import numpy as np

    from narwhal_tpu_torch.ops import reachability as R

    e_np, p_np = causal_window(nrng, W, N)
    neg = [dev(a) for a in random_flush(nrng, W, N, rows, negative=True)]
    ke, kp, pe, pp = (dev(a) for a in (e_np, p_np, e_np, p_np))
    R.window_apply(ke, kp, *neg)
    R.window_apply_plain(pe, pp, *neg)
    check((ke, kp), (pe, pp))
    e2_np, p2_np = np.concatenate([e_np, e_np]), np.concatenate([p_np, p_np])
    k2, q2 = dev(e2_np), dev(p2_np)
    R.window_update(k2, q2, neg, window=W, origin=W - 3, retired=2, clear_slot0=True)
    check((k2, q2), R.window_update_plain(dev(e2_np), dev(p2_np), neg, window=W,
                                          origin=W - 3, retired=2, clear_slot0=True))
    return 2


def committee_pads(committee) -> list:
    """The verifier's pads that a committee phase node warms: 16 doubled
    up to the pad of the largest burst (the port's
    ``node/node.py::derive_max_claims``)."""
    from narwhal_tpu_torch.node.node import derive_max_claims
    from narwhal_tpu_torch.ops import ed25519 as E

    top = E.pad_size(derive_max_claims(committee))
    pads = [16]
    while pads[-1] < top:
        pads.append(2 * pads[-1])
    return pads


def committee_pad_checks(rows, kind, verdict, device, pads) -> list:
    """The verifier against its plain version at the committee phase's
    burst pads.  At each pad, a burst three claims short of it (the rest
    of the pad zero rows) drawn from ``rows``: hostile rows (up to half),
    corrupted ones (up to a quarter), the rest honest, shuffled so that
    every kind falls in every lane of a group.  ``kind`` names each row's
    kind and ``verdict`` its answer at B = 2048, which was checked there.
    A pad's mismatches count the launch against the plain version over
    the whole pad and against ``verdict`` over the claims."""
    from narwhal_tpu_torch.ops import ed25519 as E

    by_kind = {k: [i for i, x in enumerate(kind) if x.startswith(k)]
               for k in ("hostile", "corrupted", "honest")}
    out = []
    for pad in pads:
        n = pad - 3
        h = min(len(by_kind["hostile"]), n // 2)
        c = min(len(by_kind["corrupted"]), n // 4)
        idx = (by_kind["hostile"][:h] + by_kind["corrupted"][:c]
               + by_kind["honest"][: n - h - c])
        random.Random(SEED + pad).shuffle(idx)
        args = E.to_device(E.prepare_batch(*zip(*(rows[i] for i in idx)), pad), device)
        got = E.verify_kernel(*args)
        mism, err = diff(got, E.verify_plain(*args))
        wrong = int((got[:n].cpu().numpy() != verdict[idx]).sum())
        out.append(dict(pad=pad, claims=n, hostile=h, corrupted=c,
                        accepted=int(got.sum()), mismatches=mism + wrong,
                        max_abs_err=max(err, float(wrong > 0))))
    return out


def committee_window_checks(committee, device) -> dict:
    """``leader_commit_scan`` and ``window_update`` against their plain
    twins at the committee phase's shape: the window W and the flush chunk
    of C rows that a ``KernelTusk`` of ``committee`` at the default
    gc_depth takes (at N = 10 a row is one 32-bit word), on a generator of
    their own.  The update runs the ring's cases, negative indices, and a
    steady opportunity's launch (two rounds of certificates and a shift by
    2) at an origin whose view wraps and at one that does not; the scan
    runs anchors near the top, in the middle and outside the window.
    Returns per kernel its shape, cases, launches and mismatches."""
    import numpy as np
    import torch

    from narwhal_tpu_torch.config import Parameters
    from narwhal_tpu_torch.ops import LAUNCHES, reachability as R

    tusk = R.KernelTusk(committee, Parameters().gc_depth, device=device)
    W, N, C = tusk.max_window, tusk._n, tusk._cap
    nrng = np.random.default_rng(SEED + N)

    def dev(a):  # a copy, also on the CPU
        return torch.tensor(np.ascontiguousarray(a), device=device)

    before = dict(LAUNCHES)
    update = Mismatch()
    _, _, cases = ring_checks(nrng, dev, W, N, C, update.add)
    cases += negative_ring_checks(nrng, dev, W, N, C, update.add)
    for origin in (W - 1, 5):
        e_np, p_np = causal_window(nrng, W, N)
        e2_np, p2_np = np.concatenate([e_np, e_np]), np.concatenate([p_np, p_np])
        steady = [dev(a) for a in commit_flush(nrng, W, N, C, certs=2 * N)]
        k2, q2 = dev(e2_np), dev(p2_np)
        R.window_update(k2, q2, steady, window=W, origin=origin, retired=2,
                        clear_slot0=True)
        update.add((k2, q2), R.window_update_plain(
            dev(e2_np), dev(p2_np), steady, window=W, origin=origin, retired=2,
            clear_slot0=True))
        cases += 1
    scan = Mismatch()
    scan_cases, committed = 0, 0
    for trial in range(4):
        e_np, p_np = causal_window(nrng, W, N)
        p_np *= nrng.integers(1, 4, p_np.shape, dtype=np.int32)
        leader, is_lead = leader_schedule(e_np)
        pc, ec, lo, isl = dev(p_np), dev(e_np), dev(leader), dev(is_lead)
        for slot in (W - 2 - 2 * trial, W // 2 + trial, W):
            onehot = np.zeros(N, dtype=bool)
            onehot[int(np.flatnonzero(e_np[min(slot, W - 1)])[0])] = True
            a = (pc, ec, lo, isl, slot, dev(onehot))
            got = R.leader_commit_scan(*a)
            scan.add((got,), (R.leader_commit_scan_plain(*a),))
            committed += int(got.sum())
            scan_cases += 1
    assert committed > 0, "the committee-shape scan check committed nothing"
    return dict(
        window_update=dict(
            window=W, committee=N, rows=C, cases=cases, mismatches=update.count,
            max_abs_err=update.err,
            launches=LAUNCHES["window_update"] - before["window_update"]),
        leader_commit_scan=dict(
            window=W, committee=N, cases=scan_cases, committed=committed,
            mismatches=scan.count, max_abs_err=scan.err,
            launches=LAUNCHES["leader_commit_scan"] - before["leader_commit_scan"]),
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
# nt_window_scan_attributes' launches: the three scans and the commit step.
SCAN_LAUNCHES = SCAN_KERNELS + ("commit_step",)
# Rows of 3 and 7 words of 32 bits, and a window whose slots fill a
# block's shared memory one at a time (csrc/window_bits.cuh's chunks).
SCAN_SHAPES = ((64, 65), (64, 200), (8, 1024))


def scan_launch(name: str, W: int, N: int) -> dict:
    """A scan's (or the commit step's) launch at (W, N)
    (``nt_window_scan_attributes``): registers, local and static shared
    bytes per thread, block size, dynamic shared bytes per block, slots per
    chunk and blocks (one cluster)."""
    from narwhal_tpu_torch.ops import kernel_fn

    out = (ctypes.c_int * 7)()
    rc = kernel_fn("nt_window_scan_attributes", ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int))(
        SCAN_LAUNCHES.index(name), W, N, out)
    assert rc == 0, f"nt_window_scan_attributes failed: cudaError {rc}"
    launch = dict(zip(("registers_per_thread", "local_bytes_per_thread",
                       "static_shared_bytes", "block", "dynamic_shared_bytes",
                       "slots_per_chunk", "blocks"), out))
    # The design keeps the frontier and the rows in registers.
    assert launch["local_bytes_per_thread"] == 0, (name, W, N, launch)
    return launch


def support_launch(N: int) -> dict:
    """The standalone support gate's launch at N
    (``nt_support_stake_attributes``): registers, local and static shared
    bytes per thread, block size and dynamic shared bytes."""
    from narwhal_tpu_torch.ops import kernel_fn

    out = (ctypes.c_int * 5)()
    rc = kernel_fn("nt_support_stake_attributes", ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int))(N, out)
    assert rc == 0, f"nt_support_stake_attributes failed: cudaError {rc}"
    launch = dict(zip(("registers_per_thread", "local_bytes_per_thread",
                       "static_shared_bytes", "block", "dynamic_shared_bytes"), out))
    assert launch["local_bytes_per_thread"] == 0, (N, launch)
    return launch


def support_bytes(n: int) -> int:
    """Bytes the support gate must move: one child slot's parent rows and
    exists row, the stake and the leader's one-hot read once; the int32 sum
    written once."""
    return n * n + n + 4 * n + n + 4


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


# The commit step's checks beyond the flagship anchor: anchors inside, at
# the edges of and outside the window on the flagship fixture, and the
# scans' larger shapes (rows of 3 and 7 words, and chunks of one slot).
COMMIT_ANCHORS = (0, 1, "W-1", "W", "W+2", -1)
COMMIT_SHAPES = ((64, 65), (64, 200), (8, 1024))


def commit_step_checks(nrng, dev, flagship) -> list:
    """``commit_step_fused`` against ``commit_step_plain`` on the card:
    the flagship fixture at COMMIT_ANCHORS, then at COMMIT_SHAPES random
    causal windows with random stakes, anchors near the top, in the middle
    and outside the window.  One record a case: its shape, anchor,
    mismatches and support; at each of COMMIT_SHAPES also the time of the
    launch, of the chain scan alone and of the gate alone."""
    import numpy as np

    from narwhal_tpu_torch.ops import reachability as R

    def anchor_at(a, W):
        return a if isinstance(a, int) else W + int(a[1:] or 0)

    cases = []
    W = flagship[1].shape[0]
    for a in COMMIT_ANCHORS:
        args = list(flagship)
        args[5] = anchor_at(a, W)
        cases.append((W, flagship[1].shape[1], args))
    for W, N in COMMIT_SHAPES:
        e_np, p_np = causal_window(nrng, W, N)
        leader, is_lead = leader_schedule(e_np)
        stake = nrng.integers(1, 100, N).astype(np.int32)
        for anchor in (W - 2, W // 2, W):
            onehot = np.zeros(N, dtype=bool)
            onehot[int(np.flatnonzero(e_np[min(anchor, W - 1)])[0])] = True
            cases.append((W, N, [dev(p_np > 0), dev(e_np > 0), dev(leader), dev(is_lead),
                                 dev(stake), anchor, dev(onehot)]))
    out = []
    for W, N, args in cases:
        got, want = R.commit_step_fused(*args), R.commit_step_plain(*args)
        out.append(dict(window=W, committee=N, anchor_slot=args[5],
                        mismatches=sum(diff(a, b)[0] for a, b in zip(got, want)),
                        support=int(got[0]), committed=int(got[1].sum())))
        if N != flagship[1].shape[1] and args[5] == W - 2:
            # The one launch beside the chain scan alone and the gate alone.
            p, e, lo, isl, stake, anchor, onehot = args
            out[-1].update(
                ms=cuda_ms(lambda: R.commit_step_fused(*args), 50, prefill=True),
                ms_chain_scan_alone=cuda_ms(
                    lambda: R.leader_chain_scan(p, e, lo, isl, anchor, onehot), 50,
                    prefill=True),
                ms_support_stake_alone=cuda_ms(
                    lambda: R.support_stake(p, e, stake, anchor - 2, lo[anchor - 2]), 50,
                    prefill=True))
    return out


def phase_commit_step(device):
    """The flagship commit step (``narwhal_tpu_torch.commit_step.entry``)
    at N = 50, W = 64: a few steps with the launch counts set to 0 just
    before and read just after (one ``commit_step`` launch a step), the
    outputs against the plain twins on the card and against the reference
    program's values; then the fused launch against its plain twin at
    other anchors and shapes."""
    import numpy as np
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
    want = {name: steps if name == "commit_step" else 0 for name in launches}
    assert launches == want, launches

    def plain():
        return R.commit_step_plain(*args)

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
    checks = commit_step_checks(
        np.random.default_rng(SEED + 2),
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device), args)
    check_mism = sum(c["mismatches"] for c in checks)
    assert check_mism == 0, [c for c in checks if c["mismatches"]]
    assert any(c["support"] for c in checks) and any(c["committed"] for c in checks)
    result = dict(
        phase="commit_step", committee=exists.shape[1], window=exists.shape[0],
        anchor_slot=anchor_slot, steps=steps, mismatches=mism, tolerance=0,
        support=values[0], committed=values[1], reach_cells=values[2],
        launches=launches,
        launches_per_step={name: launches[name] / steps
                           for name in ("commit_step", "support_stake",
                                        "leader_chain_scan")},
        ms_per_step=cuda_ms(lambda: step(*args), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: step(*args), 100),
        plain_ms_per_step=cuda_ms(plain, 5),
        checks=checks, check_mismatches=check_mism,
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
    # The node's path launches the verifier and the window's update and
    # scan; the flagship step's launch belongs to the commit_step phase,
    # the sharded step's slot kernel to the multichip phase.
    off_path = check.KERNELS + ("commit_step",) + MULTICHIP_KERNELS
    assert all(launches.get(name, 0) == 0 for name in off_path), launches
    assert all(n > 0 for name, n in launches.items() if name not in off_path), launches
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
            if name != "ed25519_verify" and name not in off_path
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


# ------------------------------------------------------------ the committee

# BASELINE.json configs[2] ("10-node committee, 1 worker, 100k tx/s, cert
# quorum-verify bound") without its worker and load: 10 primaries of stake
# 1 (f = 3, a quorum of 7) on loopback, the reference's default Parameters
# (header_size 1,000, max_header_delay 100 ms, gc_depth 50), so headers are
# empty and paced by the delay.
COMMITTEE_N = 10
COMMITTEE_LEADERS = 50
COMMITTEE_CAP_S = 120.0
# Below the host's ephemeral port range (see check_port_block): a port
# the kernel hands to an outgoing connection cannot be bound.
COMMITTEE_BASE_PORT = 8000


def check_port_block(base: int, count: int) -> dict:
    """Fail unless ports [base, base + count) lie outside the range the
    host gives outgoing connections (``ip_local_port_range``): a node's
    listener bound after its peers began dialling could find its port
    taken by one of their connections.  Returns the range."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        lo, hi = map(int, f.read().split())
    assert base + count <= lo or base > hi, (
        f"ports {base}-{base + count - 1} overlap the ephemeral range {lo}-{hi}")
    return {"ephemeral_ports": [lo, hi], "ports": [base, base + count - 1]}


def key_seed(salt: int, i: int) -> bytes:
    """The 32-byte seed of authority ``i``'s ed25519 key."""
    return SEED.to_bytes(8, "little") + bytes([salt, i]) * 12


def loopback_committee(n: int, base_port: int, salt: int):
    """``n`` seeded ed25519 keys and a committee of stake 1 each on
    loopback, five ports an authority (both primary listeners and the
    three worker addresses), from ``base_port`` up."""
    from narwhal_tpu_torch.config import (
        Authority, Committee, PrimaryAddresses, WorkerAddresses,
    )
    from narwhal_tpu_torch.crypto import KeyPair

    keys = [KeyPair.generate(key_seed(salt, i)) for i in range(n)]
    authorities = {}
    for i, kp in enumerate(keys):
        port = base_port + 5 * i
        addr = [f"127.0.0.1:{port + k}" for k in range(5)]
        authorities[kp.name] = Authority(
            stake=1,
            primary=PrimaryAddresses(primary_to_primary=addr[0], worker_to_primary=addr[1]),
            workers={0: WorkerAddresses(
                transactions=addr[2], worker_to_worker=addr[3], primary_to_worker=addr[4],
            )},
        )
    return keys, Committee(authorities)


class PortNode:
    """One port primary and its Consensus, booted by the port's
    ``narwhal_tpu_torch.node.spawn_primary_node`` (the verify backend
    warmed for every burst pad, the three channels, the Consensus built
    and its kernel window prewarmed, then ``Primary.spawn``) with
    ``use_kernel=True``.  ``received`` holds the certificates in the order
    the Consensus takes them (a tee on its ``rx_primary``), ``committed``
    what it committed, ``warm_launches`` the launches of the boot's
    warm-ups."""

    def __init__(self) -> None:
        self.node = None
        self.consensus = None
        self.received = []
        self.committed = []
        self.leaders = 0
        self.warm_launches = {}

    @classmethod
    async def boot(cls, keypair, committee, parameters, device=None):
        from narwhal_tpu_torch.consensus import Consensus
        from narwhal_tpu_torch.node import spawn_primary_node
        from narwhal_tpu_torch.ops import LAUNCHES

        self = cls()
        before = dict(LAUNCHES)

        class TeeConsensus(Consensus):
            def __init__(consensus, *args, **kwargs):
                super().__init__(*args, **kwargs)
                put, prewarm = consensus.rx_primary._put, consensus.tusk.prewarm

                def tee(item):
                    self.received.append(item)
                    put(item)

                def warmed():
                    # The backend's warm-up ran before this Consensus, the
                    # window's runs here; both are no traffic of the
                    # committee.
                    prewarm()
                    self.warm_launches = {
                        k: v - before[k] for k, v in LAUNCHES.items()}

                consensus.rx_primary._put = tee
                consensus.tusk.prewarm = warmed

        self.node = await spawn_primary_node(
            keypair, committee, parameters, on_commit=self._commit,
            use_kernel=True, device=device, consensus_cls=TeeConsensus)
        self.consensus = self.node.consensus
        return self

    def _commit(self, cert) -> None:
        self.committed.append(cert)
        tusk = self.consensus.tusk
        if cert.round % 2 == 0 and cert.origin == tusk._leader_name(cert.round):
            self.leaders += 1

    async def shutdown(self) -> None:
        await self.node.shutdown()


class TaskDeaths:
    """Counts the background tasks that ``utils/tasks.spawn`` reports as
    dead of an unhandled exception (its ``narwhal.tasks`` log record)."""

    def __init__(self) -> None:
        import logging

        self.records = []

        class Handler(logging.Handler):
            def emit(handler, record):
                if "died of an unhandled exception" in record.getMessage():
                    exc = record.exc_info[1] if record.exc_info else None
                    self.records.append(f"{record.getMessage()}: {exc!r}")

        self._handler = Handler(logging.ERROR)
        self._logger = logging.getLogger("narwhal.tasks")

    def __enter__(self):
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        return False


async def run_committee(keys, committee, parameters, leaders: int, cap_s: float,
                        device=None, on_boot=None):
    """Boot one :class:`PortNode` a key, run until every node has committed
    ``leaders`` leaders, then shut all down.  Returns (nodes, seconds from
    the last boot to the goal, the highest round any Consensus had taken
    at the last boot); raises TimeoutError past ``cap_s``.  ``on_boot(node)``
    runs right after each boot."""
    nodes = []
    try:
        for kp in keys:
            node = await PortNode.boot(kp, committee, parameters, device=device)
            nodes.append(node)
            if on_boot is not None:
                on_boot(node)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        start_round = max((c.round for n in nodes for c in n.received), default=0)
        while min(n.leaders for n in nodes) < leaders:
            if loop.time() - t0 > cap_s:
                raise TimeoutError(
                    f"leaders committed per node after {cap_s} s: "
                    f"{[n.leaders for n in nodes]}")
            await asyncio.sleep(0.02)
        return nodes, loop.time() - t0, start_round
    finally:
        for node in nodes:
            await node.shutdown()


def committee_checks(nodes, committee, gc_depth) -> dict:
    """Every pair of nodes commits the same digests on their common
    prefix, and each node's sequence is a prefix of what the port's plain
    ``Tusk`` (on the CPU) commits given the certificates in the order that
    node's Consensus took them."""
    from narwhal_tpu_torch.consensus import Tusk

    seqs = [[bytes(c.digest()) for c in n.committed] for n in nodes]
    for i in range(len(seqs)):
        for j in range(i + 1, len(seqs)):
            k = min(len(seqs[i]), len(seqs[j]))
            assert seqs[i][:k] == seqs[j][:k], f"nodes {i} and {j} disagree"
    replayed = []
    for node, seq in zip(nodes, seqs):
        tusk = Tusk(committee, gc_depth)
        want = [bytes(c.digest()) for cert in node.received
                for c in tusk.process_certificate(cert)]
        assert seq and want[:len(seq)] == seq, "a node's sequence != plain Tusk"
        replayed.append(len(want))
    return {"prefix_agrees": True, "replay_equal": True,
            "committed": [len(s) for s in seqs], "replayed": replayed}


def phase_committee():
    """N port primaries on loopback: each verifies its bursts on the card
    (the ``cuda`` crypto backend) and commits through ``KernelTusk``."""
    import torch

    from narwhal_tpu_torch import metrics
    from narwhal_tpu_torch.config import Parameters
    from narwhal_tpu_torch.crypto import backend as cb
    from narwhal_tpu_torch.ops import LAUNCHES, reset_launches
    from narwhal_tpu_torch.ops import ed25519 as E

    cb.set_backend("cuda")  # strict: a broken build raises here
    backend = cb.get_backend()
    assert type(backend).__name__ == "CudaBackend", type(backend)
    assert backend.device.type == "cuda", backend.device
    ports = check_port_block(COMMITTEE_BASE_PORT, 5 * COMMITTEE_N)
    keys, committee = loopback_committee(COMMITTEE_N, COMMITTEE_BASE_PORT, 1)
    parameters = Parameters()
    prep_s, kernel_ms, call_cpu_s, opportunity_s = [], [], [], []
    prepare_batch, verify_kernel = E.prepare_batch, E.verify_kernel
    verify_batch_arrays = E.verify_batch_arrays

    def on_dispatch_thread() -> bool:
        # A burst's verify runs on the backend's dispatch thread; the
        # boots' warm-ups run on this one.
        return threading.current_thread().name.startswith("cuda-verify")

    def timed_prep(*args):
        t0 = time.perf_counter()
        out = prepare_batch(*args)
        if on_dispatch_thread():
            prep_s.append(time.perf_counter() - t0)
        return out

    def timed_call(*args):
        # The CPU time the backend's call ran on its thread; the rest of
        # its wall time (ms_backend_per_burst) is waiting: for the GIL,
        # which the event loop's thread holds while it runs the
        # primaries, or for the card.
        if not on_dispatch_thread():
            return verify_batch_arrays(*args)
        c0 = time.thread_time()
        out = verify_batch_arrays(*args)
        call_cpu_s.append(time.thread_time() - c0)
        return out

    def timed_kernel(*arrays):
        if not on_dispatch_thread():
            return verify_kernel(*arrays)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = verify_kernel(*arrays)
        stop.record()
        stop.synchronize()  # the mask's copy back waits for it anyway
        kernel_ms.append(start.elapsed_time(stop))
        return out

    def on_boot(node):
        tusk = node.consensus.tusk
        order_leaders = tusk.order_leaders

        def timed_order_leaders(leader):
            t0 = time.perf_counter()
            out = order_leaders(leader)  # flush + scan + the W-bool fetch
            opportunity_s.append(time.perf_counter() - t0)
            return out

        tusk.order_leaders = timed_order_leaders

    async def go():
        return await run_committee(keys, committee, parameters, COMMITTEE_LEADERS,
                                   COMMITTEE_CAP_S, on_boot=on_boot)

    metrics.registry().reset()
    reset_launches()  # the committee's launches start here
    E.prepare_batch, E.verify_kernel = timed_prep, timed_kernel
    E.verify_batch_arrays = timed_call
    t0 = time.perf_counter()
    try:
        with TaskDeaths() as deaths:
            nodes, goal_s, start_round = asyncio.run(go())
        torch.cuda.synchronize()
    finally:
        E.prepare_batch, E.verify_kernel = prepare_batch, verify_kernel
        E.verify_batch_arrays = verify_batch_arrays
        cb.set_backend("cpu")
    wall = time.perf_counter() - t0
    # The path's launches: the boots' warm-ups are counted apart.
    warm = {k: sum(n.warm_launches.get(k, 0) for n in nodes) for k in LAUNCHES}
    launches = {k: v - warm[k] for k, v in LAUNCHES.items()}
    assert deaths.records == [], deaths.records
    for name in ("ed25519_verify", "window_update", "leader_commit_scan"):
        assert launches[name] > 0, launches
    checks = committee_checks(nodes, committee, parameters.gc_depth)
    reg = metrics.registry()
    device_s = reg.histograms["crypto.verify.device_seconds.batch_burst"]
    wall_s = reg.histograms["crypto.verify.seconds.batch_burst"]
    claims = reg.counters["crypto.verify.ops.batch_burst"].value
    rounds = max(c.round for n in nodes for c in n.received)
    bursts = device_s.count
    # The per-burst splits below come from the prep, call and kernel that
    # the backend's dispatch thread ran: each must have seen every burst.
    # Core keeps one burst in flight and the thread runs one at a time, so
    # a node's shutdown can cut off the await of one burst whose call ran.
    for name, seen in (("host prep", prep_s), ("kernel", kernel_ms),
                       ("backend call", call_cpu_s)):
        assert 0 < bursts <= len(seen) <= bursts + COMMITTEE_N, (name, len(seen), bursts)
    result = dict(
        phase="committee",
        committee=COMMITTEE_N, quorum=committee.quorum_threshold(),
        header_size=parameters.header_size,
        max_header_delay_ms=parameters.max_header_delay,
        gc_depth=parameters.gc_depth,
        backend=f"{type(backend).__name__}:{backend.device}",
        rounds_reached=rounds,
        min_leaders_committed=min(n.leaders for n in nodes),
        leaders_committed=[n.leaders for n in nodes],
        last_committed_round=[n.consensus.tusk.state.last_committed_round for n in nodes],
        wall_s=wall, goal_s=goal_s,
        rounds_after_boot=rounds - start_round,
        ms_per_round=1000 * goal_s / max(1, rounds - start_round),
        verify_bursts=bursts, claims=claims,
        claims_per_burst=claims / max(1, bursts),
        ms_backend_per_burst=1000 * device_s.sum / max(1, bursts),
        ms_host_prep_per_burst=1000 * sum(prep_s) / max(1, len(prep_s)),
        host_prep_calls=len(prep_s),
        # Device time of the verify launch alone (CUDA events around it).
        ms_kernel_per_burst=sum(kernel_ms) / max(1, len(kernel_ms)),
        ms_thread_cpu_per_burst=1000 * sum(call_cpu_s) / max(1, len(call_cpu_s)),
        # Across the await: the burst's wait for the one dispatch thread
        # that all N Cores share, and the event loop's wake-up.
        ms_wall_per_burst=1000 * wall_s.sum / max(1, wall_s.count),
        dispatch_thread_busy_share=device_s.sum / goal_s,
        launches=launches, warmup_launches=warm,
        launches_per_burst=launches["ed25519_verify"] / max(1, bursts),
        commit_opportunities=len(opportunity_s),
        ms_per_commit_opportunity=1000 * sum(opportunity_s) / max(1, len(opportunity_s)),
        launches_per_commit_opportunity={
            name: launches[name] / max(1, len(opportunity_s))
            for name in ("window_update", "leader_commit_scan")},
        task_deaths=len(deaths.records), **ports,
        **checks,
    )
    emit(result)
    return result


# ------------------------------------------------------------ the node CLI

# BASELINE.json configs[2] ("10-node committee, 1 worker, 100k tx/s, cert
# quorum-verify bound") as the reference's local bench starts it
# (benchmark/local_bench.py::run_bench), through the port's node CLI: one
# process per primary, per worker and per client, the reference's default
# Parameters, --benchmark on every node.  The load is BASELINE's 100k tx/s
# cut tenfold, because 31 Python processes share the host's cores.
NODE_N = 10
NODE_BASE_PORT = 9000
NODE_SALT = 2
NODE_RATE = 1_000  # tx/s a client
NODE_TX_SIZE = 512
NODE_LOAD_S = 30.0
NODE_CAP_S = 150.0  # from the first node's start to the last exit
NODE_MIN_LEADERS = 20
NODE_WORKDIR = os.path.join(HERE, "build", "node_phase")
NODE_KERNELS = ("ed25519_verify", "window_update", "leader_commit_scan")
# The profiler's label of the frame that enqueues a verify's staged copy
# in, launch and copy out (ops/ed25519.py::stage_shard).
COPY_FRAME = "ed25519.py:stage_shard"
# The boot lines each process logs once it is ready (the reference's own:
# node/node.py and primary.py / worker.py).
BOOTED = "successfully booted"
CARD_PRIMARY_BOOT = ("Verify backend cuda ready", "Consensus kernel ready", BOOTED)


def node_files(workdir: str, n: int, base_port: int, salt: int):
    """Seeded keys, a loopback committee and the default Parameters, as
    the files ``node run`` reads; returns (keys, committee)."""
    from narwhal_tpu_torch.config import Parameters, export_keypair

    os.makedirs(workdir, exist_ok=True)
    keys, committee = loopback_committee(n, base_port, salt)
    committee.export(os.path.join(workdir, "committee.json"))
    Parameters().export(os.path.join(workdir, "parameters.json"))
    for i, kp in enumerate(keys):
        export_keypair(kp, os.path.join(workdir, f"node-{i}.json"))
    return keys, committee


def node_command(workdir: str, i: int, role, *flags) -> list:
    """``python -m narwhal_tpu_torch.node run`` for authority ``i``'s
    primary (``role`` "primary") or worker (``("worker", "--id", "0")``)."""
    role = (role,) if isinstance(role, str) else tuple(role)
    store = f"db-{role[0]}-{i}" + (f"-{role[-1]}" if role[0] == "worker" else "")
    return [sys.executable, "-m", "narwhal_tpu_torch.node", "run",
            "--keys", os.path.join(workdir, f"node-{i}.json"),
            "--committee", os.path.join(workdir, "committee.json"),
            "--parameters", os.path.join(workdir, "parameters.json"),
            "--store", os.path.join(workdir, store),
            *flags, *role]


def client_command(address: str, rate: int, index: int) -> list:
    """One benchmark client against a worker's transaction socket, its
    sample ids in a space of its own (as local_bench's)."""
    return [sys.executable, "-m", "narwhal_tpu_torch.node.benchmark_client",
            address, "--size", str(NODE_TX_SIZE), "--rate", str(rate),
            "--sample-offset", str(index << 32), "--nodes", address]


class NodeProcesses:
    """The children of one committee run, each logging to its own file in
    ``workdir``.  Leaving the block stops every child still running."""

    def __init__(self, workdir: str) -> None:
        self.workdir = workdir
        self.procs = {}
        self.envs = {}  # {name: the child's environment}
        self.env = dict(os.environ, PYTHONPATH=HERE)

    def start(self, name: str, argv, env=None):
        self.envs[name] = dict(self.env, **(env or {}))
        with open(self.log_path(name), "w") as f:
            self.procs[name] = subprocess.Popen(
                argv, stdout=f, stderr=subprocess.STDOUT, cwd=HERE,
                env=self.envs[name])
        return self.procs[name]

    def log_path(self, name: str) -> str:
        return os.path.join(self.workdir, f"{name}.log")

    def log(self, name: str) -> str:
        with open(self.log_path(name), errors="replace") as f:
            return f.read()

    def wait_for(self, texts: dict, deadline_s: float) -> dict:
        """Wait until each named log holds all of its texts; returns
        {name: the texts still missing} for a process that exited first
        or when the deadline passed, and {} when all are there."""
        end = time.monotonic() + deadline_s
        missing = dict(texts)
        while missing and time.monotonic() < end:
            for name in list(missing):
                log = self.log(name)
                missing[name] = [t for t in missing[name] if t not in log]
                if not missing[name]:
                    del missing[name]
                elif self.procs[name].poll() is not None:
                    return missing
            if missing:
                time.sleep(0.2)
        return missing

    def stop(self, timeout_s: float = 75.0) -> dict:
        """Stop every child and wait for it; returns {name: exit code}.
        The clients go first, on SIGINT (the benchmark client's clean
        stop); then the nodes on SIGTERM (the node's).  A child that
        outlives ``timeout_s`` after its signal (the reference's local
        bench grace) is killed and reported as None, which fails the
        run: a primary too, although it may hold the card, so that no
        process outlives the script (a CUDA context dies with its
        process)."""
        codes = {}
        for clients in (True, False):
            group = [n for n in self.procs if n.startswith("client") == clients]
            for name in group:
                if self.procs[name].poll() is None:
                    self.procs[name].send_signal(
                        signal.SIGINT if clients else signal.SIGTERM)
            end = time.monotonic() + timeout_s
            for name in group:
                try:
                    codes[name] = self.procs[name].wait(
                        timeout=max(0.1, end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self.procs[name].kill()
                    self.procs[name].wait()
                    codes[name] = None
        return codes

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


_COMMITTED = re.compile(r"Committed B(\d+)\((\S+?)\)")


def commit_sequence(log: str) -> list:
    """A primary's committed headers in order, as (round, header) from its
    ``Committed B{round}({header})`` lines (one line per payload digest,
    so consecutive repeats are one header)."""
    seq = []
    for m in _COMMITTED.finditer(log):
        item = (int(m.group(1)), m.group(2))
        if not seq or seq[-1] != item:
            seq.append(item)
    return seq


def stored_certificates(store_path: str, committee) -> list:
    """The certificates in a primary's store by round, read as the node's
    own recovery reads them (``node.py``): a value that parses as a
    certificate and carries votes."""
    from narwhal_tpu_torch import messages
    from narwhal_tpu_torch.primary.messages import Certificate
    from narwhal_tpu_torch.store import Store

    messages.set_wire_committee(committee)
    certs = []
    store = Store(store_path)
    try:
        for value in store.values():
            if len(value) < 140:  # smaller than any certificate
                continue
            try:
                cert = Certificate.deserialize(value)
            except Exception:
                continue  # a header or a payload marker
            if cert.votes or cert.agg is not None:
                certs.append(cert)
    finally:
        store.close()
    certs.sort(key=lambda c: (c.round, bytes(c.origin)))
    return certs


def committed_leaders(seq, origins, committee) -> int:
    """The leaders in a commit sequence: an even round's header by that
    round's round-robin leader (Tusk's ``_leader_name``)."""
    names = sorted(committee.authorities)
    return sum(1 for r, header in seq
               if r % 2 == 0 and origins.get(header) == names[r % len(names)])


def _log_time(line: str) -> float:
    from datetime import datetime, timezone

    stamp = line.split(" ", 1)[0].rstrip("Z")
    return datetime.strptime(stamp, "%Y-%m-%dT%H:%M:%S.%f").replace(
        tzinfo=timezone.utc).timestamp()


def split_client_logs(client_logs, at: float):
    """Each client log twice: with the sample lines sent before ``at``
    only, and with those sent from ``at`` on only (every other line kept),
    so ``parse_logs`` gives the end-to-end latency of each half."""
    halves = ([], [])
    for text in client_logs:
        keep = ([], [])
        for line in text.splitlines():
            if "Sending sample transaction" in line:
                keep[_log_time(line) >= at].append(line)
            else:
                keep[0].append(line)
                keep[1].append(line)
        for half, lines in zip(halves, keep):
            half.append("\n".join(lines) + "\n")
    return halves


# fault_bench.py's _RESTART_SETTLE_S: boot, store replay and catch-up a
# restarted node is allowed before it must commit clients' payload again.
RESTART_SETTLE_S = 10.0
BOOT_DEADLINE_S = 90.0


def _log_local_time(line: str) -> float:
    """A node log line's time: ``%(asctime)s`` is local time (the trailing
    Z is cosmetic), as fault_bench.py reads it."""
    from datetime import datetime

    return datetime.strptime(line.split(" ", 1)[0].rstrip("Z"),
                             "%Y-%m-%dT%H:%M:%S.%f").timestamp()


def payload_commits_after(log: str, at: float, above: int = 0) -> int:
    """A primary's clients'-payload commit lines (``Committed B… -> …``,
    logged with ``--benchmark``) stamped at or after ``at``, of rounds
    past ``above``."""
    n = 0
    for line in log.splitlines():
        m = _COMMITTED.search(line)
        if m and " -> " in line and int(m.group(1)) > above:
            try:
                n += _log_local_time(line) >= at
            except ValueError:
                continue
    return n


def primary_store_log(workdir: str, i: int) -> str:
    """The log file of primary ``i``'s store, as ``node run --store`` lays
    it out."""
    return os.path.join(workdir, f"db-primary-{i}/store.log")


def store_head(store_path: str, committee) -> int:
    """The highest round of a certificate in a primary's store (0: none)."""
    return max((c.round for c in stored_certificates(store_path, committee)),
               default=0)


def write_plans(workdir: str, scenario, keys) -> dict:
    """A ``--fault-plan`` file for each Byzantine authority of a parsed
    ``FaultScenario``, as fault_bench.py writes them; returns {authority:
    path}."""
    plans = {}
    for b in scenario.byzantine:
        plan = {"behaviors": b.behaviors, "seed": scenario.seed ^ (b.node + 1),
                "replay_interval_ms": b.replay_interval_ms,
                "flood_interval_ms": b.flood_interval_ms,
                "garbage_bytes": b.garbage_bytes}
        if b.targets:
            plan["withhold_targets"] = [keys[t].name.encode_base64() for t in b.targets]
        plans[b.node] = os.path.join(workdir, f"byzantine-{b.node}.json")
        with open(plans[b.node], "w") as f:
            json.dump(plan, f, indent=1)
    return plans


def run_node_committee(workdir: str, n: int, base_port: int, rate: int,
                       load_s: float, primary_flags=(), primary_boot=(BOOTED,),
                       prewarm=None, scenario=None) -> dict:
    """Start a committee as ``benchmark/local_bench.py::run_bench`` does,
    with ``narwhal_tpu_torch.node`` in place of ``narwhal_tpu.node``: the
    ``prewarm`` command first (argv, run to its end), then a primary and
    a worker process an authority, and once every node has logged its
    boot lines a benchmark client a worker at ``rate`` tx/s for ``load_s``
    seconds; then stop all.

    With ``scenario`` (a ``FaultScenario`` object for these ``n``,
    ``rate`` × ``n`` and ``load_s``), run it as
    ``benchmark/fault_bench.py::run_scenario`` does: a plan file per
    Byzantine authority, passed to its primary and its worker; an audit
    segment per primary life (``NARWHAL_CONSENSUS_AUDIT``); the
    scenario's env and ``NARWHAL_FAULT_SEED`` in every child.  Its clock
    starts when the clients do (fault_bench starts it before the boot,
    which on the card takes longer than its first fault's offset): each
    crash SIGKILLs the authority's primary and worker and reads the head
    of its store, and its restart starts the same commands again.  After
    the load, the clients keep sending until every surviving honest
    primary has committed clients' payload after the last restart plus
    :data:`RESTART_SETTLE_S`, a restarted one of rounds past its store's
    head at the crash (the scenario's ``progress_wait`` at most).

    Returns what the checks read: exit codes, logs and commit sequences
    by process, each authority's primary lives, the stores' certificates
    and the header authors, the snapshots."""
    import shutil

    from narwhal_tpu_torch.config import Parameters

    shutil.rmtree(workdir, ignore_errors=True)
    keys, committee = node_files(workdir, n, base_port, NODE_SALT)
    plans, base_env = {}, {}
    if scenario is not None:
        from narwhal_tpu_torch.faults.spec import parse_scenario

        with open(os.path.join(workdir, "scenario.json"), "w") as f:
            json.dump(scenario, f, indent=1)
        parsed = parse_scenario(scenario, env={})
        plans = write_plans(workdir, parsed, keys)
        base_env = {"NARWHAL_FAULT_SEED": str(parsed.seed),
                    "NARWHAL_FLIGHT_DIR": os.path.join(workdir, "flight"),
                    **parsed.env}
    out = {"committee": committee, "scenario": scenario, "processes": 0,
           "byzantine": sorted(plans), "lives": {}, "segments": {},
           "metrics_paths": {}, "crash_heads": {},
           "gc_depth": Parameters().gc_depth}
    t0 = time.monotonic()
    if prewarm is not None:
        with open(os.path.join(workdir, "prewarm.log"), "w") as f:
            rc = subprocess.run(prewarm, stdout=f, stderr=subprocess.STDOUT,
                                cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                                timeout=600).returncode
        out["prewarm_s"], out["processes"] = time.monotonic() - t0, 1
        assert rc == 0, f"prewarm exited {rc}"

    def start(procs, i):
        """Authority ``i``'s primary and worker, a new life."""
        life = len(out["lives"].setdefault(i, []))
        suffix = "" if life == 0 else f".r{life}"
        primary, worker = f"primary-{i}{suffix}", f"worker-{i}{suffix}"
        out["lives"][i].append(primary)
        plan = ("--fault-plan", plans[i]) if i in plans else ()
        snapshot = os.path.join(workdir, "metrics-{}-%d%s.json" % (i, suffix)).format
        out["metrics_paths"][primary] = snapshot("primary")
        env = dict(base_env)
        if scenario is not None:
            audit = os.path.join(workdir, f"audit-primary-{i}.seg{life}.bin")
            out["segments"].setdefault(i, []).append(audit)
            env.update(NARWHAL_FAULT_NODE=f"primary-{i}", NARWHAL_CONSENSUS_AUDIT=audit)
        procs.start(primary, node_command(
            workdir, i, "primary", "--benchmark", *primary_flags, *plan,
            "--metrics-path", snapshot("primary")), env=env)
        procs.start(worker, node_command(
            workdir, i, ("worker", "--id", "0"), "--benchmark", *plan,
            "--metrics-path", snapshot("worker")),
            env=dict(base_env, **({"NARWHAL_FAULT_NODE": f"worker-{i}-0"}
                                  if scenario is not None else {})))

    crashes = [] if scenario is None else parsed.crash
    events = sorted([(c.at_s, "crash", c.node) for c in crashes]
                    + [(c.restart_at_s, "restart", c.node)
                       for c in crashes if c.restart_at_s is not None])
    honest = [i for i in range(n) if i not in plans]
    with NodeProcesses(workdir) as procs:
        t_start = time.monotonic()
        for i in range(n):
            start(procs, i)
        missing = procs.wait_for(
            {**{f"primary-{i}": list(primary_boot) for i in range(n)},
             **{f"worker-{i}": [BOOTED] for i in range(n)}}, BOOT_DEADLINE_S)
        assert not missing, f"nodes not booted: {missing}"
        out["boot_s"] = time.monotonic() - t_start
        for i in range(n):
            address = committee.worker(keys[i].name, 0).transactions
            procs.start(f"client-{i}", client_command(address, rate, i), env=base_env)
        t_load = time.time()
        out["events"] = []
        for at_s, kind, i in events:
            time.sleep(max(0.0, t_load + at_s - time.time()))
            if kind == "crash":
                primary = out["lives"][i][-1]
                for name in (primary, primary.replace("primary", "worker", 1)):
                    procs.procs[name].kill()  # SIGKILL: the torn tail is the point
                    procs.procs[name].wait()
                # The head of the store the next life restores from, read
                # from a copy: opening a store cuts its torn tail.
                copy = os.path.join(workdir, f"crash-{primary}.store.log")
                shutil.copyfile(primary_store_log(workdir, i), copy)
                out["crash_heads"][i] = store_head(copy, committee)
            else:
                start(procs, i)
            out["events"].append((kind, i, time.time() - t_load))
        time.sleep(max(0.0, t_load + load_s - time.time()))
        if scenario is not None:
            settle = max([c.restart_at_s + RESTART_SETTLE_S for c in crashes
                          if c.restart_at_s is not None], default=0.0)
            out["settle_ts"] = t_load + settle
            end = time.time() + parsed.progress_wait
            while True:
                late = {i: payload_commits_after(
                            procs.log(out["lives"][i][-1]), out["settle_ts"],
                            above=out["crash_heads"].get(i, 0)) for i in honest}
                if all(late.values()) or time.time() >= end:
                    break
                time.sleep(1.0)
            out["payload_commits_after_settle"] = late
        out["load_s"] = time.time() - t_load
        codes = procs.stop()
        out["wall_s"] = time.monotonic() - t_start
        out["processes"] += len(procs.procs)
    out["children_env"] = procs.envs
    out["codes"] = codes
    out["logs"] = {name: procs.log(name) for name in codes}
    out["load_window"] = (t_load, t_load + out["load_s"])
    out["sequences"] = {name: commit_sequence(out["logs"][name])
                        for lives in out["lives"].values() for name in lives}
    # Each restart's (store head at its crash, highest round its life
    # committed): past the head, it took certificates from the committee.
    out["rejoined_rounds"] = {
        i: (head, max((r for r, _ in out["sequences"][out["lives"][i][-1]]), default=0))
        for i, head in out["crash_heads"].items() if len(out["lives"][i]) > 1}
    # Seconds from each restart to its primary's boot line (None: never).
    out["restart_boot_s"] = {}
    for kind, i, at in out["events"]:
        if kind == "restart":
            booted = [line for line in out["logs"][out["lives"][i][-1]].splitlines()
                      if BOOTED in line]
            out["restart_boot_s"][i] = (
                _log_local_time(booted[0]) - (t_load + at) if booted else None)
    out["certificates"] = [
        stored_certificates(primary_store_log(workdir, i), committee)
        for i in range(n)]
    # {header as the log prints it: its author}
    out["origins"] = {repr(c.header.id): c.origin
                      for certs in out["certificates"] for c in certs}
    out["snapshots"] = {}
    for name, path in out["metrics_paths"].items():
        if os.path.exists(path):  # a SIGKILLed life may have written none
            with open(path) as f:
                out["snapshots"][name] = json.load(f)
    out["seconds"] = time.monotonic() - t0
    return out


def node_checks(run: dict, min_leaders: int) -> dict:
    """What every node committee run must show: each process exited 0, no
    log has an error line or a traceback, ``parse_logs`` reads the logs
    with samples, every pair of primaries commits the same headers on
    their common prefix, each sequence is what the plain ``Tusk`` commits
    over that primary's store (:func:`replay_checks`), and the shortest
    sequence holds ``min_leaders`` leaders.  Returns the figures the logs
    give."""
    names = sorted(run["codes"])
    bad = {name: code for name, code in run["codes"].items() if code != 0}
    assert not bad, f"processes exited non-zero: {bad}"
    for name in names:
        for marker in ("ERROR", "Traceback"):
            assert marker not in run["logs"][name], f"{name}: {marker} in its log"
    # The reference's log parser, as it is: it imports only the standard
    # library, and its figures keep the reference's definitions.
    from benchmark.logs import parse_logs

    kinds = {k: [run["logs"][n] for n in names if n.startswith(k)]
             for k in ("client", "worker", "primary")}
    result = parse_logs(kinds["client"], kinds["worker"], kinds["primary"],
                        NODE_TX_SIZE)
    assert result.errors == [], result.errors
    assert result.samples > 0, "no sample transaction committed"
    joined, replayed = replay_checks(run, sorted(run["lives"]))
    seqs = [joined[i] for i in sorted(joined)]
    for i in range(len(seqs)):
        for j in range(i + 1, len(seqs)):
            k = min(len(seqs[i]), len(seqs[j]))
            assert seqs[i][:k] == seqs[j][:k], f"primaries {i} and {j} disagree"
    leaders = [committed_leaders(s, run["origins"], run["committee"]) for s in seqs]
    shortest = min(range(len(seqs)), key=lambda i: len(seqs[i]))
    assert leaders[shortest] >= min_leaders, (
        f"the shortest commit sequence holds {leaders[shortest]} leaders")
    t_load, t_end = run["load_window"]
    halves = [parse_logs(half, kinds["worker"], kinds["primary"], NODE_TX_SIZE)
              for half in split_client_logs(kinds["client"], (t_load + t_end) / 2)]
    return dict(
        consensus_tps=result.consensus_tps,
        consensus_latency_ms=result.consensus_latency_ms,
        end_to_end_tps=result.end_to_end_tps,
        end_to_end_latency_ms=result.end_to_end_latency_ms,
        # A committee that falls behind shows as a later half slower
        # than the first.
        end_to_end_latency_ms_halves=[h.end_to_end_latency_ms for h in halves],
        samples=result.samples, committed_batches=result.committed_batches,
        committed_bytes=result.committed_bytes, rate_misses=result.rate_misses,
        config=result.config, prefix_agrees=True, replay_equal=True,
        replayed_headers=[replayed[i] for i in sorted(replayed)],
        committed_headers=[len(s) for s in seqs], leaders_committed=leaders,
    )


def joined_sequence(lives, replay) -> list:
    """One authority's commit sequence over its lives (one sequence each),
    held to ``replay``, the plain ``Tusk``'s sequence over its store: the
    first life must be a prefix of it, and each later life a run of it
    that starts no later than where the lives before it ended (a restart
    may commit again what its last life committed after its checkpoint).
    Returns the joined sequence."""
    joined = list(lives[0])
    assert replay[:len(joined)] == joined, "first life != plain Tusk over its store"
    for life in lives[1:]:
        starts = [k for k in range(len(joined) + 1)
                  if replay[k:k + len(life)] == life]
        assert life and starts, "a restarted life is not a run of plain Tusk's sequence"
        joined = replay[:max(len(joined), starts[0] + len(life))]
    return joined


def replay_checks(run: dict, authorities) -> tuple:
    """Each authority's commit sequence over its primary's lives is what
    the port's plain ``Tusk`` (on the CPU) commits given the certificates
    of that primary's store by round (:func:`joined_sequence`): the same
    commit rule without the kernels, so a decision all primaries make the
    same wrong way fails here.  Returns ({authority: its joined
    sequence}, {authority: the replayed sequence's length})."""
    from narwhal_tpu_torch.consensus import Tusk

    joined, lengths = {}, {}
    for i in authorities:
        tusk = Tusk(run["committee"], run["gc_depth"])
        want = [(c.round, repr(c.header.id))
                for cert in run["certificates"][i]
                for c in tusk.process_certificate(cert)]
        lives = [run["sequences"][name] for name in run["lives"][i]]
        try:
            joined[i] = joined_sequence(lives, want)
        except AssertionError as e:
            raise AssertionError(f"primary-{i}: {e}") from None
        assert joined[i], f"primary-{i}: committed nothing"
        lengths[i] = len(want)
    return joined, lengths


def verify_launches_timed(launches: int, timed: int, bursts: int) -> bool:
    """Every verify launch of a primary is timed by CUDA events: one a
    burst, and the odd batch of another site.  A burst still on the
    backend's dispatch thread at shutdown runs to its end before the
    node's final snapshot (``CudaBackend.averify_batch_mask_timed``), so
    that snapshot holds both counts or neither."""
    return launches == timed >= bursts


def _hist(snap: dict, name: str) -> dict:
    return snap["histograms"].get(name, {"count": 0, "sum": 0.0})


def phase_node():
    """Ten port validators through the port's node CLI on one card: every
    primary verifies its bursts on the ``cuda`` backend and commits
    through ``KernelTusk``; workers and clients run on the host."""
    ports = check_port_block(NODE_BASE_PORT, 5 * NODE_N)
    node = [sys.executable, "-m", "narwhal_tpu_torch.node"]
    committee_json = os.path.join(NODE_WORKDIR, "committee.json")
    run = run_node_committee(
        NODE_WORKDIR, NODE_N, NODE_BASE_PORT, NODE_RATE, NODE_LOAD_S,
        primary_flags=("--crypto-backend", "cuda", "--experimental-consensus-kernel"),
        primary_boot=CARD_PRIMARY_BOOT,
        prewarm=node + ["prewarm", "--committee", committee_json,
                        "--experimental-consensus-kernel"])
    checks = node_checks(run, NODE_MIN_LEADERS)
    assert run["wall_s"] <= NODE_CAP_S, f"node phase took {run['wall_s']:.1f} s"
    per_primary = []
    for i in range(NODE_N):
        snap, log = run["snapshots"][f"primary-{i}"], run["logs"][f"primary-{i}"]
        assert "Crypto backend: cuda (requested cuda)" in log, f"primary-{i}"
        counters = snap["counters"]
        device = _hist(snap, "crypto.verify.device_seconds.batch_burst")
        wall = _hist(snap, "crypto.verify.seconds.batch_burst")
        kernel = _hist(snap, "crypto.verify.kernel_seconds")
        claims = counters.get("crypto.verify.ops.batch_burst", 0)
        dispatches = counters.get("consensus.kernel.dispatches", 0)
        assert claims > 0 and device["count"] > 0 and dispatches > 0, (
            f"primary-{i}: claims {claims}, bursts {device['count']}, "
            f"dispatches {dispatches}")
        bursts = device["count"]
        # Each kernel's launches in that process, counted where it
        # launches (ops.check_launch), the boot's warm-ups apart.
        launches = {k: counters.get(f"kernel.launches.{k}", 0)
                    for k in NODE_KERNELS}
        warmup = {k: counters.get(f"kernel.warmup_launches.{k}", 0)
                  for k in NODE_KERNELS}
        assert all(launches.values()), f"primary-{i}: launches {launches}"
        assert verify_launches_timed(launches["ed25519_verify"], kernel["count"], bursts), (
            f"primary-{i}: {launches['ed25519_verify']} verify launches, "
            f"{kernel['count']} timed, {bursts} bursts")
        rounds = _hist(snap, "primary.round_advance_seconds")
        per_primary.append(dict(
            rounds=rounds["count"],
            ms_per_round=1000 * rounds["sum"] / max(1, rounds["count"]),
            bursts=bursts, claims_per_burst=claims / bursts,
            ms_backend_per_burst=1000 * device["sum"] / bursts,
            # Of the time from the last node's boot to the stop: this
            # primary's own dispatch thread, in the backend.
            backend_busy_share=device["sum"] / (run["wall_s"] - run["boot_s"]),
            ms_wall_per_burst=1000 * wall["sum"] / max(1, wall["count"]),
            # CUDA events around the verify launch, in that primary's
            # own process: a wait for the other primaries' contexts counts.
            ms_kernel_per_burst=1000 * kernel["sum"] / max(1, kernel["count"]),
            kernel_timed_bursts=kernel["count"],
            leaders_committed=checks["leaders_committed"][i],
            kernel_dispatches=dispatches, launches=launches,
            warmup_launches=warmup,
            python_fallbacks=counters.get("consensus.kernel.python_fallbacks", 0),
            last_committed_round=snap["gauges"].get("consensus.last_committed_round"),
            commit_lag_rounds=snap["gauges"].get("consensus.commit_lag_rounds"),
            # The node's sampling profiler (NARWHAL_PROFILE_HZ): the frames
            # its threads spent the most samples in, idle waits left out.
            profile_top=[(f["frame"], f["self_frac"])
                         for f in (snap["detail"].get("profile.top") or [])[:4]],
            # The verify launcher's frames among its top 25: the staged
            # copy in and the launch are enqueued in COPY_FRAME, the wait
            # on the mask is in verify_sharded (as the profiler sees it,
            # torch's streams.py:synchronize), and to_device (the nine
            # pageable copies before the staged launcher) must be gone.
            copy_frame=COPY_FRAME,
            verify_frames={f["frame"]: f["self_frac"]
                           for f in (snap["detail"].get("profile.top") or [])
                           if f["frame"].startswith("ed25519.py:")},
        ))
    result = dict(
        phase="node", committee=NODE_N, workers_per_authority=1,
        rate_per_client=NODE_RATE, rate_total=NODE_RATE * NODE_N,
        tx_size=NODE_TX_SIZE, load_s=NODE_LOAD_S, host_cpus=os.cpu_count(),
        processes=run["processes"], prewarm_s=run["prewarm_s"],
        boot_s=run["boot_s"], wall_s=run["wall_s"], seconds=run["seconds"],
        nvidia_smi=nvidia_smi_line(), compute_mode=compute_mode(), **ports,
        node_bursts=sum(p["kernel_timed_bursts"] for p in per_primary),
        node_dispatches=sum(p["kernel_dispatches"] for p in per_primary),
        node_launches={k: sum(p["launches"][k] for p in per_primary)
                       for k in NODE_KERNELS},
        **checks, primaries=per_primary,
    )
    emit(result)
    return result


# -- the faults phase ---------------------------------------------------------
# The node phase's deployment (N=10, stake 1, one worker an authority, the
# default Parameters, ten clients at 1,000 tx/s of 512 B) under the fault
# suite's own published plans (benchmark/scenarios/): wrong_key on
# authority 2 (byz_wrong_key.json), equivocate on authority 3
# (byz_equivocate.json), and crash_restart.json's SIGKILL at 12 s and
# restart at 18 s over the same store, moved to authority 6 since its
# node 2 is the wrong-key attacker here.  Run as
# benchmark/fault_bench.py::run_scenario runs a scenario, through the port's
# node CLI, and judged by the port's own golden replay.
FAULTS_BASE_PORT = 10000
FAULTS_LOAD_S = 30.0
FAULTS_CAP_S = 200.0  # from the first node's start to the last exit
FAULTS_MIN_LEADERS = 15
FAULTS_CRASHED = 6
FAULTS_WORKDIR = os.path.join(HERE, "build", "faults_phase")
RESTORED = re.compile(r"Restored consensus frontier at round (\d+)")


def faults_scenario(n: int = NODE_N, rate: int = NODE_RATE,
                    load_s: float = FAULTS_LOAD_S, byzantine=None,
                    crashed: int = FAULTS_CRASHED) -> dict:
    """The faults phase's scenario as one ``FaultScenario`` object, built
    from the published plans under ``benchmark/scenarios/`` (read as
    data): their Byzantine entries (``byzantine`` names the files to take
    them from), crash_restart.json's timing and env with the crash on
    authority ``crashed`` (None: no crash), and the rules they expect."""
    def plan(name):
        with open(os.path.join(HERE, "benchmark", "scenarios", name + ".json")) as f:
            return json.load(f)

    byzantine = ("byz_wrong_key", "byz_equivocate") if byzantine is None else byzantine
    plans = [plan(name) for name in byzantine]
    spec = {
        "name": "port_faults_n%d" % n, "nodes": n, "workers": 1,
        "rate": rate * n, "tx_size": NODE_TX_SIZE, "duration": load_s, "seed": 7,
        "byzantine": [b for p in plans for b in p["byzantine"]],
        "expect": {"rules": [r for p in plans for r in p["expect"]["rules"]]},
        "progress_wait": max([p["progress_wait"] for p in plans], default=30),
    }
    if crashed is not None:
        crash = plan("crash_restart")
        spec["crash"] = [dict(c, node=crashed) for c in crash["crash"]]
        spec["env"] = crash["env"]
        spec["expect"]["rules"] += crash["expect"]["rules"]
        spec["progress_wait"] = max(spec["progress_wait"], crash["progress_wait"])
    return spec


def fired_rules(snap: dict, log: str) -> set:
    """The health rules a primary saw fire: FIRING events in its
    snapshot's ``health`` section, and its ``HEALTH anomaly FIRING`` log
    lines (the section keeps the last 64 transitions only)."""
    health = snap.get("health") or {}
    fired = {e["rule"] for e in health.get("events", []) if e.get("event") == "FIRING"}
    fired |= {f["rule"] for f in health.get("firing", [])}
    fired |= set(re.findall(r"HEALTH anomaly FIRING rule=(\w+)", log))
    return fired


def fault_checks(run: dict, min_leaders: int) -> dict:
    """The fault suite's three verdicts over a run of
    :func:`run_node_committee` with a scenario, with the port's own judge:
    safety (every honest authority's audit segments replayed by
    ``narwhal_tpu_torch.consensus.replay.replay_segments``, their commits
    a common prefix by ``cross_node_prefix``, and each honest primary's
    logged sequence what the plain ``Tusk`` commits over its store,
    :func:`replay_checks`), liveness (clients' payload committed on every
    surviving honest primary after the last restart settled, a restarted
    one past its store's head at the crash; the shortest honest sequence
    holds ``min_leaders`` leaders) and detection (each expected rule fired
    on an honest primary).  Every honest process but a crashed life must
    have exited 0.  Returns the figures."""
    from narwhal_tpu_torch.consensus.replay import cross_node_prefix, replay_segments

    committee, n = run["committee"], len(run["lives"])
    honest = [i for i in range(n) if i not in run["byzantine"]]
    killed = {name.replace("primary", role, 1)
              for i in range(n) for name in run["lives"][i][:-1]
              for role in ("primary", "worker")}
    bad = {name: code for name, code in run["codes"].items()
           if code != 0 and name not in killed
           and (name.startswith("client")
                or int(name.split("-")[1].split(".")[0]) in honest)}
    assert not bad, f"processes exited non-zero: {bad}"
    verdicts, digests = {}, {}
    for i in honest:
        v = replay_segments(committee, run["gc_depth"], run["segments"][i])
        digests[f"primary-{i}"] = v.pop("commit_digests")
        verdicts[f"primary-{i}"] = v
        assert v["ok"] and v["recorded_commits"] > 0, f"primary-{i}: replay {v}"
    cross = cross_node_prefix(digests)
    assert cross["ok"], f"cross-node prefix: {cross}"
    sequences, replayed = replay_checks(run, honest)
    leaders = {i: committed_leaders(s, run["origins"], committee)
               for i, s in sequences.items()}
    assert min(leaders.values()) >= min_leaders, (
        f"the shortest honest commit sequence holds {min(leaders.values())} leaders")
    # A restarted primary that only commits again what its store held has
    # not rejoined the committee: it must commit a round past that head.
    rejoined = {i: r for i, r in run["rejoined_rounds"].items() if i in honest}
    for i, (head, last) in rejoined.items():
        assert last > head, (
            f"primary-{i}: its last life committed up to round {last}, "
            f"not past round {head}, its store's head at the crash")
    late = run["payload_commits_after_settle"]
    assert all(late.values()), f"no payload commits after the settle point: {late}"
    fired = set()
    for i in honest:
        name = run["lives"][i][-1]
        fired |= fired_rules(run["snapshots"].get(name, {}), run["logs"][name])
    expected = run["scenario"]["expect"]["rules"]
    missing = [r for r in expected if r not in fired]
    assert not missing, f"health rules never fired on an honest primary: {missing}"
    return dict(
        safety={"ok": True, "nodes": verdicts, "cross_node": cross,
                "replay_equal": True, "replayed_headers": replayed},
        liveness={"ok": True, "payload_commits_after_settle": late,
                  "rejoined_rounds": rejoined,
                  "leaders_committed": leaders,
                  "committed_headers": {i: len(s) for i, s in sequences.items()}},
        detection={"ok": True, "expected": expected, "fired": sorted(fired)},
    )


def phase_faults():
    """The node phase's deployment under attack on one card: ten port
    validators through the node CLI, every primary verifying on the
    ``cuda`` backend and committing through ``KernelTusk``, authority 2
    signing its headers with a wrong key, authority 3 equivocating and
    authority 6 SIGKILLed and restarted over its store; judged by the
    port's own golden replay, and by the card's counts that the attack
    met its kernels."""
    ports = check_port_block(FAULTS_BASE_PORT, 5 * NODE_N)
    node = [sys.executable, "-m", "narwhal_tpu_torch.node"]
    spec = faults_scenario()
    run = run_node_committee(
        FAULTS_WORKDIR, NODE_N, FAULTS_BASE_PORT, NODE_RATE, FAULTS_LOAD_S,
        primary_flags=("--crypto-backend", "cuda", "--experimental-consensus-kernel"),
        primary_boot=CARD_PRIMARY_BOOT,
        prewarm=node + ["prewarm", "--committee",
                        os.path.join(FAULTS_WORKDIR, "committee.json"),
                        "--experimental-consensus-kernel"],
        scenario=spec)
    # No child may be let off the card: a strict cuda request fails at
    # boot instead of falling back to the cpu backend.
    strict_off = [name for name, env in run["children_env"].items()
                  if env.get("NARWHAL_CRYPTO_BACKEND_STRICT") == "0"]
    assert not strict_off, f"NARWHAL_CRYPTO_BACKEND_STRICT=0 for {strict_off}"
    checks = fault_checks(run, FAULTS_MIN_LEADERS)
    assert run["wall_s"] <= FAULTS_CAP_S, f"faults phase took {run['wall_s']:.1f} s"
    honest = [i for i in range(NODE_N) if i not in run["byzantine"]]
    wrong_key = [b["node"] for b in spec["byzantine"] if "wrong_key" in b["behaviors"]]
    # Launches summed over the lives that stopped on SIGTERM (their final
    # snapshots), and apart, over the SIGKILLed lives' last periodic
    # snapshots: those miss what a life launched after its last one.
    per_primary = []
    totals, killed = ({k: 0 for k in NODE_KERNELS} for _ in range(2))
    for i in range(NODE_N):
        for life, name in enumerate(run["lives"][i]):
            last = life == len(run["lives"][i]) - 1
            snap = run["snapshots"].get(name)
            if snap is None:
                assert not last, f"{name}: no snapshot"
                continue  # a SIGKILLed life may leave none
            counters = snap["counters"]
            launches = {k: counters.get(f"kernel.launches.{k}", 0) for k in NODE_KERNELS}
            for k in NODE_KERNELS:
                (totals if last else killed)[k] += launches[k]
            device = _hist(snap, "crypto.verify.device_seconds.batch_burst")
            kernel = _hist(snap, "crypto.verify.kernel_seconds")
            rounds = _hist(snap, "primary.round_advance_seconds")
            record = dict(
                name=name, honest=i in honest,
                behaviors=next((b["behaviors"] for b in spec["byzantine"]
                                if b["node"] == i), []),
                bursts=device["count"],
                invalid_signatures=counters.get("primary.invalid_signatures", 0),
                equivocations=counters.get("primary.equivocations_detected", 0),
                wrong_key_headers=counters.get("faults.byzantine.wrong_key_headers", 0),
                twins_minted=counters.get("faults.byzantine.twins_minted", 0),
                leaders=checks["liveness"]["leaders_committed"].get(i),
                ms_per_round=1000 * rounds["sum"] / max(1, rounds["count"]),
                ms_backend_per_burst=1000 * device["sum"] / max(1, device["count"]),
                ms_kernel_per_burst=1000 * kernel["sum"] / max(1, kernel["count"]),
                launches=launches,
                warmup_launches={k: counters.get(f"kernel.warmup_launches.{k}", 0)
                                 for k in NODE_KERNELS},
            )
            per_primary.append(record)
            if i in honest:
                log = run["logs"][name]
                assert "Crypto backend: cuda (requested cuda)" in log, name
                assert all(launches.values()), f"{name}: launches {launches}"
                assert device["count"] and verify_launches_timed(
                        launches["ed25519_verify"], kernel["count"], device["count"]), (
                    f"{name}: {launches['ed25519_verify']} verify launches, "
                    f"{kernel['count']} timed, {device['count']} bursts")
    by_name = {p["name"]: p for p in per_primary}
    for i in wrong_key:
        assert by_name[f"primary-{i}"]["wrong_key_headers"] > 0, f"primary-{i}"
    honest_records = [p for p in per_primary if p["honest"]]
    invalid = sum(p["invalid_signatures"] for p in honest_records)
    equivocations = sum(p["equivocations"] for p in honest_records)
    assert invalid > 0, "no honest primary rejected a signature"
    assert equivocations > 0, "no honest primary detected an equivocation"
    # The crashed authority's second life: restored from its store on the
    # card, launching the update and the scan again, its segment committing.
    from narwhal_tpu_torch.consensus.replay import TAG_COMMIT, read_audit

    second = run["lives"][FAULTS_CRASHED][-1]
    restored = RESTORED.search(run["logs"][second])
    assert len(run["lives"][FAULTS_CRASHED]) == 2 and restored, (
        f"{second}: no restored consensus frontier")
    assert all(by_name[second]["launches"].values()), f"{second}: {by_name[second]}"
    segment_commits = sum(tag == TAG_COMMIT for tag, _ in read_audit(
        run["segments"][FAULTS_CRASHED][-1]))
    assert segment_commits > 0, f"{second}: its audit segment records no commit"
    result = dict(
        phase="faults", scenario=spec, committee=NODE_N,
        rate_per_client=NODE_RATE, tx_size=NODE_TX_SIZE, load_s=run["load_s"],
        host_cpus=os.cpu_count(), processes=run["processes"],
        prewarm_s=run["prewarm_s"], boot_s=run["boot_s"], wall_s=run["wall_s"],
        seconds=run["seconds"], events=run["events"], nvidia_smi=nvidia_smi_line(),
        **ports, restore_round=int(restored.group(1)),
        restart_boot_s=run["restart_boot_s"][FAULTS_CRASHED],
        restored_segment_commits=segment_commits,
        invalid_signatures=invalid, equivocations=equivocations,
        faults_launches=totals, faults_launches_killed_life_lower_bound=killed,
        crash_heads=run["crash_heads"],
        verdicts=checks, primaries=per_primary,
    )
    emit(result)
    return result


# -- the committee-sharded commit step ----------------------------------------
# Four ranks at the reference's dry-run shape (seed 1, W=16, N=16), there
# also at the anchors -1, 0 and W, at the flagship's (seed 0, W=64, N=50:
# 13 columns a block, the last padded), at N=200 (50 columns a block: a
# slot's 7 warps rounded up to a multiple of the row's 2 words) and at
# the kernels' largest (W=8, N=1024); an anchor of None is the fixture's.
MULTICHIP_RANKS = 4
MULTICHIP_CASES = ((1, 16, 16, None), (1, 16, 16, -1), (1, 16, 16, 0), (1, 16, 16, 16),
                   (0, 64, 50, None), (0, 64, 200, None), (2, 8, 1024, None))
# The slot kernel alone also over two ranks, where a slot's warps are not
# a multiple of the row's words either (3 warps, 2 words; 7 warps, 4).
BLOCK_CASES_TWO_RANKS = ((1, 16, 65, None), (0, 64, 200, None))
MULTICHIP_KERNELS = ("commit_step_block",)
MULTICHIP_STEPS = 5  # timed sharded steps a rank runs after the checked one
MULTICHIP_TIMEOUT_S = 300.0


def bits(t) -> str:
    import numpy as np

    return np.packbits(t.cpu().numpy().reshape(-1)).tobytes().hex()


def whole_fixture(case, device) -> list:
    """A multichip case's :func:`~narwhal_tpu_torch.commit_step.commit_fixture`
    as tensors on ``device``, the anchor slot an int."""
    import numpy as np
    import torch

    from narwhal_tpu_torch.commit_step import commit_fixture

    seed, window, n, anchor = case
    fixture = [a if isinstance(a, int) else torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in commit_fixture(seed, window, n)]
    if anchor is not None:
        fixture[5] = anchor
    return fixture


def slot_bytes(k: int, n: int, nb: int, rows: int) -> int:
    """Bytes one slot of the sharded step must move: the gathered record
    (k × R words) and the frontier's ``rows`` of the packed parent block
    read once, exists[w], leader[w], the leader flag and the anchor read
    once, the rank's record written once."""
    from narwhal_tpu_torch.ops import reachability as R

    words = R.record_words(n, nb)
    return 4 * k * words + 4 * rows * -(-nb // 32) + 2 * nb + 1 + 4 + 4 * words


def block_launch(top: bool, W: int, N: int, nb: int) -> dict:
    """A slot's launch of ``commit_step_block`` at (W, N) over blocks of
    ``nb`` columns (``nt_commit_step_block_attributes``; ``top``: the top
    slot's, which also packs): registers, local (spill) and static shared
    bytes per thread, block size and blocks."""
    from narwhal_tpu_torch.ops import kernel_fn

    out = (ctypes.c_int * 5)()
    rc = kernel_fn("nt_commit_step_block_attributes", ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int))(
        int(top), W, N, nb, out)
    assert rc == 0, f"nt_commit_step_block_attributes failed: cudaError {rc}"
    return dict(zip(("registers_per_thread", "local_bytes_per_thread",
                     "static_shared_bytes", "block", "blocks"), out))


def block_records(device) -> dict:
    """``nt_commit_step_block`` against its plain twin on the card,
    tolerance 0: at each of MULTICHIP_CASES over MULTICHIP_RANKS ranks and
    BLOCK_CASES_TWO_RANKS over two, every rank's launch of every slot of
    a step (the top one packing the rank's parent block), the record of
    the slot above gathered from the kernel's own records; each slot's g
    also held to the whole window's fused commit step.  Then, in each
    case, the slot below the top one from a record whose frontier holds
    every row (the anchor at the top slot).  Times over MULTICHIP_RANKS
    ranks at the flagship's shape (rank 0's block at the slot below the
    anchor, the top slot, the whole frontier) and the whole frontier at
    each case's fixture anchor."""
    import torch

    from narwhal_tpu_torch.commit_step import commit_fixture, shard_commit_args
    from narwhal_tpu_torch.ops import LAUNCHES, reachability as R

    before = dict(LAUNCHES)
    mism = Mismatch()
    slice_mism = 0
    shapes, timed = [], {}
    for k, case in ([(MULTICHIP_RANKS, case) for case in MULTICHIP_CASES]
                    + [(2, case) for case in BLOCK_CASES_TWO_RANKS]):
        seed, W, N, _ = case
        ranked = k == MULTICHIP_RANKS
        fixture = whole_fixture(case, device)
        _, _, leader, is_lead, _, anchor, _ = fixture
        _, _, reach = R.commit_step_fused(*fixture)
        nb = -(-N // k)
        bw = -(-nb // 32)
        np_fixture = list(commit_fixture(seed, W, N))
        np_fixture[5] = anchor
        blocks = [shard_commit_args(r, k, np_fixture, device) for r in range(k)]
        anchor_t = torch.tensor(anchor, dtype=torch.int32, device=device)
        # Every bit set before the top launch packs: a word it leaves
        # unpacked adds rows to the frontier's parents.
        packed = [torch.full((R.packed_words(W, N, nb),), -1, dtype=torch.int32,
                             device=device) for _ in range(k)]

        def check(w, prev, r, anchor_t=anchor_t, k=k, blocks=blocks, packed=packed):
            args = (w, *blocks[r][:5], anchor_t, blocks[r][6], prev, packed[r])
            got = R.commit_step_block(*args, rank=r, k=k)
            mism.add((got,), (R.commit_step_block_plain(*args, rank=r, k=k),))
            return args, got

        prev, rows = None, []
        for w in R._step_slots(W):
            if prev is not None:
                front = R.unpack_bits(prev[:, :bw], nb).reshape(-1)[:N]
                lead = R.unpack_bits(prev[:, bw:2 * bw], nb).reshape(-1)[:N]
                rows.append(int((lead if lead.any() else front).sum()))
            recs = []
            for r in range(k):
                args, got = check(w, prev, r)
                recs.append(got)
                want = torch.zeros(k * nb, dtype=torch.bool, device=device)
                want[:N] = reach[w]
                slice_mism += diff(R.unpack_bits(got[:bw], nb), want.view(k, nb)[r])[0]
                if ranked and (W, N, case[3]) == (64, N_COMMITTEE, None) and r == 0:
                    if w == W - 1:
                        timed["top"] = (args, W * N * nb + 4 * len(packed[0]) + 4)
                    elif w == anchor - 1:
                        timed["slot"] = (args, slot_bytes(k, N, nb, rows[-1]))
            prev = torch.stack(recs)
        # The whole frontier: every rank's g set, the anchor at the top slot.
        if W > 1:
            full = torch.zeros_like(prev)
            full[:, :bw] = R.pack_bits(torch.ones((k, nb), dtype=torch.bool, device=device))
            top = torch.tensor(W - 1, dtype=torch.int32, device=device)
            for r in range(k):
                check(W - 1, None, r, top)
                args, _ = check(W - 2, full, r, top)
                if ranked and r == 0 and case[3] is None:
                    timed[f"whole_w{W}_n{N}"] = (args, slot_bytes(k, N, nb, N))
        shapes.append(dict(window=W, committee=N, ranks=k, block_cols=nb, anchor=anchor,
                           record_words=R.record_words(N, nb),
                           packed_words=R.packed_words(W, N, nb), slots=len(rows) + 1,
                           frontier_rows_mean=sum(rows) / max(1, len(rows)),
                           launch_top=block_launch(True, W, N, nb),
                           launch_slot=block_launch(False, W, N, nb)))

    k = MULTICHIP_RANKS

    def ms(name):
        args = timed[name][0]
        return cuda_ms(lambda: R.commit_step_block(*args, rank=0, k=k), 100, prefill=True)

    args, nbytes = timed["slot"]
    graft = ("__graft_entry__.py:147 (jax.jit of make_commit_step over a committee mesh: "
             "GSPMD's column-sharded _chain_scan step, narwhal_tpu/ops/reachability.py:88, "
             "and its support_stake votes, reachability.py:268)")
    return {"commit_step_block": dict(
        replaces=graft, source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=mism.count + slice_mism, max_abs_err=mism.err,
        check_launches=LAUNCHES["commit_step_block"] - before["commit_step_block"],
        ms=ms("slot"),
        host_ms_per_call=host_ms(lambda: R.commit_step_block(*args, rank=0, k=k), 100),
        plain_ms=cuda_ms(lambda: R.commit_step_block_plain(*args, rank=0, k=k), 20),
        library_ms=None, bound_ms=1000 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
        extra=dict(
            shapes=shapes, scan_slice_mismatches=slice_mism, slot_bytes_w64_n50=nbytes,
            ms_top_w64_n50=ms("top"),
            bound_ms_top_w64_n50=1000 * timed["top"][1] / HBM_BYTES_PER_S,
            **{f"ms_{name}": ms(name) for name in timed if name.startswith("whole")},
            **{f"bound_ms_{name}": 1000 * timed[name][1] / HBM_BYTES_PER_S
               for name in timed if name.startswith("whole")}))}


def phase_multichip():
    """The committee-sharded commit step
    (``narwhal_tpu_torch.commit_step.dryrun_multichip``): MULTICHIP_RANKS
    gloo ranks sharing the card, one process each, at MULTICHIP_CASES,
    then an NCCL world of one rank a visible card at the reference's
    shape, the flagship and N=1024.  Each rank runs a first step (on NCCL
    the graph's warm-up, capture and first replay), resets the launch
    counts, runs the checked step and reads them, checks its result (rank
    0 against the whole window), then times MULTICHIP_STEPS steps (on
    NCCL eager and graph in turns).  Here every rank's result is held to
    ``commit_step_fused`` on the whole window, tolerance 0, every rank must
    have launched ``commit_step_block`` exactly once a slot, and every
    NCCL rank must have run its step as a graph replay."""
    import torch

    from narwhal_tpu_torch.commit_step import dryrun_multichip
    from narwhal_tpu_torch.ops import reachability as R

    device = torch.device("cuda", 0)
    cards = torch.cuda.device_count()
    t_phase = time.perf_counter()
    mism, launches, cases, worlds = 0, dict.fromkeys(MULTICHIP_KERNELS, 0), [], []
    for backend, ranks, world_cases in (
            ("gloo", MULTICHIP_RANKS, MULTICHIP_CASES),
            ("nccl", cards, ((1, 16, 4 * cards, None), (0, 64, 50, None),
                             (2, 8, 1024, None)))):
        t0 = time.perf_counter()
        records = dryrun_multichip(ranks, backend=backend, cases=world_cases,
                                   steps=MULTICHIP_STEPS, timeout=MULTICHIP_TIMEOUT_S)
        worlds.append(dict(backend=backend, ranks=ranks, seconds=time.perf_counter() - t0))
        for i, case in enumerate(world_cases):
            support, committed, reach = R.commit_step_fused(*whole_fixture(case, device))
            want = (int(support), bits(committed), bits(reach))
            _, W, N, _ = case
            per_rank = []
            for rank_records in records:
                rec = rank_records[i]
                mism += (rec["support"], rec["committed_bits"], rec["reach_bits"]) != want
                assert rec["launches"] == {"commit_step_block": len(R._step_slots(W))}, (
                    backend, case, rec["rank"], rec["launches"])
                assert rec["graph"] == (backend == "nccl"), (backend, case, rec["rank"])
                for name in MULTICHIP_KERNELS:
                    launches[name] += rec["launches"][name]
                per_rank.append(dict(
                    rank=rec["rank"], device=rec["device"], backend=rec["backend"],
                    graph=rec["graph"], launches_per_step=rec["launches"],
                    block_step_ms=rec["block_step_ms"], top_step_ms=rec["top_step_ms"],
                    step_wall_ms=rec["step_wall_ms"], first_step_ms=rec["first_step_ms"],
                    **{key: rec[key] for key in ("step_wall_ms_graph", "step_wall_ms_eager")
                       if key in rec}))
            nb = -(-N // ranks)
            cases.append(dict(
                backend=backend, ranks=ranks, seed=case[0], window=W, committee=N,
                anchor_slot=records[0][i]["anchor_slot"], block_cols=nb,
                support=want[0], committed=int(committed.sum()),
                reach_cells=int(reach.sum()),
                # A rank's parent block, read once, over the card's memory rate.
                parent_block_bytes=W * N * nb,
                bound_ms=1000 * W * N * nb / HBM_BYTES_PER_S, per_rank=per_rank))
    assert mism == 0, f"sharded steps != commit_step_fused: {mism} rank results"
    flagship = [c for c in cases if (c["window"], c["committee"]) == (64, N_COMMITTEE)]
    assert [(c["support"], c["committed"], c["reach_cells"]) for c in flagship] == [
        (28, 26, 2477)] * 2, flagship
    result = dict(
        phase="multichip", cards=cards, worlds=worlds, cases=cases, mismatches=mism,
        tolerance=0, launches=launches, seconds=time.perf_counter() - t_phase,
        nvidia_smi=nvidia_smi_line())
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
    bad.update({f"{r['launcher']} x{r['shards']} B={r['rows']}": r["mismatches"]
                for r in records["ed25519_verify"]["extra"]["routes"]
                if r["mismatches"]})
    if bad:
        print(f"chip_smoke: kernels disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1

    step = phase_commit_step(device)
    main = phase_main_path(keys, committee, signed, rng)
    committee_run = phase_committee()
    node_run = phase_node()
    faults_run = phase_faults()
    multichip_run = phase_multichip()

    # Each kernel's launches on the path that carries it: the flagship
    # commit step for its one launch, the main path's live-window check
    # for the three bool-window kernels, the node's main path for the
    # others.
    paths = {name: ("main_path", main["launches"]) for name in records}
    paths.update(commit_step=("commit_step", step["launches"]),
                 **{name: ("multichip", multichip_run["launches"])
                    for name in MULTICHIP_KERNELS},
                 **{name: ("main_path_live_check", main["live_check_launches"])
                    for name in ("support_stake", "leader_chain_scan",
                                 "causal_mask_scan")})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": paths[name][1][name],
         "path": paths[name][0],
         "committee_launches": committee_run["launches"][name],
         # The node phase runs in ten other processes: each kernel's
         # launches there, warm-ups apart, summed over the primaries'
         # snapshots; beside them the verifier's timed bursts and the
         # update's flush dispatches (the rest of its launches are the
         # clears a scan runs first).
         **({"node_launches": node_run["node_launches"][name]}
            if name in NODE_KERNELS else {}),
         **({"node_bursts": node_run["node_bursts"]}
            if name == "ed25519_verify" else {}),
         # The same three kernels' launches in the faults phase, summed
         # over the primary lives that stopped on SIGTERM; the SIGKILLed
         # life's, from its last periodic snapshot, apart.
         **({"faults_launches": faults_run["faults_launches"][name],
             "faults_launches_killed_life_lower_bound":
                 faults_run["faults_launches_killed_life_lower_bound"][name]}
            if name in NODE_KERNELS else {}),
         **({"node_dispatches": node_run["node_dispatches"]}
            if name == "window_update" else {}),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         **({"committee_shape_mismatches": r["extra"]["committee_shape"]["mismatches"]}
            if "committee_shape" in r.get("extra", {}) else {}),
         **({"routes": [
             {k: v for k, v in route.items() if k != "check_launches"}
             for route in r["extra"]["routes"]],
             **{k: r["extra"][k] for k in (
                 "ms_b16384", "ms_b16", "ms_b32", "registers_per_thread",
                 "local_bytes_per_thread",
                 "launch_b2048", "stage_host_ms")}}
            if name == "ed25519_verify" else {}),
         **({k: r["extra"][k] for k in ("launch_w64_n50", "cycles_w64_n50", "shapes",
                                        "registers_by_n")}
            if name in SCAN_KERNELS else {}),
         **({k: r["extra"][k] for k in ("forms", "shapes", "apply_no_ring_ms",
                                        "negative_index_cases")}
            if name == "window_update" else {}),
         **({k: r["extra"][k] for k in ("launch_n50", "launch_n1024", "fill_one_ms")}
            if name == "support_stake" else {}),
         **({k: r["extra"][k] for k in ("launch_w64_n50", "registers_by_n",
                                        "ms_two_launches", "ms_chain_scan_alone")}
            if name == "commit_step" else {}),
         **({k: v for k, v in r["extra"].items() if k != "scan_slice_mismatches"}
            if name in MULTICHIP_KERNELS else {})}
        for name, r in records.items()
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
