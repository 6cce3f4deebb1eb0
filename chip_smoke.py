#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``narwhal_tpu_torch``) on one GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, then drives a
primary's certificate path at the N=50 committee size: every round's
signature claims verified in one batch on the ``cuda`` crypto backend,
then the certificates through ``Consensus(use_kernel=True)`` on the card,
whose commit sequence must equal the Python Tusk's.  One JSON line per
phase; the line before the last is the card's name and power limit as
nvidia-smi reports them, and the last line is
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
# One 64×64→128-bit limb product of the verifier costs four 32-bit
# multiply-adds; a field multiply is 25 limb products (csrc/field25519.cuh).
MADS_PER_FIELD_MUL = 25 * 4
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
    records["ed25519_verify"] = dict(
        registers_per_thread=regs.value,
        local_bytes_per_thread=local_bytes.value,
        replaces="narwhal_tpu/ops/ed25519.py:232",
        source="narwhal_tpu_torch/csrc/ed25519_verify.cu",
        mismatches=mism + mism16 + py_mism,
        max_abs_err=max(err, err16, float(py_mism > 0)),
        check_launches=check_launches,
        checked=dict(b2048=VERIFY_BATCH, b16384=8 * VERIFY_BATCH,
                     py_sample=len(sample),
                     corrupted=kind.count("corrupted"),
                     hostile=sum(k.startswith("hostile") for k in kind)),
        ms=cuda_ms(lambda: E.verify_kernel(*args), 20),
        host_ms_per_call=host_ms(lambda: E.verify_kernel(*args), 20),
        ms_b16384=cuda_ms(lambda: E.verify_kernel(*tiled), 5),
        plain_ms=plain_ms,
        bound_ms=1000 * max(
            VERIFY_BATCH * (sum(a[0].nbytes for a in prep) + 1) / HBM_BYTES_PER_S,
            VERIFY_BATCH * E.FIELD_MULS_PER_VERIFY * MADS_PER_FIELD_MUL / INT32_MADS_PER_S,
        ),
        bound_by="operations",
        library_ms=None,
    )

    # -- the window kernels at W = 64, N = 50, C = 256
    nrng = np.random.default_rng(SEED)
    W, N = 64, N_COMMITTEE
    C = 256
    exists_np, parent_np = causal_window(nrng, W, N)
    ins_w = nrng.integers(0, W + 1, C).astype(np.int32)  # W: padding
    ins_i = nrng.integers(0, N, C).astype(np.int32)
    row_w = nrng.integers(0, W + 1, C).astype(np.int32)
    row_c = nrng.integers(0, N, C).astype(np.int32)
    row_v = (nrng.random((C, N)) < 0.7).astype(np.int32)
    row_w[1], row_c[1] = row_w[0] % W, row_c[0]  # one cell hit twice
    row_w[0] = row_w[1]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    flush = [dev(a) for a in (ins_w, ins_i, row_w, row_c, row_v)]
    ke, kp = dev(exists_np), dev(parent_np)
    pe, pp = dev(exists_np), dev(parent_np)
    before = dict(LAUNCHES)
    R.window_apply(ke, kp, *flush)
    R.window_apply_plain(pe, pp, *flush)
    torch.cuda.synchronize()
    (m1, e1), (m2, e2) = diff(ke, pe), diff(kp, pp)
    records["window_apply"] = dict(
        mismatches=m1 + m2, max_abs_err=max(e1, e2),
        check_launches=LAUNCHES["window_apply"] - before["window_apply"],
    )
    te, tp = dev(exists_np), dev(parent_np)
    valid_rows = int(((row_w >= 0) & (row_w < W)).sum())
    valid_ins = int(((ins_w >= 0) & (ins_w < W)).sum())
    keep = (flush[2] < W)
    rw_l, rc_l, rv_k = flush[2][keep].long(), flush[3][keep].long(), flush[4][keep]
    iw_keep = flush[0] < W
    iw_l, ii_l = flush[0][iw_keep].long(), flush[1][iw_keep].long()
    ones = torch.ones_like(iw_l, dtype=torch.int32)

    def library_apply():
        te.index_put_((iw_l, ii_l), ones, accumulate=True)
        tp.index_put_((rw_l, rc_l), rv_k, accumulate=True)

    records["window_apply"].update(
        replaces="narwhal_tpu/ops/reachability.py:163",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        ms=cuda_ms(lambda: R.window_apply(te, tp, *flush), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: R.window_apply(te, tp, *flush), 100),
        plain_ms=cuda_ms(lambda: R.window_apply_plain(te, tp, *flush), 20),
        library_ms=cuda_ms(library_apply, 100, prefill=True),
        # Index vectors and rows read once; touched cells read and written.
        bound_ms=1000 * (4 * (4 * C + C * N) + 8 * (valid_rows * N + valid_ins))
        / HBM_BYTES_PER_S,
        bound_by="bytes",
    )

    shift_mism, shift_err = 0, 0.0
    before = dict(LAUNCHES)
    se, sp = dev(exists_np), dev(parent_np)
    oe, op_ = torch.empty_like(se), torch.empty_like(sp)
    qe, qp = torch.empty_like(se), torch.empty_like(sp)
    for d in (1, 2, 5, W - 1, W):
        R.window_shift(se, sp, d, oe, op_)
        R.window_shift_plain(se, sp, d, qe, qp)
        torch.cuda.synchronize()
        (m1, e1), (m2, e2) = diff(oe, qe), diff(op_, qp)
        shift_mism += m1 + m2
        shift_err = max(shift_err, e1, e2)
    shift_launches = LAUNCHES["window_shift"] - before["window_shift"]
    records["window_shift"] = dict(
        replaces="narwhal_tpu/ops/reachability.py:187",
        source="narwhal_tpu_torch/csrc/reachability.cu",
        mismatches=shift_mism,
        max_abs_err=shift_err,
        check_launches=shift_launches,
        ms=cuda_ms(lambda: R.window_shift(se, sp, 2, oe, op_), 100, prefill=True),
        host_ms_per_call=host_ms(lambda: R.window_shift(se, sp, 2, oe, op_), 100),
        plain_ms=cuda_ms(lambda: R.window_shift_plain(se, sp, 2, qe, qp), 20),
        library_ms=None,
        bound_ms=1000 * 2 * 4 * (W * N * N + W * N) / HBM_BYTES_PER_S,
        bound_by="bytes",
    )

    scan_mism, scan_err = 0, 0.0
    before = dict(LAUNCHES)
    committed_total = 0
    scan_args = None
    for trial in range(4):
        e_np, p_np = causal_window(nrng, W, N)
        leader = np.zeros((W, N), dtype=bool)
        is_lead = np.zeros(W, dtype=bool)
        for w in range(2, W - 1, 2):
            who = w % N
            leader[w, who] = bool(e_np[w, who])
            is_lead[w] = bool(e_np[w, who])
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
    return records


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
        flush_pending()  # staged rows → one packed copy → window_apply
        timings["flush_s"].append(time.perf_counter() - t0)

    tusk._flush_pending = timed_flush
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
               "commit_opportunity_s": [], "flush_s": []}
    t0 = time.perf_counter()
    committed, tusk = asyncio.run(drive_main_path(
        committee, signed, unsigned,
        {"signed": n_signed, "total": len(want)}, timings,
    ))
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    got_digests = [bytes(c.digest()) for c in committed]
    want_digests = [bytes(c.digest()) for c in want]
    assert got_digests == want_digests, "kernel commit sequence != Python Tusk"
    assert tusk.python_fallbacks == 0, tusk.python_fallbacks
    assert all(v > 0 for v in launches.values()), launches
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
        committed=len(committed), committed_after_signed=timings["after_signed"],
        last_committed_round=tusk.state.last_committed_round,
        python_fallbacks=tusk.python_fallbacks,
        sequence_equal=True,
        launches=launches,
        # Launches per main-path step: one verify per round burst; one
        # apply and one scan per commit opportunity, and one shift per
        # commit that moves the window.
        launches_per_verify_batch=launches["ed25519_verify"] / len(verify_s),
        launches_per_commit_opportunity={
            name: launches[name] / max(1, len(opp))
            for name in ("window_apply", "leader_commit_scan", "window_shift")
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
         **({"ms_b16384": r["ms_b16384"], "checked": r["checked"],
             "registers_per_thread": r["registers_per_thread"],
             "local_bytes_per_thread": r["local_bytes_per_thread"]}
            if "ms_b16384" in r else {})}
        for name, r in records.items()
    ]})
    bad = {n: r["mismatches"] for n, r in records.items() if r["mismatches"]}
    if bad:
        print(f"chip_smoke: kernels disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1

    main = phase_main_path(keys, committee, signed, rng)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": main["launches"][name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in records.items()
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
