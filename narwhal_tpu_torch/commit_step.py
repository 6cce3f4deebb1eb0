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
reference's bit for bit.

:func:`dryrun_multichip` runs the same step with the committee's columns
split over k ranks, one process each (:func:`shard_commit_args`,
:func:`~.ops.reachability.commit_step_sharded`), as the reference's
``dryrun_multichip`` runs it over a ``committee`` mesh: on k cards over
NCCL, or with ``backend="gloo"`` on ranks that share cards or run on the
CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import LAUNCHES, reset_launches, resolve_device
from .ops.reachability import (
    chain_step_block,
    commit_step_fused,
    commit_step_plain,
    commit_step_sharded,
)

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


# ------------------------------------------------- the committee-sharded step


def shard_commit_args(rank: int, world: int, fixture, device) -> tuple:
    """Rank ``rank`` of ``world``'s slice of a :func:`commit_fixture`, as
    tensors on ``device``, in :func:`~.ops.reachability.commit_step_sharded`'s
    order: the columns [rank·Nb, (rank+1)·Nb), Nb = ceil(N / world), of
    ``parent``'s last axis (the cited parent) and of ``exists``,
    ``leader_onehot`` and ``stake`` (padded with zeros past N: columns that
    do not exist and hold no stake), ``is_leader_slot`` and
    ``anchor_onehot`` whole, the anchor slot an int."""
    parent, exists, leader_onehot, is_leader_slot, stake, anchor_slot, anchor_onehot = fixture
    n = exists.shape[1]
    nb = -(-n // world)
    lo, hi = min(rank * nb, n), min((rank + 1) * nb, n)

    def cols(a):
        blk = np.zeros(a.shape[:-1] + (nb,), dtype=a.dtype)
        blk[..., : hi - lo] = a[..., lo:hi]
        return torch.from_numpy(blk).to(device)

    def whole(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (cols(parent), cols(exists), cols(leader_onehot), whole(is_leader_slot),
            cols(stake), int(anchor_slot), whole(anchor_onehot))


# Spin-kernel cycles per launch enqueued when timing block launches:
# ~100 µs at the H100's 1.98 GHz, above one wrapper call's host cost.
SPIN_CYCLES_PER_LAUNCH = 200_000


def _bits(t) -> str:
    return np.packbits(t.cpu().numpy().reshape(-1)).tobytes().hex()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dryrun_multichip_impl(rank: int, world: int, device: Optional[str], backend: str,
                           init_method: str, out: str, cases: Sequence[tuple],
                           steps: int = 0) -> None:
    """One rank of :func:`dryrun_multichip`: for each case (seed, W, N,
    anchor slot or None for the fixture's), the sharded step on this rank's
    slice of :func:`commit_fixture`, checked (``support >= 0``, reach of
    shape (W, N), and on rank 0 equal to :func:`~.ops.reachability.commit_step_plain`
    and, on a card, :func:`~.ops.reachability.commit_step_fused` on the
    whole window), then with ``steps`` > 0 timed.  Writes one record per
    case as JSON to ``out``."""
    import torch.distributed as dist

    if device == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        dev = resolve_device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        records = []
        for seed, window, n, anchor in cases:
            fixture = list(commit_fixture(seed, window, n))
            if anchor is not None:
                fixture[5] = anchor
            args = shard_commit_args(rank, world, fixture, dev)
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            support, committed, reach = commit_step_sharded(None, *args, n=n)
            _sync(dev)
            first_ms = 1000 * (time.perf_counter() - t0)
            launches = {k: v for k, v in LAUNCHES.items() if v}
            where = f"seed {seed}, W={window}, N={n}, anchor {fixture[5]}"
            if int(support) < 0 or reach.shape != (window, n):
                raise RuntimeError(f"support {int(support)}, reach {tuple(reach.shape)} "
                                   f"at {where}")
            got = (support, committed, reach)
            if rank == 0:
                whole = [a if isinstance(a, int)
                         else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in fixture]
                oracles = [commit_step_plain] + ([commit_step_fused] if dev.type == "cuda"
                                                 else [])
                for oracle in oracles:
                    want = oracle(*whole)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise RuntimeError(f"sharded != {oracle.__name__} at {where}")
            rec = dict(
                rank=rank, world=world, backend=backend, device=str(dev),
                seed=seed, window=window, committee=n, anchor_slot=fixture[5],
                parent_block=list(args[0].shape), support=int(support),
                committed=int(committed.sum()), reach_cells=int(reach.sum()),
                committed_bits=_bits(committed), reach_bits=_bits(reach),
                launches=launches, first_step_ms=first_ms)
            if steps:
                rec.update(_time_step(args, n, steps, dev))
            records.append(rec)
        with open(out, "w") as f:
            json.dump(records, f)
    finally:
        dist.destroy_process_group()


def _time_step(args, n: int, steps: int, dev) -> dict:
    """Wall ms of one sharded step (``steps`` of them, each rank starting
    together, synchronized), and on a card the device ms of one
    :func:`~.ops.reachability.chain_step_block` launch on this rank's block
    by CUDA events, the ranks timing one after another (ranks that share a
    card would otherwise time each other's contexts)."""
    import torch.distributed as dist

    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        commit_step_sharded(None, *args, n=n)
    _sync(dev)
    out = {"steps_timed": steps,
           "step_wall_ms": 1000 * (time.perf_counter() - t0) / steps,
           "block_step_ms": None}
    k, rank = dist.get_world_size(), dist.get_rank()
    for turn in range(k):
        dist.barrier()
        if turn == rank and dev.type == "cuda" and args[0].shape[0] > 1:
            out["block_step_ms"] = _block_step_ms(*args[:4], k, dev)
    return out


def _block_step_ms(parent, exists, leader, is_lead, k: int, dev) -> float:
    """Device ms of one :func:`~.ops.reachability.chain_step_block` launch
    on a rank's block, by CUDA events around 100 back to back (the slot
    below the top one, from a frontier that holds every row).  A spin
    kernel first holds the stream while the host enqueues them, so the
    events time the launches on the card and not the host's launch rate
    (a launch takes the host longer than the card)."""
    W, _, nb = parent.shape
    prev = torch.zeros((k, 2, nb), dtype=torch.bool, device=dev)
    prev[:, 0] = True
    res = torch.empty((2, nb), dtype=torch.bool, device=dev)
    reps = 100
    for _ in range(3):
        chain_step_block(parent[W - 1], exists[W - 2], leader[W - 2], prev,
                         is_lead[W - 1], out=res)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(SPIN_CYCLES_PER_LAUNCH * reps)
    start.record()
    for _ in range(reps):
        chain_step_block(parent[W - 1], exists[W - 2], leader[W - 2], prev,
                         is_lead[W - 1], out=res)
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def _run_ranks(codes: List[str], workdir: str, *, env=None, cwd=None,
               timeout: float = 600.0) -> List[str]:
    """Run one ``python -c code`` process per rank, all at once, each
    within ``timeout`` seconds; returns each rank's output.  When a rank
    exits non-zero or the time runs out, kills every rank still running
    and raises RuntimeError with every rank's output."""
    procs, logs = [], []
    failed = None
    try:
        for r, code in enumerate(codes):
            logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=logs[-1],
                                          stderr=subprocess.STDOUT, env=env, cwd=cwd))
        deadline = time.monotonic() + timeout
        while failed is None:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {rcs[bad[0]]}"
            elif None not in rcs:
                break
            elif time.monotonic() > deadline:
                failed = f"ranks still running after {timeout} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    if failed is not None:
        raise RuntimeError(f"dryrun_multichip: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{o}" for r, o in enumerate(outputs)))
    return outputs


def dryrun_multichip(n_devices: int, device=None, backend: Optional[str] = None,
                     timeout: float = 600.0, cases: Optional[Sequence[tuple]] = None,
                     steps: int = 0) -> List[List[dict]]:
    """The committee-sharded commit step on ``n_devices`` ranks, one process
    each: the counterpart of the reference's ``dryrun_multichip``.

    ``device``: None (or ``"cuda"``) puts rank r on ``cuda:{r % cards}``
    and raises without a card; ``"cpu"`` runs the ranks on the CPU, the
    kernels' plain twins.  ``backend``: None means ``"nccl"``, which takes
    one card a rank and raises, naming ``backend="gloo"``, when there are
    fewer cards than ranks; ``"gloo"`` runs ranks that share cards (its
    collectives on CUDA tensors stage through host memory) or on the CPU.
    The ranks meet through a ``file://`` store in a temporary directory.

    ``cases``: (seed, W, N, anchor slot or None for the fixture's) for
    each step the ranks run, by default the reference's (seed 1, W = 16,
    N = 4 · ``n_devices``, its anchor).  Each rank checks its result (on
    rank 0 against the unsharded step on the whole window) and, with
    ``steps`` > 0, times ``steps`` more.  Returns per rank its records, one
    a case; raises when a rank fails, when the ranks disagree, or after
    ``timeout`` seconds, and stops every rank first."""
    kind = torch.device("cuda" if device is None else device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"dryrun_multichip: unsupported device {device!r}")
    if kind == "cuda":
        resolve_device(None)  # raises without a card
    backend = "nccl" if backend is None else backend
    if backend == "nccl":
        if kind == "cpu":
            raise ValueError("dryrun_multichip: NCCL runs on cards only; pass "
                             "backend='gloo' for ranks on the CPU")
        cards = torch.cuda.device_count()
        if cards < n_devices:
            raise ValueError(
                f"dryrun_multichip: {n_devices} ranks on {cards} card(s): NCCL "
                "takes one card a rank; pass backend='gloo' for ranks that "
                "share cards")
    elif backend != "gloo":
        raise ValueError(f"dryrun_multichip: unsupported backend {backend!r}")
    cases = tuple(tuple(c) for c in (cases or ((1, 16, 4 * n_devices, None),)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # One host: the ranks' transports stay on the loopback interface.
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="dryrun-multichip-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n_devices)]
        codes = [
            f"import sys; sys.path.insert(0, {root!r}); "
            "from narwhal_tpu_torch.commit_step import _dryrun_multichip_impl; "
            f"_dryrun_multichip_impl({r}, {n_devices}, {kind!r}, {backend!r}, "
            f"{init!r}, {outs[r]!r}, {cases!r}, {int(steps)})"
            for r in range(n_devices)]
        _run_ranks(codes, tmp, env=env, cwd=root, timeout=timeout)
        records = []
        for path in outs:
            with open(path) as f:
                records.append(json.load(f))
    for i, case in enumerate(cases):
        results = {(r[i]["support"], r[i]["committed_bits"], r[i]["reach_bits"])
                   for r in records}
        if len(results) != 1:
            raise RuntimeError(f"dryrun_multichip: the ranks disagree on case {case}")
    return records
