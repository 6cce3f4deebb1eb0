#!/usr/bin/env python3
"""Times one tree's verify launcher of this repository on one GPU, with
this checkout's measuring code (``chip_smoke.py``).

- The batch split over two shards on the card at B = 2048
  (``verify_sharded`` on the nine prep arrays): ms by CUDA events around
  the call, and host ms per call.
- The single-card verify from the nine prep arrays at pads 16, 32, 64,
  2,048 and 16,384: in trees with the staged launcher, one shard of
  ``verify_sharded``; in older trees what ``verify_batch_arrays`` did
  after its prep (``to_device``, the launch, the mask's ``.cpu()``).
  Host ms per call.
- The single-card verify from the rows, host prep included
  (``verify_batch_arrays`` with the card named), at the same pads, and
  beside it the host prep alone (``prepare_batch`` into new arrays).
  Host ms per call.
- With ``--node``, the ``node`` phase of ``chip_smoke.py`` (ten validators
  through that tree's node CLI) with that tree's package.

Every mask must equal the single launch's.  Prints one JSON line last.
Two trees are compared only within one call on one card, in turns:

    python3 verify_ab.py build/parent   # e.g. a git archive of the parent
    python3 verify_ab.py .

Needs one CUDA GPU; exits non-zero without one.
"""

from __future__ import annotations

import importlib.util
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PADS = (16, 32, 64, 2048, 16384)


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--node"]
    tree = os.path.abspath(args[0] if args else HERE)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("verify_ab: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from narwhal_tpu_torch import ops
    from narwhal_tpu_torch.ops import ed25519 as E

    assert ops.__file__.startswith(tree + os.sep), ops.__file__
    ops.library()
    device = ops.resolve_device(None)
    torch.cuda.set_device(device)
    staged = hasattr(E, "stage_layout")
    rng = random.Random(cs.SEED)
    keys, committee = cs.make_committee(cs.N_COMMITTEE)
    signed = cs.signed_rounds(keys, committee, 2, rng)
    rows, _ = cs.verify_rows(signed, keys, cs.VERIFY_BATCH, rng)
    rows = rows * (max(PADS) // len(rows))
    mismatches = 0

    def single(prep):
        if staged:
            return E.verify_sharded(prep, [device])
        return E.verify_kernel(*E.to_device(prep, device)).cpu().numpy()

    def host_ms(fn, iters):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1000 * (time.perf_counter() - t0) / iters

    pads = []
    for pad in PADS:
        cols = list(zip(*rows[:pad]))
        prep = E.prepare_batch(*cols, pad)
        want = E.verify_kernel(*E.to_device(prep, device)).cpu().numpy()
        mismatches += int((single(prep) != want).sum())
        mismatches += int((E.verify_batch_arrays(*cols, device=device) != want).sum())
        iters = 10 if pad >= 2048 else 100
        pads.append(dict(
            rows=pad,
            from_prep_host_ms=[host_ms(lambda: single(prep), iters) for _ in range(2)],
            from_rows_host_ms=[host_ms(lambda: E.verify_batch_arrays(*cols, device=device),
                                       iters) for _ in range(2)],
            prep_host_ms=[host_ms(lambda: E.prepare_batch(*cols, pad), iters)
                          for _ in range(2)]))
        if pad == cs.VERIFY_BATCH:
            split = E.verify_sharded(prep, [device, device])
            mismatches += int((split != want).sum())
            two_shards = dict(
                rows=pad,
                ms=[cs.cuda_ms(lambda: E.verify_sharded(prep, [device, device]), 10)
                    for _ in range(2)],
                host_ms_per_call=[cs.host_ms(lambda: E.verify_sharded(
                    prep, [device, device]), 10) for _ in range(2)])
    assert mismatches == 0, mismatches
    node = None
    if "--node" in sys.argv[1:]:
        # That tree's package in the children, this checkout's runner.
        cs.HERE = tree
        cs.NODE_WORKDIR = os.path.join(tree, "build", "node_phase")
        node = cs.phase_node()
        node = {k: node[k] for k in (
            "consensus_tps", "consensus_latency_ms", "end_to_end_tps",
            "end_to_end_latency_ms", "compute_mode", "primaries", "wall_s")}
    cs.emit(dict(tree=tree, staged=staged, mismatches=mismatches,
                 two_shards=two_shards, single=pads, node=node,
                 nvidia_smi=cs.nvidia_smi_line()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
