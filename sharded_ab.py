#!/usr/bin/env python3
"""Times the committee-sharded commit step of one tree of this repository
on one GPU, with this checkout's measuring code (``chip_smoke.py``).

- The slot kernels by CUDA events behind a spin kernel, on rank 0's block
  of four at (seed, W, N) = (1, 16, 16), the flagship's (0, 64, 50) and
  (2, 8, 1024): the slot below the top one from a whole frontier and the
  top slot (``commit_step_block``), or in trees before it
  ``chain_step_block`` from a whole frontier and ``support_votes_block``.
- The step's wall ms in an NCCL world of one rank at the same three
  shapes: where the tree captures the step as a CUDA graph, eager and
  graph in turns (eager, graph, graph, eager).

Prints one JSON line last.  Two trees are compared only within one call
on one card, in turns:

    python3 sharded_ab.py build/parent   # e.g. a git archive of the parent
    python3 sharded_ab.py .

Needs one CUDA GPU; exits non-zero without one.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, tree)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("sharded_ab: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from narwhal_tpu_torch import ops
    from narwhal_tpu_torch.commit_step import commit_fixture, shard_commit_args
    from narwhal_tpu_torch.ops import reachability as R

    assert ops.__file__.startswith(tree + os.sep), ops.__file__
    ops.library()
    device = ops.resolve_device(None)
    torch.cuda.set_device(device)
    new = hasattr(R, "commit_step_block")
    shapes = ((1, 16, 16), (0, 64, 50), (2, 8, 1024))
    kernels = []
    for seed, W, N in shapes:
        k = 4
        nb = -(-N // k)
        blk = shard_commit_args(0, k, commit_fixture(seed, W, N), device)
        row = dict(window=W, committee=N, ranks=k, block_cols=nb)
        if new:
            anchor = torch.tensor(W - 1, dtype=torch.int32, device=device)
            packed = torch.empty(R.packed_words(W, N, nb), dtype=torch.int32, device=device)
            prev = torch.zeros((k, R.record_words(N, nb)), dtype=torch.int32, device=device)
            prev[:, : -(-nb // 32)] = R.pack_bits(
                torch.ones((k, nb), dtype=torch.bool, device=device))
            args = (*blk[:5], anchor, blk[6])
            row["top_ms"] = cs.cuda_ms(lambda: R.commit_step_block(
                W - 1, *args, None, packed, rank=0, k=k), 100, prefill=True)
            row["slot_whole_frontier_ms"] = cs.cuda_ms(lambda: R.commit_step_block(
                W - 2, *args, prev, packed, rank=0, k=k), 100, prefill=True)
        else:
            prev = torch.zeros((k, 2, nb), dtype=torch.bool, device=device)
            prev[:, 0] = True
            row["slot_whole_frontier_ms"] = cs.cuda_ms(lambda: R.chain_step_block(
                blk[0][W - 1], blk[1][W - 2], blk[2][W - 2], prev, blk[3][W - 1]),
                100, prefill=True)
            s = W - 1
            row["votes_ms"] = cs.cuda_ms(lambda: R.support_votes_block(blk[0][s], blk[2][s]),
                                      100, prefill=True)
        kernels.append(row)
    steps = []
    with tempfile.TemporaryDirectory(prefix="sharded-ab-") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            for seed, W, N in shapes:
                args = shard_commit_args(0, 1, commit_fixture(seed, W, N), device)

                def timed(**kw):
                    t0 = time.perf_counter()
                    for _ in range(20):
                        R.commit_step_sharded(None, *args, n=N, **kw)
                    torch.cuda.synchronize()
                    return 1000 * (time.perf_counter() - t0) / 20

                modes = ({"eager": dict(graph=False), "graph": dict(graph=True)} if new
                         else {"eager": {}})
                for kw in modes.values():
                    timed(**kw)  # warm-up (and the graph's capture)
                order = ("eager", "graph", "graph", "eager") if new else ("eager",) * 2
                row = dict(window=W, committee=N, ranks=1)
                for mode in order:
                    row.setdefault(f"step_{mode}_ms", []).append(timed(**modes[mode]))
                steps.append(row)
        finally:
            dist.destroy_process_group()
    cs.emit(dict(tree=tree, commit_step_block=new, kernels=kernels, nccl_one_rank=steps,
              nvidia_smi=cs.nvidia_smi_line()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
