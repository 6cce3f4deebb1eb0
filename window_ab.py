#!/usr/bin/env python3
"""Times the commit path's window upkeep of one tree of this repository on
one GPU, with this checkout's measuring code (``chip_smoke.py``).  The
tree's window is either a mirrored ring (``window_update``: the shift
moves the ring's origin, and the next launch zeroes the retired slots and
applies the flush) or, in trees before it, a plain window shifted by the
out-of-place ``window_shift`` kernel and flushed by ``window_apply``.

- At (W, N) = (64, 50), (64, 200) and (8, 1024), device time by CUDA
  events of a shift by 2 (the ring: the launch that clears the retired
  slots; before it: ``window_shift``), of a steady commit opportunity's
  flush, and of both (the ring: one launch; before it: the two launches
  back to back).
- The N=50 main path of ``chip_smoke.py`` run on the tree's package
  (its JSON line is printed too), for "ms per commit": the commit
  opportunity plus the shift after the commit, on the host clock.

Prints one JSON line last.  Two trees are compared only within one call
on one card, in turns:

    python3 window_ab.py build/parent   # e.g. a git archive of the parent
    python3 window_ab.py .

Needs one CUDA GPU; exits non-zero without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("window_ab: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from narwhal_tpu_torch import ops
    from narwhal_tpu_torch.ops import reachability as R

    assert ops.__file__.startswith(tree + os.sep), ops.__file__
    ops.library()
    device = ops.resolve_device(None)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ring = hasattr(R, "window_update")
    nrng = np.random.default_rng(cs.SEED + 2)
    shapes = []
    for W, N in cs.UPDATE_SHAPES:
        e_np, p_np = cs.causal_window(nrng, W, N)
        flush = [dev(a) for a in cs.commit_flush(nrng, W, N, cs.UPDATE_ROWS)]
        if ring:
            e2, p2 = dev(np.concatenate([e_np, e_np])), dev(np.concatenate([p_np, p_np]))
            o = W - 1

            def shift():
                R.window_update(e2, p2, None, window=W, origin=o, retired=2,
                                clear_slot0=True)

            def apply():
                R.window_update(e2, p2, flush, window=W, origin=o)

            def both():
                R.window_update(e2, p2, flush, window=W, origin=o, retired=2,
                                clear_slot0=True)
        else:
            e, p = dev(e_np), dev(p_np)
            oe, op = torch.empty_like(e), torch.empty_like(p)

            def shift():
                R.window_shift(e, p, 2, oe, op)

            def apply():
                R.window_apply(e, p, *flush)

            def both():
                apply()
                shift()
        shapes.append(dict(
            window=W, committee=N,
            ms_shift=cs.cuda_ms(shift, 100, prefill=True),
            ms_flush=cs.cuda_ms(apply, 100, prefill=True),
            ms_both=cs.cuda_ms(both, 100, prefill=True)))

    rng = random.Random(cs.SEED)
    keys, committee = cs.make_committee(cs.N_COMMITTEE)
    signed = cs.signed_rounds(keys, committee, cs.SIGNED_ROUNDS, rng)
    main_path = cs.phase_main_path(keys, committee, signed, rng)
    cs.emit(dict(
        tree=os.path.relpath(tree, HERE), window="ring" if ring else "shift_kernel",
        nvidia_smi=cs.nvidia_smi_line(), shapes=shapes,
        **{k: main_path[k] for k in (
            "commit_opportunities", "ms_per_commit_opportunity",
            "ms_flush_per_commit_opportunity", "ms_shift_per_commit_opportunity",
            "ms_per_commit", "launches_per_commit_opportunity", "committed")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
