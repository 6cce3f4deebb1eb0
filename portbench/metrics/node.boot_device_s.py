"""Seconds of a primary's boot spent on its device path (``node.boot.*``
gauges in its final snapshot): the kernel library's load, the CUDA
context, the verifier's warm-up at every pad and the consensus kernel's
warm-up; the largest sum over the primaries."""

PHASES = ("node.boot.library_seconds", "node.boot.cuda_context_seconds",
          "node.boot.verify_warmup_seconds", "node.boot.consensus_warmup_seconds")


def read(obs):
    sums = [sum(gauges.get(p) or 0.0 for p in PHASES)
            for gauges in (s.get("gauges") or {} for n, s in obs.final.items()
                           if n.startswith("primary"))
            if any(p in gauges for p in PHASES)]
    return max(sums) if sums else None
