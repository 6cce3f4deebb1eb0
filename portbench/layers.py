"""What the per-layer readers read: one run's observations.

A reader (``metrics/<metric>.py``) is a module with ``read(obs)`` that
returns the metric's value, or ``None`` where the run gave it nothing to
read; the harness then leaves the metric out of the line.  ``obs`` is an
:class:`Observations`.
"""

from __future__ import annotations

import importlib.util
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Published H100 SXM peak for 32-bit integer multiply-adds: 64 INT32 lanes
# per SM (half the 128 FP32 lanes) × 132 SMs × 1.98 GHz (NVIDIA's data
# sheet), at the full 700 W.
INT32_MADS_PER_S = 64 * 132 * 1.98e9
# One ed25519 verification as the verifier's field arithmetic counts it
# (10 limbs of 25.5 bits: a multiply is 100 multiply-adds, a square 55):
# 3,937 field multiplies of which 1,558 are squares.
FIELD_MULS_PER_VERIFY = 3937
FIELD_SQS_PER_VERIFY = 1558
MADS_PER_VERIFY = ((FIELD_MULS_PER_VERIFY - FIELD_SQS_PER_VERIFY) * 100
                   + FIELD_SQS_PER_VERIFY * 55)


@dataclass
class Observations:
    window: Tuple[float, float]
    # [worker, burst, due, sent] of every sample due in the window
    samples: List[Tuple[int, int, float, float]] = field(default_factory=list)
    # seconds from each node's spawn to its last boot line
    boot_s: Dict[str, float] = field(default_factory=dict)
    # {node: (snapshot at the window's start, snapshot at its end)}
    snapshots: Dict[str, Tuple[dict, dict]] = field(default_factory=dict)
    # {node: its final snapshot, written at shutdown}
    final: Dict[str, dict] = field(default_factory=dict)
    # (time, utilization %, memory MiB) from the card's sampler
    nvml: List[Tuple[float, float, float]] = field(default_factory=list)
    # why the window's samples that never committed were lost, from the
    # stores (``reference.judge.judge``'s ``diag``); empty before the judge
    lost: Dict[str, int] = field(default_factory=dict)

    def nodes(self, role: str) -> List[str]:
        return [n for n in self.snapshots if n.startswith(role)]

    def hist(self, role: str, name: str) -> Tuple[int, float]:
        """(count, sum) a histogram gained over the window, all nodes of
        ``role`` together."""
        count, total = 0, 0.0
        for n in self.nodes(role):
            a, b = (s["histograms"].get(name, {"count": 0, "sum": 0.0})
                    for s in self.snapshots[n])
            count += b["count"] - a["count"]
            total += b["sum"] - a["sum"]
        return count, total

    def counter(self, role: str, name: str) -> float:
        return sum(b["counters"].get(name, 0) - a["counters"].get(name, 0)
                   for a, b in (self.snapshots[n] for n in self.nodes(role)))

    def counters_like(self, role: str, prefix: str) -> Dict[str, float]:
        names = {k for n in self.nodes(role) for s in self.snapshots[n]
                 for k in s["counters"] if k.startswith(prefix)}
        return {k: self.counter(role, k) for k in sorted(names)}

    def window_nvml(self) -> List[Tuple[float, float, float]]:
        lo, hi = self.window
        return [row for row in self.nvml if lo <= row[0] < hi]


def mean_ms(count: int, total: float) -> Optional[float]:
    return 1000.0 * total / count if count > 0 else None


def reader(directory: str, metric: str):
    """The ``read`` function of ``<directory>/<metric>.py``."""
    path = os.path.join(directory, metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def finite(x: Optional[float]) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None
