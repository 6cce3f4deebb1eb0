"""narwhal-sim: deterministic committee-at-scale simulation.

ROADMAP item 6 (FoundationDB-style simulation testing), built by fusing
three existing subsystems:

- the **virtual clock** (:mod:`.clock`): an
  :class:`~narwhal_tpu.analysis.schedule.ExploringEventLoop` subclass
  whose ``time()`` runs on simulated seconds — when every task quiesces,
  the clock JUMPS to the next timer instead of sleeping, so a 60-second
  scenario executes in well under a second of wall time while every
  retry window, health-rule rate and netem delay keeps its declared
  semantics;
- the **in-memory transport** (:mod:`.transport`): drop-in
  Receiver/SimpleSender/ReliableSender counterparts behind the
  ``network/transport.py`` seam, routing frames through seeded
  in-process queues with ``faults/netem.py``-semantics per-pair
  latency/jitter/loss/partitions compiled into virtual-time
  ``call_later`` delays;
- the **committee builder + judge** (:mod:`.committee`): boots every
  primary and worker of an N=4..50 committee on ONE exploring loop with
  in-memory stores, drives a fault scenario (byzantine plans, WAN
  shaping, crash/restart) through it, and judges the run with the
  existing three-verdict engine — golden-oracle audit replay
  (``consensus/replay.py``, the arXiv:2407.02167 invariants),
  payload-commit liveness in virtual time, and health-rule detection.

``benchmark/sim_bench.py`` sweeps (seed × fuzzed fault spec × committee
size) through :func:`run_sim_scenario` — thousands of explored points
per CI run, every divergence dumped as a replayable ``(seed, spec)``
repro file.
"""

from .clock import VirtualClockLoop, run_virtual
from .committee import run_sim_scenario
from .transport import SimTransport

__all__ = [
    "VirtualClockLoop",
    "run_virtual",
    "run_sim_scenario",
    "SimTransport",
]
