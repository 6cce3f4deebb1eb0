"""Fault injection: Byzantine primaries, crash/restart, WAN emulation.

Three planes, all declarative and seeded (``NARWHAL_FAULT_SEED``):

- :mod:`narwhal_tpu.faults.spec` — the scenario schema
  (benchmark/scenarios/*.json → :class:`FaultScenario`);
- :mod:`narwhal_tpu.faults.netem` — per-peer-pair latency/jitter/loss and
  time-windowed partitions injected at the ``network/`` seam;
- :mod:`narwhal_tpu.faults.byzantine` — ``ByzantineCore`` /
  ``ByzantineProposer`` (equivocation, rogue-key signatures, vote
  withholding, stale-certificate replay), wired by ``node --fault-plan``;
- :mod:`narwhal_tpu.faults.byzantine_worker` — the worker-plane
  availability attacks (batch withholding, garbage serving, sync
  flooding), wired by the same ``--fault-plan`` on the worker role;
- :mod:`narwhal_tpu.faults.fuzz` — seeded scenario generation: one seed
  → one replayable scenario-spec dict, replayed by fault_bench's
  ``--fuzz-seed``.

This ``__init__`` deliberately imports only the leaf modules with no
in-package dependencies: ``network/`` imports :mod:`netem` for its hooks,
and :mod:`byzantine` imports ``primary/`` — eagerly importing it here
would close an import cycle.  Import ``narwhal_tpu.faults.byzantine``
directly where needed.
"""

from . import netem  # noqa: F401
from .spec import (  # noqa: F401
    BYZANTINE_BEHAVIORS,
    FaultScenario,
    SpecError,
    load_scenario,
    parse_scenario,
)
