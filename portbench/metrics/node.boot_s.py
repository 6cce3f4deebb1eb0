"""Seconds from a node process's spawn to its last boot line (a primary's
``Verify backend cuda ready``, ``Consensus kernel ready`` and
``successfully booted``; a worker's ``successfully booted``), the
slowest node of the committee."""


def read(obs):
    return max(obs.boot_s.values()) if obs.boot_s else None
