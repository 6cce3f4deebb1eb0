"""The transport seam: who provides Receiver/SimpleSender/ReliableSender.

By default nobody — the three concrete TCP classes in this package build
themselves and this module is a single ``is None`` check on their
construction paths (zero cost for normal runs, same pattern as
``faults/netem.py``).  The deterministic simulation harness
(``narwhal_tpu/sim/transport.py``) installs an in-memory transport here
before booting a committee, and every ``Receiver.spawn(...)``,
``SimpleSender()``, ``ReliableSender()`` and BatchMaker client-socket
bind in the process routes through seeded in-process queues instead of
the kernel — the FoundationDB-style INetwork swap, at the seam the
reference architecture already isolates (SURVEY.md §2.4: inter-authority
traffic is a replaceable byte transport, never a device collective).

An installed transport must provide:

- ``spawn_receiver(address, handler, classify) -> receiver`` — an object
  with ``shutdown()`` (coroutine) and ``port``;
- ``simple_sender()`` / ``reliable_sender()`` — drop-in counterparts of
  the TCP senders (same ``send``/``broadcast``/``lucky_broadcast``/
  ``close`` surface; reliable futures resolve with the peer's ACK);
- ``create_tx_server(address, protocol_factory) -> server`` — the
  client-transaction ingress bind (an object with ``close()``), fed by
  the harness's in-memory clients.
"""

from __future__ import annotations

from typing import Optional

_ACTIVE: Optional[object] = None


def install(transport: Optional[object]) -> None:
    """Install (or with ``None`` clear) the process's active transport.
    The simulation harness brackets every run with install/uninstall so
    ordinary code never sees a stale transport."""
    global _ACTIVE
    _ACTIVE = transport


def active() -> Optional[object]:
    """The installed transport, or None (the TCP default)."""
    return _ACTIVE


def reset() -> None:
    install(None)
