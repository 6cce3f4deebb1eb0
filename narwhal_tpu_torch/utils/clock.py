"""``loop_now()`` / ``wall_now()`` — the protocol plane's two clocks.

Every age/retry/deadline computation that lives ON the event loop reads
``loop_now()`` instead of ``time.monotonic()``.  In production the two
are the same clock (asyncio's default ``loop.time()`` IS
``time.monotonic()``), so this is a pure refactor there — but under the
deterministic simulation harness (``narwhal_tpu/sim``) the running loop
is a :class:`~narwhal_tpu.sim.clock.VirtualClockLoop` whose ``time()``
advances only at quiesce, and every retry window, sync age and wedge
timer rides the simulated clock with it.  A wall-clock read left behind
in a retry path would measure ~zero elapsed time across a 60-virtual-
second scenario and silently disable that path in simulation.

Callers off the loop (metrics snapshot threads) fall back to
``time.monotonic()`` — consistent in production, and simulation runs
everything on the one loop so the fallback never fires there.

``wall_now()`` is the TIMESTAMP clock: what gets written into trace
stamps and ACK payloads so cross-node joins can compare times.  In
production it is ``time.time()`` untouched.  The simulation installs a
virtual base (``set_wall_base``) so stamps are deterministic, and each
sim node may run inside a ``skew_scope`` — a contextvar offset modeling
that node's wall clock running ahead/behind true time.  The skew-
injection regression arm exists BECAUSE the two clocks differ: cross-
node comparisons of raw ``wall_now()`` stamps are only valid after the
clocksync offset correction (benchmark/metrics_check.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import time
from typing import Callable, Iterator, Optional

_wall_base: Optional[Callable[[], float]] = None
_wall_skew: contextvars.ContextVar[float] = contextvars.ContextVar(
    "narwhal_wall_skew", default=0.0
)


def loop_now() -> float:
    """The running event loop's time, or ``time.monotonic()`` when called
    outside any loop (snapshot/scrape threads)."""
    try:
        return asyncio.get_running_loop().time()
    except RuntimeError:
        return time.monotonic()


def wall_now() -> float:
    """Epoch-style timestamp as THIS node's wall clock reads it: the
    installed base clock (``time.time()`` in production, the virtual
    loop clock under sim) plus the current context's injected skew."""
    base = _wall_base() if _wall_base is not None else time.time()
    return base + _wall_skew.get()


def set_wall_base(fn: Optional[Callable[[], float]]) -> None:
    """Install (or, with None, remove) the base wall clock.  The sim
    harness points this at its virtual loop's ``time()`` so every stamp
    is deterministic per (seed, spec); production never calls it."""
    global _wall_base
    _wall_base = fn


def current_skew() -> float:
    """The wall-clock skew (seconds) injected into the current context."""
    return _wall_skew.get()


@contextlib.contextmanager
def skew_scope(offset_s: float) -> Iterator[None]:
    """Run the enclosed code with ``wall_now()`` shifted by ``offset_s``
    seconds — the per-node virtual clock offset of the sim's skew-
    injection arm.  Contextvar-scoped, so tasks spawned inside inherit
    the node's skew and tasks outside are untouched."""
    token = _wall_skew.set(_wall_skew.get() + offset_s)
    try:
        yield
    finally:
        _wall_skew.reset(token)
