"""The virtual clock: simulated time over the exploring event loop.

:class:`VirtualClockLoop` subclasses
:class:`~narwhal_tpu.analysis.schedule.ExploringEventLoop` (so every run
keeps the seeded same-tick schedule exploration) and replaces the loop's
clock with a simulated one:

- ``time()`` returns the virtual now — every ``loop.time()`` deadline,
  ``call_later`` timer, ``asyncio.sleep`` and ``wait_for`` in the
  process rides it, as do the protocol's retry/age computations since
  they read :func:`narwhal_tpu.utils.clock.loop_now`;
- at the top of every tick, if NO callback is ready and at least one
  timer is scheduled, the clock JUMPS to the earliest timer's deadline
  instead of letting the selector sleep — quiesce costs microseconds of
  wall time, whatever the virtual gap.  While anything is runnable the
  clock holds still, so CPU-bound protocol work executes exactly as it
  would under a schedule where the host is infinitely fast (the
  FoundationDB simulation contract: virtual time advances only at
  quiesce points).

Two safety knobs (declared in the typed env registry):

- ``NARWHAL_SIM_COMPRESSION_CAP`` — ceiling on a single quiesce jump in
  virtual seconds.  A forgotten far-future timer then advances the clock
  in bounded, *non-blocking* steps (the loop re-arms itself with a
  no-op callback) instead of swallowing the whole scenario in one leap.
- ``NARWHAL_SIM_MAX_VIRTUAL_S`` — ceiling on a run's total virtual
  duration, enforced by :func:`run_virtual` as a virtual-time
  ``wait_for`` so a livelocked scenario terminates with a diagnosable
  timeout instead of spinning forever.

Determinism: the jump rule is a pure function of the loop's own timer
heap, the no-op re-arm callbacks are plain-function handles the
explorer never permutes, and nothing here reads the wall clock except
the run stats — same seed, same workload → same tick sequence, same
virtual timestamps, byte-identical outcomes.
"""

from __future__ import annotations

import heapq
import time as _wall
from typing import Any, Callable, Coroutine, Optional

from ..analysis.schedule import ExploringEventLoop, _cancel_pending
from ..utils.env import env_float

__all__ = ["VirtualClockLoop", "run_virtual"]

_JUMP_CAP_DEFAULT = 60.0


def _noop() -> None:
    """Re-arm callback for capped jumps: keeps the selector non-blocking
    so the next tick can continue advancing the clock."""


class _ThriftySelector:
    """Selector wrapper that elides most zero-timeout polls.

    A simulated committee's loop runs tens of thousands of ticks whose
    selector poll can never return anything (all I/O is in-memory), yet
    each ``select(0)`` is a real ``epoll_wait`` syscall — on sandboxed
    hosts with intercepted syscalls (~50 µs each here) that was the #1
    cost of a shaped N=20 run.  Zero-timeout polls are answered with an
    empty event list except every 64th (so the self-pipe — the only
    registered fd, carrying cross-thread wakeups — is still drained
    regularly); blocking polls (timeout None/positive) always hit the
    real selector, so genuine waits keep their semantics.  The skip
    counter is deterministic: same workload, same polls skipped."""

    __slots__ = ("_inner", "_zeros")

    def __init__(self, inner) -> None:
        self._inner = inner
        self._zeros = 0

    def select(self, timeout=None):
        if timeout == 0:
            self._zeros += 1
            if self._zeros % 64:
                return []
        return self._inner.select(timeout)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class VirtualClockLoop(ExploringEventLoop):
    """Exploring event loop on simulated time (see module docstring).

    ``jumps`` counts quiesce advances, ``virtual_elapsed()`` the total
    simulated seconds — together with the harness's wall measurement
    they are the compression-ratio witness the sim artifact reports.
    """

    def __init__(
        self,
        seed: int,
        start: float = 0.0,
        max_jump_s: Optional[float] = None,
    ) -> None:
        super().__init__(seed)
        self._sim_now = float(start)
        self._sim_start = float(start)
        self._max_jump = (
            float(env_float("NARWHAL_SIM_COMPRESSION_CAP", _JUMP_CAP_DEFAULT))
            if max_jump_s is None
            else float(max_jump_s)
        )
        self.jumps = 0
        self.capped_jumps = 0
        self._selector = _ThriftySelector(self._selector)

    def time(self) -> float:  # noqa: D401 (asyncio clock hook)
        return self._sim_now

    def virtual_elapsed(self) -> float:
        return self._sim_now - self._sim_start

    def _run_once(self) -> None:
        if not self._ready and not self._stopping and self._scheduled:
            # Drop cancelled heads first: a dead timer must not absorb
            # the jump (the base loop would pop it immediately anyway,
            # but only AFTER computing a select timeout from it).
            while self._scheduled and self._scheduled[0]._cancelled:
                handle = heapq.heappop(self._scheduled)
                handle._scheduled = False
                self._timer_cancelled_count -= 1
            if self._scheduled:
                when = self._scheduled[0]._when
                gap = when - self._sim_now
                if gap > 0:
                    if 0 < self._max_jump < gap:
                        self._sim_now += self._max_jump
                        self.capped_jumps += 1
                        # Keep select(timeout) at zero: with nothing
                        # ready and the head timer still in the future,
                        # the base loop would otherwise sleep the
                        # REMAINING gap in wall time.
                        self.call_soon(_noop)
                    else:
                        self._sim_now = when
                    self.jumps += 1
        super()._run_once()


def run_virtual(
    main: Callable[[], Coroutine],
    seed: int,
    max_virtual_s: Optional[float] = None,
    start: float = 0.0,
    wall_timeout_s: float = 600.0,
) -> Any:
    """``asyncio.run`` under a :class:`VirtualClockLoop`; returns
    ``(result, stats)`` where ``stats`` carries the schedule counters of
    :func:`~narwhal_tpu.analysis.schedule.run_with_seed` plus the
    virtual/wall split (``virtual_s``, ``wall_s``, ``compression``,
    ``jumps``).

    ``max_virtual_s`` (default ``NARWHAL_SIM_MAX_VIRTUAL_S``) bounds the
    run in VIRTUAL seconds via ``wait_for`` — on the virtual clock a
    deadlocked or livelocked scenario reaches the bound near-instantly
    in wall terms, so the guard is deterministic: the same seed always
    times out at the same virtual instant with the same state.

    ``wall_timeout_s`` is the last-resort backstop the virtual guard
    cannot provide: a BUSY livelock (a task that never quiesces, e.g. a
    ``sleep(0)`` spin) keeps the clock from ever advancing, so the
    virtual deadline never becomes due — after this many WALL seconds a
    timer thread cancels the run (surfaced as CancelledError), turning
    an indefinite hang into a failure with the seed attached.  It is
    deliberately far above any legitimate run and only nondeterministic
    on runs that would otherwise never finish.  0 disables it."""
    import asyncio
    import threading

    if max_virtual_s is None:
        max_virtual_s = float(env_float("NARWHAL_SIM_MAX_VIRTUAL_S", 600.0))
    loop = VirtualClockLoop(seed, start=start)
    wall0 = _wall.perf_counter()

    # Running-loop lookup pin.  Every get_running_loop() does a C-level
    # getpid() (fork protection) — a real syscall that sandboxed hosts
    # (gVisor-style interception; this container measures ~20 µs per
    # getpid) turn into the single largest per-message cost of a
    # simulated committee: queues, sleeps, futures and the protocol's
    # own call sites all route through it, six-figure call counts per
    # run.  Inside run_virtual exactly ONE loop can ever be running, so
    # the lookup is pinned to it for the duration and restored after.
    import asyncio.events as _events

    def _pinned_get_running_loop() -> "asyncio.AbstractEventLoop":
        # _thread_id is BaseEventLoop's own "am I running" marker — an
        # attribute read, not a syscall.
        if loop._thread_id is not None:
            return loop
        raise RuntimeError("no running event loop")

    def _pinned_peek_running_loop():
        return loop if loop._thread_id is not None else None

    saved = (
        asyncio.get_running_loop,
        _events.get_running_loop,
        _events._get_running_loop,
    )
    try:
        asyncio.get_running_loop = _pinned_get_running_loop  # type: ignore
        _events.get_running_loop = _pinned_get_running_loop  # type: ignore
        _events._get_running_loop = _pinned_peek_running_loop  # type: ignore
        asyncio.set_event_loop(loop)
        coro = main()
        if max_virtual_s and max_virtual_s > 0:
            coro = asyncio.wait_for(coro, max_virtual_s)
        task = loop.create_task(coro)
        backstop: Optional[threading.Timer] = None
        if wall_timeout_s and wall_timeout_s > 0:
            backstop = threading.Timer(
                wall_timeout_s,
                # call_soon_threadsafe lands in the ready queue even
                # mid-spin, so the cancel reaches a busy livelock too.
                lambda: loop.call_soon_threadsafe(task.cancel),
            )
            backstop.daemon = True
            backstop.start()
        try:
            result = loop.run_until_complete(task)
        finally:
            if backstop is not None:
                backstop.cancel()
        wall_s = _wall.perf_counter() - wall0
        virtual_s = loop.virtual_elapsed()
        return result, {
            "seed": seed,
            "ticks": loop.ticks,
            "permutations": loop.permutations,
            "jumps": loop.jumps,
            "capped_jumps": loop.capped_jumps,
            "virtual_s": round(virtual_s, 6),
            "wall_s": round(wall_s, 6),
            "compression": (
                round(virtual_s / wall_s, 2) if wall_s > 0 else None
            ),
        }
    finally:
        try:
            _cancel_pending(loop)
            loop.run_until_complete(loop.shutdown_asyncgens())
            # Same rationale as schedule.run_with_seed: join the default
            # executor so no thread survives into the next seeded run.
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            (
                asyncio.get_running_loop,
                _events.get_running_loop,
                _events._get_running_loop,
            ) = saved  # type: ignore
            asyncio.set_event_loop(None)
            loop.close()
