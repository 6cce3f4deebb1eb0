"""Event-loop stall watchdog — the runtime half of the invariant suite.

The static ``no-blocking-in-async`` rule bans the blocking-call shapes we
know about; this watchdog measures the ones we don't.  The paper's whole
latency story rides on the primary's single asyncio loop never stalling
(the round period is pure critical path — r10 attribution), so "the loop
never blocks" must be a MEASURED property, not an inferred one.

Mechanism (opt-in via ``NARWHAL_LOOP_WATCHDOG_MS``):

- a heartbeat task on the watched loop stamps a monotonic timestamp
  every ``interval`` seconds.  When a beat arrives LATE, the loop was
  held by something — the overshoot beyond the scheduled interval is the
  stall length, observed into the ``runtime.loop_stall_seconds``
  histogram (plus the ``runtime.loop_stalls`` counter);
- a daemon thread watches the same timestamp from outside.  The moment
  the gap crosses the threshold it captures the LOOP thread's current
  stack via ``sys._current_frames()`` — i.e. a stack excerpt from
  *inside* the stall, naming the blocking callee — logs it, and parks it
  in the ``runtime.loop_stall_last`` snapshot detail.  The loop itself
  cannot log while wedged; the thread can (same stance as the
  ``NARWHAL_FAULTHANDLER_S`` C-level dumper, but scoped, rate-limited
  and joined to the metrics plane);
- ``loop.slow_callback_duration`` is aligned to the threshold so asyncio
  debug mode (when enabled) agrees with the watchdog about what "slow"
  means.

Cost when enabled: one trivial task wakeup per interval on the loop plus
one daemon thread — cheap enough for a bench smoke arm, still opt-in for
production defaults.
"""

from __future__ import annotations

import asyncio
import logging
import sys
import threading
import time
import traceback
from typing import Optional

from .. import metrics
from ..utils.env import env_int
from ..utils.tasks import spawn

log = logging.getLogger("narwhal.watchdog")

_STACK_LIMIT = 12  # frames kept in the excerpt


class LoopWatchdog:
    """Watch one event loop for callbacks that hold it past ``threshold_s``."""

    def __init__(self, threshold_s: float, interval_s: Optional[float] = None):
        self.threshold_s = threshold_s
        # Beat fast enough that the measured overshoot approximates the
        # true stall length, slow enough to stay off the hot path.
        self.interval_s = (
            interval_s if interval_s is not None else max(threshold_s / 4, 0.005)
        )
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._loop_thread_id: Optional[int] = None
        self._task: Optional[asyncio.Task] = None
        self._thread: Optional[threading.Thread] = None
        self._last_stall: dict = {}
        self._stack_captured = False
        self._m_stalls = metrics.counter("runtime.loop_stalls")
        self._m_stall_s = metrics.histogram("runtime.loop_stall_seconds")
        metrics.detail_fn("runtime.loop_stall_last", lambda: self._last_stall)

    def start(self) -> "LoopWatchdog":
        loop = asyncio.get_running_loop()
        # Align asyncio's own slow-callback notion (used when loop debug
        # mode is on) with the watchdog threshold.
        loop.slow_callback_duration = self.threshold_s
        self._loop_thread_id = threading.get_ident()
        self._last_beat = time.monotonic()
        self._task = spawn(self._beat(), name="loop-watchdog-beat")
        self._thread = threading.Thread(
            target=self._watch, name="loop-watchdog", daemon=True
        )
        self._thread.start()
        log.info(
            "Loop-stall watchdog armed: threshold %.0f ms, beat %.0f ms",
            self.threshold_s * 1000, self.interval_s * 1000,
        )
        return self

    async def shutdown(self) -> None:
        self._stop.set()
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1)

    # -- loop side: measure ---------------------------------------------------

    async def _beat(self) -> None:
        while True:
            self._last_beat = time.monotonic()
            self._stack_captured = False
            await asyncio.sleep(self.interval_s)
            # The sleep was scheduled for interval_s; anything beyond it
            # is time some callback (or a CPU-bound stretch of one) held
            # the loop.
            overshoot = time.monotonic() - self._last_beat - self.interval_s
            if overshoot >= self.threshold_s:
                self._m_stalls.inc()
                self._m_stall_s.observe(overshoot)
                self._last_stall["stall_s"] = round(overshoot, 4)
                self._last_stall["ts"] = time.time()
                # Stalls are flight-recorder landmarks: the ring shows
                # what the committee was doing around the freeze.
                metrics.flight_event(
                    "loop_stall", stall_s=round(overshoot, 4)
                )

    # -- thread side: name the culprit ----------------------------------------

    def _watch(self) -> None:
        while not self._stop.wait(self.interval_s):
            gap = time.monotonic() - self._last_beat
            if gap - self.interval_s < self.threshold_s or self._stack_captured:
                continue
            # The loop is stalled RIGHT NOW: its thread's stack names the
            # blocking callee. One capture per stall (flag reset by the
            # next beat), so a long wedge logs once, not per tick.
            self._stack_captured = True
            frame = sys._current_frames().get(self._loop_thread_id)
            if frame is None:
                continue
            excerpt = "".join(
                traceback.format_stack(frame, limit=_STACK_LIMIT)
            )
            self._last_stall["stack"] = excerpt
            log.warning(
                "Event loop stalled > %.0f ms; loop thread stack:\n%s",
                self.threshold_s * 1000, excerpt,
            )


def install_from_env() -> Optional[LoopWatchdog]:
    """Arm the watchdog on the running loop when
    ``NARWHAL_LOOP_WATCHDOG_MS`` > 0 (node/main.py calls this once per
    process); returns the armed instance or None."""
    ms = env_int("NARWHAL_LOOP_WATCHDOG_MS")
    if not ms or ms <= 0:
        return None
    return LoopWatchdog(ms / 1000.0).start()
