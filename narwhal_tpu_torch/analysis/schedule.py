"""Deterministic schedule explorer — the dynamic half of narwhal-race.

The static rules (``interleave.py``) prove the *shape* of every
suspendable window; this module drives the other direction: actually
*execute* the protocol under many distinct-but-reproducible task
interleavings and let the frozen golden oracle judge the outcomes
(``benchmark/race_explore.py`` is the harness; madsim/FoundationDB-style
deterministic-simulation testing is the lineage).

Mechanism.  An asyncio loop keeps the callbacks that became runnable in
one tick in a FIFO ``_ready`` queue and runs them in insertion order —
which is exactly ONE of the many orders a legal cooperative scheduler
could pick.  :class:`ExploringEventLoop` subclasses the default selector
loop and, at the top of every tick, permutes the same-tick ready set
with a seeded ``random.Random``: same seed → byte-identical permutation
sequence → byte-identical execution, different seed → a genuinely
different (but still legal) interleaving.  Any schedule-dependent
outcome difference is therefore a reproducible bug with the seed as the
repro.

Scope notes:

- only *same-tick* reordering is explored: callbacks scheduled during a
  tick (timer expiries drained inside ``_run_once``, I/O completions)
  join the NEXT tick's permutation.  This is the productive subset —
  it permutes exactly the wakeup order of tasks that raced into
  runnability together, which is where torn-invariant windows open;
- determinism of the *workload* is the harness's job: a scenario with
  real sockets or wall-clock timers is per-seed reproducible only down
  to OS timing, so the byte-identical cross-seed gate belongs to closed
  scenarios (fixed certificate streams) and the safety-verdict gate
  (oracle replay of whatever order actually happened) to socketed ones.
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, Callable, Coroutine, Optional

__all__ = ["ExploringEventLoop", "run_with_seed"]


def _is_task_step(handle) -> bool:
    """True when ``handle`` is a Task wakeup (``Task.__step``) — the
    only handles the explorer may legally reorder.  asyncio's own
    plumbing relies on FIFO between a future's internal done-callbacks
    and everything scheduled after them (e.g. ``sock_connect``'s
    ``_sock_write_done`` must run before the awaiting task resumes and
    wraps the same fd in a transport), so plain-function callbacks stay
    exactly where they are."""
    cb = getattr(handle, "_callback", None)
    owner = getattr(cb, "__self__", None)
    return isinstance(owner, asyncio.Task)


class ExploringEventLoop(asyncio.SelectorEventLoop):
    """Selector event loop that permutes same-tick ready-callback order
    deterministically from ``seed``.

    Only *consecutive runs of task wakeups* are shuffled: the relative
    order of every non-task callback (and of each task wakeup against
    the plumbing callbacks around it) is preserved, so asyncio's
    internal FIFO assumptions hold while the order in which tasks that
    became runnable together get the loop — the thing torn-invariant
    windows care about — is explored.

    ``permutations`` counts the ticks where some run actually had more
    than one task wakeup to permute — a scenario that never wakes two
    tasks in one tick explores nothing, and the harness asserts this
    stays non-trivial so the gate cannot pass vacuously.
    """

    def __init__(self, seed: int) -> None:
        super().__init__()
        self.seed = seed
        self._rng = random.Random(seed)
        self.permutations = 0
        self.ticks = 0

    def _run_once(self) -> None:  # noqa: D401 (asyncio internal hook)
        self.ticks += 1
        ready = self._ready
        if len(ready) > 1:
            items = list(ready)
            permuted = False
            i, n = 0, len(items)
            while i < n:
                if not _is_task_step(items[i]):
                    i += 1
                    continue
                j = i
                while j < n and _is_task_step(items[j]):
                    j += 1
                if j - i > 1:
                    segment = items[i:j]
                    self._rng.shuffle(segment)
                    items[i:j] = segment
                    permuted = True
                i = j
            if permuted:
                ready.clear()
                ready.extend(items)
                self.permutations += 1
        super()._run_once()


def run_with_seed(
    main: Callable[[], Coroutine],
    seed: int,
    timeout: Optional[float] = None,
    virtual_time: bool = False,
) -> Any:
    """``asyncio.run`` under an :class:`ExploringEventLoop` seeded with
    ``seed``; returns ``(result, loop_stats)`` where ``loop_stats`` is a
    dict with the tick/permutation counts (the non-vacuity witness).

    ``timeout`` (enforced via ``asyncio.wait_for``) turns a
    schedule-induced deadlock into a failure with the seed attached
    instead of a hung harness.

    ``virtual_time=True`` delegates to the simulation harness's
    :func:`narwhal_tpu.sim.clock.run_virtual`: same exploring loop, but
    ``loop.time()`` runs on simulated seconds that jump at quiesce —
    ``timeout`` then bounds VIRTUAL seconds, so the guard is
    deterministic per seed instead of host-speed-dependent."""
    if virtual_time:
        from ..sim.clock import run_virtual

        return run_virtual(main, seed, max_virtual_s=timeout)
    loop = ExploringEventLoop(seed)
    try:
        asyncio.set_event_loop(loop)
        coro = main()
        if timeout is not None:
            coro = asyncio.wait_for(coro, timeout)
        result = loop.run_until_complete(coro)
        return result, {
            "seed": seed,
            "ticks": loop.ticks,
            "permutations": loop.permutations,
        }
    finally:
        try:
            _cancel_pending(loop)
            loop.run_until_complete(loop.shutdown_asyncgens())
            # Join the default executor BEFORE closing: cancelling a
            # run_in_executor future does not stop its thread, and a
            # thread surviving into the NEXT seeded incarnation is
            # cross-run state the explorer exists to rule out (it is
            # also how the checkpoint-tmp collision bug hid: the
            # pre-"crash" incarnation's fsync thread raced the restarted
            # one's).
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            asyncio.set_event_loop(None)
            loop.close()


def _cancel_pending(loop: asyncio.AbstractEventLoop) -> None:
    pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
    for task in pending:
        task.cancel()
    if pending:
        loop.run_until_complete(
            asyncio.gather(*pending, return_exceptions=True)
        )
