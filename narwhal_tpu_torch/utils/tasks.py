"""``spawn()`` — background tasks with a strong reference and a loud death.

``asyncio.create_task`` hands back the ONLY strong reference to the task:
the event loop keeps a weak one, so a fire-and-forget call site lets the
garbage collector silently destroy a live task mid-flight, and a task
that dies of an unhandled exception holds the traceback invisibly until
teardown (or forever).  Both failure shapes have bitten this codebase
enough times that the invariant linter's ``task-retention`` rule bans
bare ``create_task`` statements outright.

``spawn()`` is the sanctioned alternative for background work: it keeps a
strong reference in a module-level set until the task completes, and its
done-callback logs any non-cancellation exception immediately — a dead
pipeline stage names itself in the log the moment it dies instead of
stalling the committee silently.  Call sites that await/cancel their
task through a retained name (queue-get races in core/proposer) may keep
plain ``create_task``; everything launched into the background goes
through here.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional, Set

from .. import metrics

log = logging.getLogger("narwhal.tasks")

# The strong references. A plain set (not WeakSet — defeating GC is the
# whole point); _reap drops each task the moment it completes.
_TASKS: Set[asyncio.Task] = set()

metrics.gauge_fn("runtime.background_tasks", lambda: len(_TASKS))


def _reap(task: asyncio.Task) -> None:
    _TASKS.discard(task)
    if task.cancelled():
        return  # orderly teardown, not a death
    exc = task.exception()
    if exc is not None:
        log.error(
            "Background task %r died of an unhandled exception",
            task.get_name(),
            exc_info=exc,
        )
        # A dead pipeline stage is exactly what the flight recorder
        # exists for: record the death and dump the ring NOW, while the
        # events leading up to it are still in the window.
        flight = metrics.flight()
        flight.record("task_death", task=task.get_name(), exc=repr(exc))
        flight.dump("task-death")


def spawn(coro: Coroutine, *, name: Optional[str] = None) -> asyncio.Task:
    """Schedule ``coro`` on the running loop, strongly referenced until
    done, with unexpected-exception teardown logged.  Returns the task —
    callers that cancel at shutdown keep the handle as usual."""
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _TASKS.add(task)
    task.add_done_callback(_reap)
    return task


def alive_count() -> int:
    """Live spawned-task count (also exported as the
    ``runtime.background_tasks`` gauge)."""
    return len(_TASKS)
