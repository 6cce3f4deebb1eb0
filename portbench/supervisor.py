"""The one supervisor of every process a benchmark run starts.

A run leaves nothing behind:

- every child is started from the main thread with ``PR_SET_PDEATHSIG``
  set to SIGKILL, so it dies however the harness dies (the signal fires
  when the thread that forked it exits, hence the main thread);
- the harness marks itself ``PR_SET_CHILD_SUBREAPER``, so an orphaned
  grandchild (``make`` or ``ninja`` under a node, anything that double
  forks or calls ``setsid``) is reparented to it and not to init;
- children stay in the harness's process group (no new session);
- :meth:`Supervisor.reap_all` walks ``/proc/<pid>/task/*/children`` from
  the harness down, SIGKILLs every descendant still there and reaps it,
  until a walk finds none.

Signals: :func:`signals_raise` turns SIGTERM, SIGINT and SIGALRM (the
harness's own deadline) into :class:`Interrupted`, so the caller's
``finally`` runs the teardown on every path.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional

PR_SET_PDEATHSIG = 1
PR_SET_CHILD_SUBREAPER = 36

_libc = ctypes.CDLL(None, use_errno=True)


class Interrupted(BaseException):
    """SIGTERM, SIGINT or the harness's deadline arrived during a run."""

    def __init__(self, signum: int) -> None:
        super().__init__(signal.Signals(signum).name)
        self.signum = signum


def _raise(signum, _frame):
    raise Interrupted(signum)


@contextlib.contextmanager
def signals_raise(deadline_s: Optional[float] = None):
    """Inside the block SIGTERM, SIGINT and (after ``deadline_s``)
    SIGALRM raise :class:`Interrupted`.  On leaving it all three are
    ignored, so that a second signal cannot cut the teardown that the
    caller runs next; the process exits after it."""
    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)
    for s in sigs:
        signal.signal(s, _raise)
    if deadline_s:
        signal.setitimer(signal.ITIMER_REAL, deadline_s)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        for s in sigs:
            signal.signal(s, signal.SIG_IGN)


def _child_setup(parent: int) -> None:
    """Runs in the forked child before exec."""
    if _libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        os._exit(126)
    if os.getppid() != parent:  # the harness died before the prctl
        os._exit(126)
    for s in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM):
        signal.signal(s, signal.SIG_DFL)


def children_of(pid: int) -> List[int]:
    """The direct children of every thread of ``pid`` (zombies too)."""
    out: List[int] = []
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tasks:
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                out.extend(int(x) for x in f.read().split())
        except OSError:
            continue
    return out


def descendants(pid: int) -> List[int]:
    """Every process below ``pid``, parents before their children."""
    found, todo = [], [pid]
    while todo:
        for child in children_of(todo.pop()):
            if child not in found:
                found.append(child)
                todo.append(child)
    return found


class Supervisor:
    """Starts, stops and reaps the children of one run."""

    def __init__(self) -> None:
        if _libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")
        self.pid = os.getpid()
        self.procs: Dict[str, subprocess.Popen] = {}
        self.started: Dict[str, float] = {}
        self.logs: Dict[str, str] = {}
        self.killed = 0

    def start(self, name: str, argv: List[str], log_path: str,
              env: Optional[dict] = None, cwd: Optional[str] = None
              ) -> subprocess.Popen:
        """Start ``argv`` as child ``name``, its stdout and stderr in
        ``log_path``.  Only from the main thread (see the module doc)."""
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("children are started from the main thread only")
        if name in self.procs:
            raise ValueError(f"child {name!r} already started")
        parent = os.getpid()
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, env=env, cwd=cwd,
                preexec_fn=lambda: _child_setup(parent))
        self.procs[name] = proc
        self.started[name] = time.time()
        self.logs[name] = log_path
        return proc

    def running(self, names=None) -> List[str]:
        names = self.procs if names is None else names
        return [n for n in names if self.procs[n].poll() is None]

    def stop(self, names, sig: int, grace_s: float) -> Dict[str, Optional[int]]:
        """Send ``sig`` to each named child still running and wait up to
        ``grace_s`` for all of them; returns {name: exit code, None for
        one still running at the end}."""
        names = list(names)
        for n in self.running(names):
            with contextlib.suppress(ProcessLookupError):
                self.procs[n].send_signal(sig)
        end = time.monotonic() + grace_s
        codes = {}
        for n in names:
            try:
                codes[n] = self.procs[n].wait(max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                codes[n] = None
        return codes

    def reap_all(self, rounds: int = 50) -> int:
        """SIGKILL and reap every descendant until a walk finds none;
        returns how many were killed (adds them to ``self.killed``).
        Raises if descendants remain after ``rounds`` walks."""
        killed = 0
        for _ in range(rounds):
            found = descendants(self.pid)
            if not found:
                self.killed += killed
                return killed
            for pid in found:
                if _alive(pid):
                    with contextlib.suppress(ProcessLookupError):
                        os.kill(pid, signal.SIGKILL)
                        killed += 1
            self._reap()
            time.sleep(0.02)
        raise RuntimeError(f"descendants left after {rounds} walks: {descendants(self.pid)}")

    def _reap(self) -> None:
        ours = {p.pid: p for p in self.procs.values()}
        for pid in children_of(self.pid):
            proc = ours.get(pid)
            try:
                if proc is not None:
                    proc.wait(5.0)
                else:
                    os.waitpid(pid, 0)
            except (ChildProcessError, subprocess.TimeoutExpired):
                pass


def _alive(pid: int) -> bool:
    """True unless ``pid`` is gone or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False
