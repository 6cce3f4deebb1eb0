"""Always-on sampling profiler: whole-process CPU attribution, no probes.

Every perf number this repo trusts so far came from *hand-placed*
instrumentation — the stage/round traces, the crypto ledger's per-site
timers — which can only answer questions someone thought to ask.  The r10
cadence verdict ("72-75% of the round period is the two peer-verify
legs") took a PR of plumbing to establish; a sampling profiler reads the
same fact off the stacks in one bench run, and keeps answering for every
code path nobody instrumented.

Mechanism (:class:`SamplingProfiler`, armed by ``NARWHAL_PROFILE_HZ``,
default ~67 Hz, ``0`` = off):

- a daemon thread wakes ``hz`` times a second and snapshots **all**
  thread stacks via ``sys._current_frames()`` — the same facility the
  loop-stall watchdog uses for its one-shot captures, run continuously.
  67 Hz deliberately avoids aliasing with the protocol's 10/100 ms
  timers (a 100 Hz sampler strobes a 10 ms cadence loop);
- each stack folds into a ``module:function`` frame tuple and lands in a
  stack→count table — the *folded stack* format every flamegraph tool
  eats directly (``profile.folded`` in the snapshot detail);
- self-time per frame (samples where the frame is the leaf) and total
  time (samples where it appears anywhere) aggregate into the
  ``profile.top`` table — the general CPU attribution that must
  independently reproduce the ledger's "verify dominates" finding;
- samples whose leaf is an OS wait (select/epoll, lock waits,
  ``Event.wait``) are counted (``profile.idle_samples``) but excluded
  from self-time: a wall-clock sampler sees parked daemon threads as
  "running" their wait frame, and attributing CPU to ``epoll`` would
  bury the actual compute;
- the MAIN thread (the node's event loop) additionally feeds a bounded
  run-length-encoded timeline of leaf frames (``profile.timeline``:
  ``[start_ts, end_ts, samples, frame]`` runs) — what lets the trace
  exporter draw a poor-man's flame track on each node's Perfetto row,
  time-aligned with the protocol stages.

Cost: one ``sys._current_frames()`` + a fold per tick.  Measured on the
4-node committee A/B (artifacts/trace_profile_r16.json): within noise of
the unprofiled arm at 67 Hz, which is what makes "always on" honest.

Everything exports through the normal metrics registry, so snapshots,
``/metrics.json`` and the bench harnesses pick the series up with zero
extra plumbing; ``NARWHAL_METRICS=0`` disables the export (and
``install_from_env`` then declines to start the thread at all).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics
from .utils.env import env_float

log = logging.getLogger("narwhal.profiling")

# Leaf code-object names that mean "parked in the OS, not burning CPU".
# A wall-clock sampler charges blocked threads to their wait frame;
# excluding these from SELF time keeps `profile.top` a CPU table.  The
# full stacks still land in the folded output (wall-clock truth).
_IDLE_LEAVES = frozenset({
    "wait", "select", "poll", "epoll", "kqueue", "accept", "recv",
    "recv_into", "read", "readinto", "readline", "sleep", "settrace",
    "_wait_for_tstate_lock", "wait_for", "acquire", "getaddrinfo",
})

# (file basename, function) leaves that block inside a C call the
# sampler cannot see past: ThreadPoolExecutor workers park in the
# C-implemented SimpleQueue.get directly under `_worker`, so the leaf
# reads as the worker loop itself — measured at 52% of committee "self
# time" before this classification (artifacts/trace_profile_r16.json's
# first cut), all of it parked executor threads.
_IDLE_LEAF_SITES = frozenset({
    ("thread.py", "_worker"),
})

# Hard bound on distinct folded stacks kept; past it, new stacks count
# into profile.dropped_stacks instead of growing without bound (deep
# recursive workloads can mint unbounded distinct stacks).
_MAX_STACKS = 8192

_STACK_DEPTH = 48          # frames kept per folded stack (root-truncated)
_TIMELINE_CAP = 4096       # RLE runs kept for the main-thread leaf series


def _frame_label(code) -> str:
    """``file:function`` with the path collapsed to its basename — short
    enough to fold, unique enough to read (``core.py:sanitize_header``)."""
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class SamplingProfiler:
    """Samples all thread stacks at ``hz`` from a daemon thread."""

    def __init__(
        self,
        hz: float,
        reg: Optional[metrics.Registry] = None,
    ) -> None:
        self.hz = hz
        self.interval_s = 1.0 / hz
        self.registry = reg if reg is not None else metrics.registry()
        # folded stack (root→leaf tuple of labels, thread-name prefixed)
        # -> sample count
        self._stacks: Dict[Tuple[str, ...], int] = {}
        # label -> [self_samples, total_samples] over NON-idle samples
        self._frames: Dict[str, List[int]] = {}
        # Main-thread leaf RLE: [start_ts, end_ts, samples, label]
        self._timeline: List[list] = []
        self._main_tid = threading.main_thread().ident
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        r = self.registry
        self._m_samples = r.counter("profile.samples")
        self._m_idle = r.counter("profile.idle_samples")
        self._m_dropped = r.counter("profile.dropped_stacks")
        self._m_threads = r.gauge("profile.threads")
        self._m_hz = r.gauge("profile.hz")
        self._m_hz.set(hz)
        r.detail_fn("profile.top", lambda: self.top_table())
        r.detail_fn("profile.folded", lambda: self.folded())
        r.detail_fn("profile.timeline", lambda: list(self._timeline))

    # -- sampling (daemon thread) ---------------------------------------------

    def start(self) -> "SamplingProfiler":
        self._thread = threading.Thread(
            target=self._run, name="sampling-profiler", daemon=True
        )
        self._thread.start()
        log.info("Sampling profiler armed at %.1f Hz", self.hz)
        return self

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1)
            self._thread = None

    def _run(self) -> None:
        me = threading.get_ident()
        next_tick = time.monotonic()
        while not self._stop.is_set():
            next_tick += self.interval_s
            delay = next_tick - time.monotonic()
            if delay > 0:
                if self._stop.wait(delay):
                    break
            else:
                # Fell behind (suspended, loaded core): re-anchor rather
                # than burst-sample to catch up — bursts would weight one
                # instant as many ticks.
                next_tick = time.monotonic()
            try:
                self.sample_once(exclude={me})
            except Exception:
                # A racing thread teardown mid-introspection must never
                # kill the profiler for the rest of the run.
                log.exception("profiler sample failed")

    def sample_once(self, exclude: Optional[set] = None) -> None:
        """One sampling tick over every live thread (callable directly in
        tests; the daemon thread excludes itself)."""
        now = time.time()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        self._m_threads.set(len(frames) - (1 if exclude else 0))
        for tid, frame in frames.items():
            if exclude and tid in exclude:
                continue
            stack: List[str] = []
            depth = 0
            f = frame
            leaf_label = None
            while f is not None and depth < _STACK_DEPTH:
                label = _frame_label(f.f_code)
                if leaf_label is None:
                    leaf_label = label
                    leaf_name = f.f_code.co_name
                    leaf_file = os.path.basename(f.f_code.co_filename)
                stack.append(label)
                f = f.f_back
                depth += 1
            if leaf_label is None:
                continue
            stack.reverse()  # root → leaf, flamegraph orientation
            self._m_samples.inc()
            idle = (
                leaf_name in _IDLE_LEAVES
                or (leaf_file, leaf_name) in _IDLE_LEAF_SITES
            )
            if idle:
                self._m_idle.inc()
            key = (names.get(tid, f"tid-{tid}"), *stack)
            cnt = self._stacks.get(key)
            if cnt is not None:
                self._stacks[key] = cnt + 1
            elif len(self._stacks) < _MAX_STACKS:
                self._stacks[key] = 1
            else:
                self._m_dropped.inc()
            if not idle:
                seen = set()
                for label in stack:
                    if label in seen:
                        continue  # recursion: one total credit per sample
                    seen.add(label)
                    rec = self._frames.get(label)
                    if rec is None:
                        rec = self._frames[label] = [0, 0]
                    rec[1] += 1
                self._frames[leaf_label][0] += 1
            if tid == self._main_tid:
                self._timeline_push(now, leaf_label)

    def _timeline_push(self, now: float, label: str) -> None:
        tl = self._timeline
        if tl and tl[-1][3] == label:
            tl[-1][1] = now
            tl[-1][2] += 1
            return
        if len(tl) >= _TIMELINE_CAP:
            # FIFO: keep the most recent window (what a post-mortem trace
            # export wants to see).
            del tl[: _TIMELINE_CAP // 4]
        tl.append([now, now, 1, label])

    # -- export ---------------------------------------------------------------

    def folded(self, limit: int = 2000) -> str:
        """Folded-stack text (``thread;frame;frame… count`` per line) —
        pipe straight into flamegraph.pl / speedscope / inferno.  Top
        ``limit`` stacks by count."""
        rows = sorted(
            self._stacks.items(), key=lambda kv: kv[1], reverse=True
        )[:limit]
        return "\n".join(
            ";".join(stack) + f" {count}" for stack, count in rows
        )

    def top_table(self, n: int = 25) -> List[dict]:
        """Top-``n`` frames by self-time (non-idle samples where the frame
        is the leaf), with total (anywhere-on-stack) alongside — the
        sampling analog of a profiler's self/cumulative columns."""
        busy = max(
            1, self._m_samples.value - self._m_idle.value
        )
        rows = sorted(
            self._frames.items(), key=lambda kv: kv[1][0], reverse=True
        )[:n]
        return [
            {
                "frame": label,
                "self": self_n,
                "total": total_n,
                "self_frac": round(self_n / busy, 4),
            }
            for label, (self_n, total_n) in rows
            if self_n > 0
        ]


def install_from_env(exported: bool = True) -> Optional[SamplingProfiler]:
    """Arm the profiler when ``NARWHAL_PROFILE_HZ`` > 0 *and* the metrics
    registry is live (a stubbed registry would sample into no-ops —
    all cost, no data) *and* something exports the registry
    (``exported``: a snapshot path or a metrics port; samples nobody
    reads are all cost too).  node/main.py calls this once per process."""
    hz = env_float("NARWHAL_PROFILE_HZ")
    if not exported or not hz or hz <= 0 or not metrics.registry().enabled:
        return None
    return SamplingProfiler(hz).start()
