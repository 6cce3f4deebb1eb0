"""In-process metrics: counters, gauges, histograms, and stage tracing.

The port's copy of the reference's registry (``narwhal_tpu/metrics.py``),
cut to what the port's modules write: the instruments, the per-digest
stage-trace table and the flight recorder's event ring.  Instrument
names are the reference's (``consensus.kernel.*``, ``crypto.verify.*``,
…), because bench JSON keys on them.  The snapshot writer, the metrics
HTTP endpoint, the health monitor and the wire ledger come across with
the node slice that first runs them.

Hot-path cost model: a counter ``inc`` is one attribute add, a histogram
``observe`` is one ``bisect`` + two adds; callback gauges are evaluated
only when a snapshot is taken, so the hot path never pays for them.
``NARWHAL_METRICS=0`` swaps the whole registry for shared no-op
instruments.

Everything here assumes the single-event-loop execution model of the node
(like the Store): plain attribute updates need no locks.
"""

from __future__ import annotations

import collections
import os
import time
from bisect import bisect_left
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .utils.clock import wall_now
from .utils.env import env_flag, env_int

# Latency buckets (seconds): 1 ms … 10 s, roughly log-spaced.  Chosen to
# straddle the measured pipeline: quorum ACKs sit in the 1-50 ms range on
# loopback, end-to-end commits in the 100 ms-3 s range (BASELINE.md).
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Size/count buckets (e.g. KernelTusk flush batch sizes, queue bursts).
COUNT_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
)

# Millisecond-scaled latency buckets for series published in ms
# (consensus.support_arrival_ms): same spread as LATENCY_BUCKETS, 1 ms
# to 10 s, so the two families bucket identically up to the unit.
LATENCY_MS_BUCKETS: Tuple[float, ...] = tuple(
    1000.0 * b for b in LATENCY_BUCKETS
)

# Pipeline stages, in causal order.  TraceTable.mark validates against this
# so a typo'd stage name fails loudly in tests instead of silently skewing
# the bench breakdown.  The last four stages subdivide the old opaque
# cert→commit span (77% of seal→commit in a stage breakdown) so the bench
# attributes where that time goes: protocol cadence (cert_inserted →
# commit_trigger, rounds until the odd-round trigger), walk cost
# (commit_trigger → walk_done), and delivery (walk_done → commit).
STAGES: Tuple[str, ...] = (
    "seal",               # worker: batch sealed (BatchMaker._seal)
    "quorum",             # worker: 2f+1 ACK stake reached (QuorumWaiter)
    "digest_at_primary",  # primary: own digest reached the Proposer
    "header",             # primary: digest included in a created header
    "cert",               # primary: own header's certificate assembled
    "cert_inserted",      # consensus: containing certificate entered Tusk
    "commit_trigger",     # consensus: the arrival that fired the commit rule
    "walk_done",          # consensus: chain walk + causal flatten finished
    "commit",             # consensus: committed certificate delivered
)


class Counter:
    """Monotone counter.  ``inc`` is the hot-path primitive: one add."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value, set by the instrumented code."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: count, sum, and per-bucket counts.

    Buckets are upper bounds; values above the last bound land in the
    implicit +Inf bucket.  Internal counts are per-bucket (not cumulative);
    snapshots and the Prometheus rendering emit the cumulative form.
    """

    __slots__ = ("name", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS) -> None:
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(buckets)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count), ...] ending with (inf, count)."""
        out, acc = [], 0
        for bound, c in zip(self.bounds, self.counts):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), self.count))
        return out


class TraceTable:
    """Bounded key → {stage: timestamp} table (plus per-key extras like
    the sealed byte count): the per-digest pipeline trace
    (``stages=STAGES``, keys are digest hex).

    ``mark`` keeps the FIRST timestamp per (key, stage) — matching the
    log parser's earliest-across-nodes convention — and evicts the oldest
    keys FIFO once ``cap`` is exceeded, so a long-lived node's table
    stays bounded.  Timestamps are wall-clock (``utils/clock.wall_now``
    — ``time.time()`` in production): the bench joins stages across
    *processes*, which monotonic clocks cannot do.  Cross-NODE joins of
    these stamps additionally go through the clocksync offset correction
    (benchmark/metrics_check) — raw wall clocks skew across hosts.
    Under the sim, ``wall_now`` rides the virtual clock plus any
    injected per-node skew, so traces stay bit-reproducible per seed.
    """

    __slots__ = ("cap", "entries", "evictions", "stages")

    def __init__(
        self, cap: int = 32_768, stages: Tuple[str, ...] = STAGES
    ) -> None:
        self.cap = cap
        self.stages = stages
        self.entries: Dict[str, Dict[str, float]] = {}
        # Evictions past the cap: each one is a digest the bench-side
        # stage join will silently miss, so the count is exported (see
        # Registry.__init__) and the harness warns loudly when > 0
        # instead of computing a biased breakdown (ROADMAP item).
        self.evictions = 0

    def mark(
        self, digest_hex: str, stage: str, ts: Optional[float] = None, **extra
    ) -> None:
        if stage not in self.stages:
            raise ValueError(f"unknown pipeline stage {stage!r}")
        entry = self.entries.get(digest_hex)
        if entry is None:
            if len(self.entries) >= self.cap:
                # FIFO eviction: dicts iterate in insertion order.
                self.entries.pop(next(iter(self.entries)))
                self.evictions += 1
            entry = self.entries[digest_hex] = {}
        entry.setdefault(stage, ts if ts is not None else wall_now())
        for k, v in extra.items():
            entry.setdefault(k, v)


class _Null:
    """Shared no-op instrument for the stubbed registry (NARWHAL_METRICS=0).
    One class serves every instrument type: all mutators are no-ops and all
    reads return zeros, so instrumented code needs no enabled-checks."""

    __slots__ = ()
    name = "null"
    value = 0
    sum = 0.0
    count = 0
    mean = 0.0
    bounds: Tuple[float, ...] = ()
    counts: List[int] = []
    cap = 0
    entries: Dict[str, Dict[str, float]] = {}
    evictions = 0
    stages: Tuple[str, ...] = ()

    def inc(self, n=1) -> None: ...
    def dec(self, n=1) -> None: ...
    def set(self, v) -> None: ...
    def observe(self, v) -> None: ...
    def mark(self, digest_hex, stage, ts=None, **extra) -> None: ...
    def cumulative(self) -> list: return []


_NULL = _Null()


class FlightRecorder:
    """Bounded ring of recent structured events — the per-node black box.

    The instrumented layers record protocol landmarks into it (commit
    bursts from ``Consensus.run``); the ring rides in every registry
    snapshot as the ``flight.ring`` detail.  Recording is one dict append
    into a deque; safe from any thread (deque.append is atomic), free
    when the registry is stubbed.
    """

    __slots__ = ("enabled", "events", "_m_events")

    def __init__(self, reg: "Registry", cap: Optional[int] = None) -> None:
        # NARWHAL_FLIGHT=0 stubs the recorder alone, NARWHAL_METRICS=0
        # stubs it with everything else.
        self.enabled = reg.enabled and env_flag("NARWHAL_FLIGHT")
        if cap is None:
            cap = env_int("NARWHAL_FLIGHT_CAP")
        self.events: Deque[dict] = collections.deque(maxlen=max(16, cap))
        if self.enabled:
            self._m_events = reg.counter("flight.events")
            reg.detail_fn("flight.ring", self.snapshot)
        else:
            self._m_events = _NULL  # type: ignore[assignment]

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        event = {"t": round(time.time(), 4), "kind": kind}
        event.update(fields)
        self.events.append(event)
        self._m_events.inc()

    def snapshot(self) -> dict:
        return {"cap": self.events.maxlen, "events": list(self.events)}

    def reset(self) -> None:
        self.events.clear()


class Registry:
    """Per-process instrument registry.

    Instruments are memoized by name (dotted ``layer.metric`` hierarchy),
    so modules fetch them once at init and hold direct references — lookup
    never sits on a hot path.  ``gauge_fn`` registers a zero-cost callback
    gauge evaluated only at snapshot time (queue depths, sender backlogs);
    ``detail_fn`` is the same but may return any JSON value (e.g. a
    per-peer dict).
    """

    def __init__(self, enabled: bool = True, trace_cap: int = 32_768) -> None:
        self.enabled = enabled
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.gauge_fns: Dict[str, Callable[[], float]] = {}
        self.detail_fns: Dict[str, Callable[[], object]] = {}
        self.trace: TraceTable = (
            TraceTable(trace_cap) if enabled else _NULL  # type: ignore
        )
        # Flight recorder: bounded ring of recent structured events
        # (see FlightRecorder).
        self.flight = FlightRecorder(self)
        if enabled:
            self.gauge_fn(
                "metrics.trace_evictions", lambda: self.trace.evictions
            )

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL  # type: ignore[return-value]
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL  # type: ignore[return-value]
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(
        self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS
    ) -> Histogram:
        if not self.enabled:
            return _NULL  # type: ignore[return-value]
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, buckets)
        return h

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Callback gauge, polled at snapshot time only.
        Re-registration overwrites (in-process multi-node tests)."""
        if self.enabled:
            self.gauge_fns[name] = fn

    def detail_fn(self, name: str, fn: Callable[[], object]) -> None:
        """Like gauge_fn but may return structured JSON (snapshot only)."""
        if self.enabled:
            self.detail_fns[name] = fn

    def reset(self) -> None:
        """Zero every instrument IN PLACE (test isolation).  Module-level
        code holds direct references fetched at import time (e.g. the
        network counters), so instruments must keep their identity — only
        their values reset.  Callback gauges are kept too: a callback over
        a torn-down object fails in-band at snapshot time.  Production
        code never calls this."""
        for c in self.counters.values():
            c.value = 0
        for g in self.gauges.values():
            g.value = 0.0
        for h in self.histograms.values():
            h.counts = [0] * (len(h.bounds) + 1)
            h.sum = 0.0
            h.count = 0
        if self.enabled:
            self.trace.entries.clear()
            self.trace.evictions = 0
        self.flight.reset()

    # -- export --------------------------------------------------------------

    def snapshot(self, include_trace: bool = True) -> dict:
        """One JSON-serializable dict of everything, callback gauges
        evaluated now.  A failing callback is reported in-band (under
        ``errors``) instead of killing the snapshot loop.

        ``include_trace=False`` omits the stage-trace table — it dominates
        the serialized size (hundreds of kB on a bench run, ~12 ms of
        json.dumps on a slow core)."""
        errors: List[str] = []

        def call(name, fn):
            try:
                return fn()
            except Exception as e:  # a dead queue/sender must not kill us
                errors.append(f"{name}: {e!r}")
                return None

        snap = {
            "ts": time.time(),
            "pid": os.getpid(),
            "enabled": self.enabled,
            "counters": {n: c.value for n, c in self.counters.items()},
            "gauges": {
                **{n: g.value for n, g in self.gauges.items()},
                **{n: call(n, fn) for n, fn in self.gauge_fns.items()},
            },
            "histograms": {
                n: {
                    "count": h.count,
                    "sum": h.sum,
                    "mean": h.mean,
                    "buckets": [
                        [b if b != float("inf") else "inf", c]
                        for b, c in h.cumulative()
                    ],
                }
                for n, h in self.histograms.items()
            },
            "detail": {n: call(n, fn) for n, fn in self.detail_fns.items()},
            "trace": (
                dict(self.trace.entries)
                if self.enabled and include_trace
                else {}
            ),
        }
        if errors:
            snap["errors"] = errors
        return snap


# -- the per-process default registry ----------------------------------------

def _enabled_from_env() -> bool:
    return env_flag("NARWHAL_METRICS")


_REGISTRY = Registry(
    enabled=_enabled_from_env(),
    trace_cap=env_int("NARWHAL_TRACE_CAP"),
)


def registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, buckets)


def gauge_fn(name: str, fn: Callable[[], float]) -> None:
    _REGISTRY.gauge_fn(name, fn)


def trace() -> TraceTable:
    return _REGISTRY.trace  # type: ignore[return-value]


def flight_event(kind: str, **fields) -> None:
    """Module-level convenience for the instrumented layers (one ring
    append; no-op when the registry is stubbed)."""
    _REGISTRY.flight.record(kind, **fields)
