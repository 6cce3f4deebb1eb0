"""In-process metrics: counters, gauges, histograms, and stage tracing.

The port's copy of the reference's registry (``narwhal_tpu/metrics.py``),
cut to what the port's modules write: the instruments, the per-digest and
per-round stage-trace tables, the wire ledger, the flight recorder's
event ring (with its dump on a background task's death) and the
instrumented queues.  Instrument names are the reference's
(``consensus.kernel.*``, ``crypto.verify.*``, ``wire.*``, ``queue.*`` …),
because bench JSON keys on them.  The snapshot writer, the metrics HTTP
endpoint, the health monitor and the flight recorder's tick loop come
across with the node slice that first runs them.

Hot-path cost model: a counter ``inc`` is one attribute add, a histogram
``observe`` is one ``bisect`` + two adds; queue depths and sender backlogs
are *callback* gauges evaluated only when a snapshot is taken, so the hot
path never pays for them.  ``NARWHAL_METRICS=0`` swaps the whole registry
for shared no-op instruments.

Everything here assumes the single-event-loop execution model of the node
(like the Store): plain attribute updates need no locks.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import os
import time
from bisect import bisect_left
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .utils.clock import wall_now
from .utils.env import env_flag, env_int, env_str

log = logging.getLogger("narwhal.metrics")

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
# cert→commit span (77% of seal→commit in the r07 breakdown) so the bench
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

# Round-cadence sub-stages, in causal order.  The r09 cert→commit
# attribution showed 97-98% of commit latency is protocol cadence —
# `primary.round_advance_seconds` × commit depth — so the round period
# itself needs the same decomposition cert→commit got.  Each PRIMARY
# stamps these into a second, per-ROUND trace table (key = the decimal
# round number, one entry per round of its own header lifecycle):
#
#   header_proposed   proposer minted our round-r header
#   header_broadcast  core handed the header to the reliable sender
#   first_vote        first vote (incl. our own) for our round-r header
#   vote_quorum       2f+1 vote stake reached — our certificate assembled
#   cert_broadcast    our certificate handed to the reliable sender
#   parent_quorum     2f+1 certificate stake for round r — parents ready
#   round_advance     proposer moved to round r+1
#
# Unlike STAGES (joined committee-wide by digest), these are PER-NODE:
# every primary runs its own cadence loop, so the bench aggregates legs
# across (node, round) pairs without cross-node joining.  The leg from
# round r-1's round_advance to round r's header_proposed (the proposer's
# min/max-header-delay wait) is derived at analysis time, which makes the
# legs telescope to exactly the measured round period.
ROUND_STAGES: Tuple[str, ...] = (
    "header_proposed",
    "header_broadcast",
    "first_vote",
    "vote_quorum",
    "cert_broadcast",
    "parent_quorum",
    "round_advance",
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
    the sealed byte count).  Two instances exist per registry: the
    per-digest pipeline trace (``stages=STAGES``, keys are digest hex)
    and the per-round cadence trace (``stages=ROUND_STAGES``, keys are
    decimal round numbers).

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


class WireLedger:
    """Per-(direction, message-type, peer) wire accounting.

    The network layer moves opaque frames; the serialization seam
    (narwhal_tpu/messages.py, primary/messages.py) is where bytes acquire
    a protocol meaning — so senders/receivers are handed the message type
    explicitly (senders at the call site that just encoded it, receivers
    via a plane-appropriate tag classifier) and this ledger turns every
    frame into four numbers:

    - ``wire.out.frames.<type>`` / ``wire.out.bytes.<type>`` — FIRST
      transmissions only;
    - ``wire.out.retransmit_frames.<type>`` / ``_bytes.<type>`` — every
      re-write of an un-ACKed frame after a reconnect (ReliableSender).
      Kept apart so goodput math can never confuse "bytes the protocol
      needed" with "bytes a flapping link cost" — the denominator of the
      goodput ratio uses their SUM, the per-type protocol cost uses only
      the first-transmission counters;
    - ``wire.in.frames.<type>`` / ``wire.in.bytes.<type>`` — receiver
      side, which is how sender-vs-receiver totals reconcile per type.

    Per-peer detail rides in one ``wire.peers`` detail_fn (snapshot-only,
    excluded from Prometheus):
    ``{"out"|"in": {type: {peer: [frames, bytes, re_frames, re_bytes]}}}``.

    Counted bytes are frame PAYLOAD bytes as they ride the wire: the
    framing length prefix and the tiny ACK replies are excluded on both
    sides, so the two directions measure the same thing.  Under wire v2
    the payload is COMPRESSED (per-connection digest references +
    residual deflate), so every account also carries the frame's
    pre-compression logical size into ``wire.<dir>.raw_bytes.<type>`` —
    protocol-composition metrics (cert signature fraction, per-type
    frame anatomy) read the raw series, goodput reads the wire series,
    and their ratio is the measured compression win.
    """

    __slots__ = ("registry", "peers", "_flat", "_raw")

    def __init__(self, reg: "Registry") -> None:
        self.registry = reg
        # direction -> type -> peer -> [frames, bytes, re_frames, re_bytes]
        self.peers: Dict[str, Dict[str, Dict[str, List[int]]]] = {
            "out": {},
            "in": {},
        }
        # (direction, type, retransmit) -> (frames Counter, bytes Counter)
        self._flat: Dict[Tuple[str, str, bool], Tuple[Counter, Counter]] = {}
        # (direction, type) -> pre-compression bytes Counter
        self._raw: Dict[Tuple[str, str], Counter] = {}
        if reg.enabled:
            reg.detail_fn("wire.peers", lambda: self.peers)

    def _counters(
        self, direction: str, msg_type: str, retransmit: bool
    ) -> Tuple[Counter, Counter]:
        key = (direction, msg_type, retransmit)
        pair = self._flat.get(key)
        if pair is None:
            stem = (
                f"wire.{direction}.retransmit"
                if retransmit
                else f"wire.{direction}"
            )
            pair = self._flat[key] = (
                self.registry.counter(
                    f"{stem}_frames.{msg_type}"
                    if retransmit
                    else f"{stem}.frames.{msg_type}"
                ),
                self.registry.counter(
                    f"{stem}_bytes.{msg_type}"
                    if retransmit
                    else f"{stem}.bytes.{msg_type}"
                ),
            )
        return pair

    def account(
        self,
        direction: str,
        msg_type: str,
        peer: str,
        nbytes: int,
        retransmit: bool = False,
        raw_nbytes: Optional[int] = None,
    ) -> None:
        if not self.registry.enabled:
            return
        frames, nbytes_c = self._counters(direction, msg_type, retransmit)
        frames.inc()
        nbytes_c.inc(nbytes)
        if not retransmit:
            key = (direction, msg_type)
            raw_c = self._raw.get(key)
            if raw_c is None:
                raw_c = self._raw[key] = self.registry.counter(
                    f"wire.{direction}.raw_bytes.{msg_type}"
                )
            raw_c.inc(nbytes if raw_nbytes is None else raw_nbytes)
        cell = (
            self.peers[direction]
            .setdefault(msg_type, {})
            .setdefault(peer, [0, 0, 0, 0])
        )
        idx = 2 if retransmit else 0
        cell[idx] += 1
        cell[idx + 1] += nbytes

    def reset(self) -> None:
        for d in self.peers.values():
            d.clear()
        # Flat counters keep identity (they live in the registry's pools
        # and are zeroed by Registry.reset's counter sweep).


class FlightRecorder:
    """Bounded ring of recent structured events — the per-node black box.

    The instrumented layers record protocol landmarks into it (commit
    bursts from ``Consensus.run``, round advances from
    ``Proposer._advance``) and unhandled background task deaths
    (utils/tasks.py).  The ring rides in every registry snapshot
    (``flight.ring`` detail) and **dumps atomically to a file**
    (``NARWHAL_FLIGHT_DIR``) on an unhandled task death.  The
    reference's per-interval ``tick`` loop comes with the node.

    Recording is one dict append into a deque; safe from any thread
    (deque.append is atomic), free when the registry is stubbed.
    """

    __slots__ = ("enabled", "events", "dumps", "dir", "node_id",
                 "_m_events", "_m_dumps", "_seq")

    def __init__(self, reg: "Registry", cap: Optional[int] = None) -> None:
        # NARWHAL_FLIGHT=0 stubs the recorder alone (the A/B overhead
        # arm's knob), NARWHAL_METRICS=0 stubs it with everything else.
        self.enabled = reg.enabled and env_flag("NARWHAL_FLIGHT")
        if cap is None:
            cap = env_int("NARWHAL_FLIGHT_CAP")
        self.events: Deque[dict] = collections.deque(maxlen=max(16, cap))
        self.dumps: List[dict] = []  # [{reason, ts, path}] — dump markers
        self.dir: Optional[str] = env_str("NARWHAL_FLIGHT_DIR")
        self.node_id = ""  # node/main.py stamps role-keyprefix
        self._seq = 0
        if self.enabled:
            self._m_events = reg.counter("flight.events")
            self._m_dumps = reg.counter("flight.dumps")
            reg.detail_fn("flight.ring", self.snapshot)
        else:
            self._m_events = _NULL  # type: ignore[assignment]
            self._m_dumps = _NULL  # type: ignore[assignment]

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        event = {"t": round(time.time(), 4), "kind": kind}
        event.update(fields)
        self.events.append(event)
        self._m_events.inc()

    def snapshot(self) -> dict:
        return {
            "node": self.node_id,
            "cap": self.events.maxlen,
            "events": list(self.events),
            "dumps": list(self.dumps),
        }

    def dump(self, reason: str) -> Optional[str]:
        """Atomically write the current ring to ``NARWHAL_FLIGHT_DIR``
        (no-op without a directory — the ring is still pullable via
        /debug/flight).  Returns the path written, if any.  Never raises:
        the recorder fires from teardown paths (SIGTERM, task death)
        where a secondary failure must not mask the primary one."""
        if not self.enabled:
            return None
        self.record("dump", reason=reason)
        self._m_dumps.inc()
        if not self.dir:
            return None
        self._seq += 1
        # node_id embeds a base64 key prefix ('/' and '+' are legal
        # there, not in a filename component) — sanitize for the path.
        stem = "".join(
            c if c.isalnum() or c in "._-" else "_"
            for c in (self.node_id or f"pid{os.getpid()}")
        )
        path = os.path.join(
            self.dir, f"flight-{stem}-{self._seq}-{reason}.json"
        )
        try:
            os.makedirs(self.dir, exist_ok=True)
            body = json.dumps(
                {"reason": reason, "ts": time.time(), **self.snapshot()}
            )
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(body)
            os.replace(tmp, path)
        except OSError:
            log.exception("flight dump to %s failed", path)
            return None
        self.dumps.append(
            {"reason": reason, "ts": round(time.time(), 3), "path": path}
        )
        log.warning("FLIGHT ring dumped (%s) -> %s", reason, path)
        return path

    def reset(self) -> None:
        self.events.clear()
        self.dumps.clear()
        self._seq = 0


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


class Registry:
    """Per-process instrument registry.

    Instruments are memoized by name (dotted ``layer.metric`` hierarchy),
    so modules fetch them once at init and hold direct references — lookup
    never sits on a hot path.  ``gauge_fn`` registers a zero-cost callback
    gauge evaluated only at snapshot time (queue depths, sender backlogs);
    ``detail_fn`` is the same but may return any JSON value (e.g. a
    per-peer dict) and is excluded from the Prometheus rendering, which is
    scalar-only.
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
        # Per-round cadence trace (ROUND_STAGES): one entry per round the
        # local primary's header lifecycle passes through.  Bounded much
        # tighter than the digest trace — rounds arrive at ~10/s, so 4096
        # covers runs far longer than any bench window.
        self.round_trace: TraceTable = (
            TraceTable(4096, stages=ROUND_STAGES)
            if enabled
            else _NULL  # type: ignore
        )
        # Per-(direction, message-type, peer) wire accounting; the
        # network senders/receiver feed it (see WireLedger).
        self.wire = WireLedger(self)
        # Flight recorder: bounded ring of recent structured events,
        # dumped on 503/SIGTERM/task-death (see FlightRecorder).
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
        """Callback gauge, polled at snapshot/scrape time only.
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
            self.round_trace.entries.clear()
            self.round_trace.evictions = 0
        self.wire.reset()
        self.flight.reset()

    # -- export --------------------------------------------------------------

    def snapshot(self, include_trace: bool = True) -> dict:
        """One JSON-serializable dict of everything, callback gauges
        evaluated now.  A failing callback is reported in-band (under
        ``errors``) instead of killing the snapshot loop.

        ``include_trace=False`` omits the stage-trace table — it dominates
        the serialized size (hundreds of kB on a bench run, ~12 ms of
        json.dumps on a slow core), and the periodic writer skips it on
        most rewrites to keep the 1 Hz snapshot cost off the committee's
        shared core."""
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
            # Small (one entry per round, not per digest) but gated with
            # the digest trace anyway: the bench attribution reads the
            # final cancellation flush, which always includes it.
            "round_trace": (
                dict(self.round_trace.entries)
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


def detail_fn(name: str, fn: Callable[[], object]) -> None:
    _REGISTRY.detail_fn(name, fn)


def trace() -> TraceTable:
    return _REGISTRY.trace  # type: ignore[return-value]


def round_trace() -> TraceTable:
    return _REGISTRY.round_trace  # type: ignore[return-value]


def wire() -> WireLedger:
    return _REGISTRY.wire


def wire_account(
    direction: str,
    msg_type: str,
    peer: str,
    nbytes: int,
    retransmit: bool = False,
    raw_nbytes: Optional[int] = None,
) -> None:
    """Module-level convenience for the network layer (one call per
    frame; no-op when the registry is stubbed).  ``raw_nbytes`` is the
    frame's pre-compression size when wire v2 compressed it (defaults
    to ``nbytes``)."""
    _REGISTRY.wire.account(
        direction, msg_type, peer, nbytes, retransmit, raw_nbytes
    )


def flight() -> FlightRecorder:
    return _REGISTRY.flight


def flight_event(kind: str, **fields) -> None:
    """Module-level convenience for the instrumented layers (one ring
    append; no-op when the registry is stubbed)."""
    _REGISTRY.flight.record(kind, **fields)


# -- instrumented channels ----------------------------------------------------

class InstrumentedQueue(asyncio.Queue):
    """Drop-in ``asyncio.Queue`` emitting per-channel backpressure series.

    Every inter-task channel in the node is constructed through this
    class with a stable ``channel`` name, so a saturation knee reads as
    a NAMED filling queue instead of an anonymous latency cliff.  All
    series live under ``queue.<channel>.``:

        depth       gauge     live qsize, written on every put/get (a
                              plain gauge, not a callback, so the health
                              monitor's plain-gauge scan and the scraped
                              sample timeline both see it)
        capacity    gauge     maxsize (0 = unbounded), set once
        high_water  gauge     maximum depth ever observed
        enqueued    counter   items accepted
        dequeued    counter   items removed
        full        counter   ``asyncio.QueueFull`` raised from
                              ``put_nowait`` (the drop/park signal — the
                              caller decides which; BatchMaker parks)
        put_wait_seconds   histogram  time a blocking ``put()`` spent
                                      suspended on a full queue (only
                                      blocked puts are observed, so the
                                      count is "puts that waited")
        residence_seconds  histogram  enqueue→dequeue age per item

    Cost: the enabled arm pays two counter increments, two gauge writes
    and one timestamp-deque append/popleft per item — ``time.monotonic``
    is called once on each side.  With ``NARWHAL_METRICS=0`` the
    constructor registers nothing and every override reduces to one
    attribute test before delegating, so the queue behaves like a plain
    ``asyncio.Queue`` (the measured A/B arm; artifact
    ``artifacts/queue_overhead_r21.json``).

    Interception points are asyncio.Queue's internal ``_put``/``_get``
    hooks: both the awaiting and the ``*_nowait`` paths funnel through
    them, so accounting cannot miss an item or double-count one.
    """

    def __init__(self, maxsize: int = 0, *, channel: str) -> None:
        self.channel = channel
        reg = _REGISTRY
        self._instrumented = reg.enabled
        if self._instrumented:
            self._m_depth = reg.gauge(f"queue.{channel}.depth")
            self._m_capacity = reg.gauge(f"queue.{channel}.capacity")
            self._m_high = reg.gauge(f"queue.{channel}.high_water")
            self._m_enqueued = reg.counter(f"queue.{channel}.enqueued")
            self._m_dequeued = reg.counter(f"queue.{channel}.dequeued")
            self._m_full = reg.counter(f"queue.{channel}.full")
            self._m_put_wait = reg.histogram(
                f"queue.{channel}.put_wait_seconds"
            )
            self._m_residence = reg.histogram(
                f"queue.{channel}.residence_seconds"
            )
            self._m_capacity.set(float(maxsize))
            # Enqueue timestamps in FIFO order.  asyncio.Queue IS FIFO,
            # so popleft pairs each dequeue with its enqueue exactly.
            self._enq_ts: Deque[float] = collections.deque()
        super().__init__(maxsize)

    def _put(self, item) -> None:
        super()._put(item)
        if self._instrumented:
            self._m_enqueued.inc()
            self._enq_ts.append(time.monotonic())
            depth = self.qsize()
            self._m_depth.set(float(depth))
            if depth > self._m_high.value:
                self._m_high.set(float(depth))

    def _get(self):
        item = super()._get()
        if self._instrumented:
            self._m_dequeued.inc()
            self._m_depth.set(float(self.qsize()))
            if self._enq_ts:
                self._m_residence.observe(
                    time.monotonic() - self._enq_ts.popleft()
                )
        return item

    async def put(self, item) -> None:
        if not self._instrumented or not self.full():
            # Fast path: one branch over a plain Queue — no clock call.
            await super().put(item)
            return
        start = time.monotonic()
        await super().put(item)
        self._m_put_wait.observe(time.monotonic() - start)

    def put_nowait(self, item) -> None:
        try:
            super().put_nowait(item)
        except asyncio.QueueFull:
            if self._instrumented:
                self._m_full.inc()
            raise
