"""In-process metrics: counters, gauges, histograms, and stage tracing.

The reference ships no metrics at all — every number in its paper tables is
scraped from four log lines (benchmark/benchmark/logs.py), and this repo
inherited that: round 5's mis-measurement (32.6k tx/s at 3 s latency because
queues silently flooded, VERDICT.md §1) had to be reconstructed from log
archaeology.  This module is the first-class replacement: a dependency-free,
near-zero-overhead per-process registry that every layer (worker, network,
primary, consensus, store) writes into, plus

- :class:`SnapshotWriter` — periodic atomic rewrite of one
  ``metrics-<node>.json`` per process (write-temp + ``os.replace``, same
  pattern as the consensus checkpoint), final snapshot flushed on cancel;
- :class:`MetricsServer` — an optional Prometheus-text HTTP endpoint gated
  behind ``--metrics-port`` (hand-rolled over ``asyncio.start_server``:
  no http framework dependency);
- :class:`TraceTable` — a bounded per-digest stage-timestamp table that
  threads a sample-transaction trace through the whole pipeline
  (batch-sealed → quorum → digest-at-primary → header → certificate →
  committed), the per-stage latency breakdown the Narwhal paper uses to
  argue the digest-only critical path;
- :class:`HealthMonitor` — a declarative anomaly-rules engine evaluated
  on a timer over registry values (absolute ceilings, rate-of-change
  windows, per-peer thresholds) with hysteresis, feeding structured
  anomaly events to the log, a ``health`` section in snapshots, and the
  ``/healthz`` route (200/503) on the :class:`MetricsServer` — live
  detection of the wedges (stalled peer, quorum-waiter at 2f, backoff
  storm) that post-mortem snapshot archaeology only finds after the run.

Hot-path cost model: a counter ``inc`` is one attribute add, a histogram
``observe`` is one ``bisect`` + two adds; queue depths and sender backlogs
are *callback* gauges evaluated only when a snapshot is taken, so the hot
path never pays for them.  ``NARWHAL_METRICS=0`` swaps the whole registry
for shared no-op instruments — the stub the bench harness uses to measure
the instrumentation overhead itself.

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
from typing import (
    Callable,
    Deque,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

from .utils.clock import wall_now
from .utils.env import env_flag, env_float, env_int, env_str

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
# (commit_trigger → walk_done), and the commit's log up to the
# certificate's Committed line (walk_done → commit).
STAGES: Tuple[str, ...] = (
    "seal",               # worker: batch sealed (BatchMaker._seal)
    "quorum",             # worker: 2f+1 ACK stake reached (QuorumWaiter)
    "digest_at_primary",  # primary: own digest reached the Proposer
    "header",             # primary: digest included in a created header
    "cert",               # primary: own header's certificate assembled
    "cert_inserted",      # consensus: containing certificate entered Tusk
    "commit_trigger",     # consensus: the arrival that fired the commit rule
    "walk_done",          # consensus: chain walk + causal flatten finished
    "commit",             # consensus: just before its Committed line
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


# Detection-plane counters eligible for per-node attribution (the rule
# each feeds, for the judge's rule→observer join, lives with the sim
# verdict code).  Only consulted at instrument CONSTRUCTION time and only
# when a node scope is active — the production hot path never branches.
DETECTION_COUNTERS = frozenset({
    "primary.equivocations_detected",
    "primary.invalid_signatures",
    "primary.stale_messages",
    "worker.garbage_batches",
    "worker.helper_rejected_requests",
})


class _AttributedCounter:
    """Facade pairing the shared committee-wide counter with a per-node
    ``detect.<counter>.<node>`` shadow.  Handed out by
    ``Registry.counter`` instead of the base counter when a node scope
    (``Registry.node_scope``) is active at construction — which, in the
    single-process simulation, is exactly while one authority's
    components are being built, the only moment the observing node's
    identity exists.  The component holds the facade; readers (health
    rules, snapshots, tests) see the base counter through the registry
    as always."""

    __slots__ = ("_base", "_shadow")

    def __init__(self, base: Counter, shadow: Counter) -> None:
        self._base = base
        self._shadow = shadow

    @property
    def name(self) -> str:
        return self._base.name

    @property
    def value(self) -> int:
        return self._base.value

    def inc(self, n: int = 1) -> None:
        self._base.value += n
        self._shadow.value += n


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

    The post-mortem snapshot says *what the totals were*; the scraper
    timeline says *what the rates were*; neither says what the node was
    DOING in its last seconds.  The flight recorder keeps a bounded ring
    of recent structured events:

    - protocol landmarks — commit bursts (``Consensus.run``), round
      advances (``Proposer._advance``);
    - health-rule FIRING/cleared transitions (:class:`HealthMonitor`);
    - event-loop stalls (analysis/watchdog.py) and unhandled background
      task deaths (utils/tasks.py);
    - one ``tick`` per interval with the deltas that contextualize the
      rest: wire bytes in/out, commits, sealed txs, round, pending ACKs
      (the :meth:`run` loop, spawned by node/main.py).

    The ring rides in every registry snapshot (``flight.ring`` detail),
    answers live on ``GET /debug/flight`` (MetricsServer), and **dumps
    atomically to a file** (``NARWHAL_FLIGHT_DIR``) at the moments a
    post-mortem needs it most: the /healthz ok→failing (503) transition,
    SIGTERM, and an unhandled task death — the bench/fault harnesses set
    the directory and attach the dumps to failed verdict artifacts.

    Recording is one dict append into a deque; safe from any thread
    (deque.append is atomic), free when the registry is stubbed.
    """

    __slots__ = ("registry", "enabled", "events", "dumps", "dir", "node_id",
                 "_m_events", "_m_dumps", "_last_tick", "_seq")

    def __init__(self, reg: "Registry", cap: Optional[int] = None) -> None:
        self.registry = reg
        # NARWHAL_FLIGHT=0 stubs the recorder alone (the A/B overhead
        # arm's knob), NARWHAL_METRICS=0 stubs it with everything else.
        self.enabled = reg.enabled and env_flag("NARWHAL_FLIGHT")
        if cap is None:
            cap = env_int("NARWHAL_FLIGHT_CAP")
        self.events: Deque[dict] = collections.deque(maxlen=max(16, cap))
        self.dumps: List[dict] = []  # [{reason, ts, path}] — dump markers
        self.dir: Optional[str] = env_str("NARWHAL_FLIGHT_DIR")
        self.node_id = ""  # node/main.py stamps role-keyprefix
        self._last_tick: Dict[str, float] = {}
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

    def tick(self) -> None:
        """One per-interval sample: deltas of the counters that explain
        the landmark events around them (wire/queue pressure, progress).
        Cheap — a handful of dict lookups over the live registry."""
        if not self.enabled:
            return
        reg = self.registry
        cur: Dict[str, float] = {
            "wire_out_b": sum(
                c.value for n, c in reg.counters.items()
                if n.startswith("wire.out.bytes.")
                or n.startswith("wire.out.retransmit_bytes.")
            ),
            "wire_in_b": sum(
                c.value for n, c in reg.counters.items()
                if n.startswith("wire.in.bytes.")
            ),
            "commits": float(
                reg.counters.get(
                    "consensus.committed_certificates", _NULL
                ).value
            ),
            "batches": float(
                reg.counters.get(
                    "consensus.committed_batch_digests", _NULL
                ).value
            ),
            "txs_sealed": float(
                reg.counters.get("worker.txs_sealed", _NULL).value
            ),
        }
        deltas = {
            k: round(v - self._last_tick.get(k, 0.0), 1)
            for k, v in cur.items()
        }
        self._last_tick = cur
        gauges = {}
        rnd = reg.gauges.get("primary.round")
        if rnd is not None:
            gauges["round"] = rnd.value
        acks = reg.gauges.get("net.reliable.pending_acks")
        if acks is not None:
            gauges["pending_acks"] = acks.value
        # InstrumentedQueue depths: only the non-empty channels, so the
        # ring entry stays small in steady state and a filling queue is
        # visible in the last-seconds record a crash dump preserves.
        qdepth = {
            n[len("queue."):-len(".depth")]: g.value
            for n, g in reg.gauges.items()
            if n.startswith("queue.") and n.endswith(".depth") and g.value
        }
        if qdepth:
            gauges["queues"] = qdepth
        self.record("tick", d=deltas, **gauges)

    async def run(self, interval_s: Optional[float] = None) -> None:
        """The tick loop (node/main.py spawns one per process)."""
        if interval_s is None:
            interval_s = env_float("NARWHAL_FLIGHT_INTERVAL_S")
        while True:
            await asyncio.sleep(interval_s)
            self.tick()

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
        self._last_tick.clear()
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
        # Active node-attribution scope (see node_scope): None in
        # production; the sim sets it around each authority's spawn.
        self._node_scope: Optional[str] = None
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
        # Attached HealthMonitor (node/main.py wires one per process);
        # snapshots then carry a `health` section and the MetricsServer
        # answers /healthz from it.
        self.health: Optional["HealthMonitor"] = None
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
        if self._node_scope is not None and name in DETECTION_COUNTERS:
            shadow = f"detect.{name}.{self._node_scope}"
            s = self.counters.get(shadow)
            if s is None:
                s = self.counters[shadow] = Counter(shadow)
            return _AttributedCounter(c, s)  # type: ignore[return-value]
        return c

    def node_scope(self, label: str):
        """Scope instrument construction to one node of an in-process
        committee: DETECTION_COUNTERS fetched inside the scope also feed
        a per-node ``detect.<counter>.<label>`` shadow, so a shared-
        registry harness can name WHICH validator observed the evidence
        behind a fired rule instead of only that the committee did.
        Spawns are sequential in the sim, so a plain attribute (no
        contextvar) is sufficient; production node processes never open
        a scope and pay nothing."""
        registry = self

        class _Scope:
            def __enter__(self):
                self._prev = registry._node_scope
                registry._node_scope = label
                return registry

            def __exit__(self, *exc):
                registry._node_scope = self._prev

        return _Scope()

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
        # A monitor attached by a previous test would otherwise keep
        # reporting rule state over the zeroed instruments.
        self.health = None

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
        if self.health is not None:
            health = call("health", self.health.health_snapshot)
            if health is not None:
                snap["health"] = health
        if errors:
            snap["errors"] = errors
        return snap

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4).  Dotted names become
        underscore-joined with a ``narwhal_`` prefix; counters get the
        ``_total`` suffix, histograms the ``_bucket/_sum/_count`` triple."""

        def mangle(name: str) -> str:
            # ':' covers per-peer instruments whose names embed a peer
            # address (net.reliable.peer.*.<host:port>).
            return "narwhal_" + (
                name.replace(".", "_").replace("-", "_").replace(":", "_")
            )

        lines: List[str] = []
        for n, c in sorted(self.counters.items()):
            m = mangle(n) + "_total"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {c.value}")
        gauges = {n: g.value for n, g in self.gauges.items()}
        for n, fn in self.gauge_fns.items():
            try:
                gauges[n] = fn()
            except Exception:
                continue
        for n in sorted(gauges):
            m = mangle(n)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {gauges[n]}")
        for n, h in sorted(self.histograms.items()):
            m = mangle(n)
            lines.append(f"# TYPE {m} histogram")
            for bound, acc in h.cumulative():
                le = "+Inf" if bound == float("inf") else repr(float(bound))
                lines.append(f'{m}_bucket{{le="{le}"}} {acc}')
            lines.append(f"{m}_sum {h.sum}")
            lines.append(f"{m}_count {h.count}")
        return "\n".join(lines) + "\n"


# -- live health: declarative anomaly rules over the registry -----------------

class HealthRule:
    """One anomaly rule with hysteresis.

    ``check(ctx)`` returns ``{subject: detail}`` for every breaching
    subject — ``""`` for node-wide rules, a peer address for per-peer
    rules — where ``detail`` is a small JSON dict (observed value,
    threshold).  The monitor owns the hysteresis: a subject must breach
    ``for_intervals`` consecutive evaluations to start FIRING and pass
    ``clear_intervals`` consecutive clean evaluations to clear, so one
    noisy sample can neither raise nor silence an anomaly (no flapping).

    ``series`` names counters/gauges whose history the monitor must keep
    (exact names or ``prefix.*`` patterns) so the rule can ask for rates
    and change ages; rules reading only instantaneous values leave it
    empty.
    """

    def __init__(
        self,
        name: str,
        check: Callable[["HealthContext"], Dict[str, dict]],
        for_intervals: int = 1,
        clear_intervals: int = 2,
        series: Sequence[str] = (),
    ) -> None:
        self.name = name
        self.check = check
        self.for_intervals = max(1, for_intervals)
        self.clear_intervals = max(1, clear_intervals)
        self.series = tuple(series)


def _lookup_value(reg: Registry, name: str) -> Optional[float]:
    """One definition of the instrument-resolution chain every health
    read uses: counter → plain gauge → callback gauge (a failing
    callback reads as absent, same policy as the snapshot path)."""
    c = reg.counters.get(name)
    if c is not None:
        return float(c.value)
    g = reg.gauges.get(name)
    if g is not None:
        return float(g.value)
    fn = reg.gauge_fns.get(name)
    if fn is not None:
        try:
            return float(fn())
        except Exception:
            return None
    return None


class HealthContext:
    """What a rule's ``check`` sees: instantaneous registry values plus
    the monitor's sampled history (rates, change ages)."""

    def __init__(self, monitor: "HealthMonitor", now: float) -> None:
        self._m = monitor
        self.now = now

    def counter(self, name: str) -> Optional[float]:
        c = self._m.registry.counters.get(name)
        return float(c.value) if c is not None else None

    def gauge(self, name: str) -> Optional[float]:
        g = self._m.registry.gauges.get(name)
        if g is not None or name in self._m.registry.gauge_fns:
            return _lookup_value(self._m.registry, name)
        return None

    def gauges_prefixed(self, prefix: str) -> Dict[str, float]:
        """{suffix: value} for every plain gauge under ``prefix``."""
        return {
            n[len(prefix):]: float(g.value)
            for n, g in self._m.registry.gauges.items()
            if n.startswith(prefix)
        }

    def rate(self, name: str, window_s: float) -> Optional[float]:
        """Per-second net change of a sampled series over ``window_s``.
        None until the history actually SPANS the window: a rate
        computed over a shorter early span would over-weight one bursty
        tick (e.g. boot-time reconnect retransmissions) against a
        threshold tuned for the full window — rules stay silent for the
        first ``window_s`` after monitor start instead of false-firing.
        """
        hist = self._m._history.get(name)
        if not hist or len(hist) < 2:
            return None
        newest_t, newest_v = hist[-1]
        for t, v in reversed(hist):
            if newest_t - t >= window_s:
                return (newest_v - v) / (newest_t - t)
        return None

    def rates_prefixed(
        self, prefix: str, window_s: float
    ) -> Dict[str, float]:
        out = {}
        for name in self._m._history:
            if name.startswith(prefix):
                r = self.rate(name, window_s)
                if r is not None:
                    out[name[len(prefix):]] = r
        return out

    def last_change_age(self, name: str) -> Optional[float]:
        """Seconds since the sampled series last changed value (first
        sample counts as a change, so the age is bounded by monitor
        uptime)."""
        rec = self._m._last_change.get(name)
        if rec is None:
            return None
        return self.now - rec[1]


def default_rules(env: Optional[Mapping[str, str]] = None) -> List[HealthRule]:
    """The built-in rule set; every threshold has a NARWHAL_HEALTH_* env
    override (documented in README 'Observability')."""
    def f(key: str, default: float) -> float:
        # The registry (utils/env.py) declares the same default; passing
        # it here too keeps each threshold readable next to its rule.
        return float(env_float(key, default, env=env))

    lag_max = f("NARWHAL_HEALTH_MAX_COMMIT_LAG", 20)
    stall_s = f("NARWHAL_HEALTH_COMMIT_STALL_S", 10)
    ack_floor = f("NARWHAL_HEALTH_PENDING_ACK_FLOOR", 512)
    ack_window = f("NARWHAL_HEALTH_PENDING_ACK_WINDOW_S", 5)
    retrans_max = f("NARWHAL_HEALTH_PEER_RETRANS_RATE", 10)
    retrans_window = f("NARWHAL_HEALTH_PEER_RETRANS_WINDOW_S", 5)
    peer_failures = f("NARWHAL_HEALTH_PEER_FAILURES", 3)
    quorum_wedge_s = f("NARWHAL_HEALTH_QUORUM_WEDGE_S", 10)
    vote_window = f("NARWHAL_HEALTH_VOTE_SILENCE_WINDOW_S", 8)
    vote_min_rounds = f("NARWHAL_HEALTH_VOTE_SILENCE_MIN_ROUNDS", 3)
    # 6/s, not the original 2/s: a node catching up after a healed
    # partition replays its backlog at a measured 2.4-2.9 stale
    # messages/s (the wan_partition_heal scenario's healed node FIRED
    # transiently at the old default — ROADMAP item 4's named
    # follow-up), while the replay-flood attack this rule exists for
    # measures an order of magnitude higher (byz_replay_stale re-sends
    # at 10/s per peer).  6/s sits ~2x above the heal burst and still
    # comfortably under the attack floor.
    stale_rate_max = f("NARWHAL_HEALTH_STALE_RATE", 6)
    stale_window = f("NARWHAL_HEALTH_STALE_WINDOW_S", 5)
    # Worker plane: how long a requested-but-unserved batch may age
    # before it reads as withholding.  The default sits above the stock
    # sync_retry_delay (5 s) so an ordinary first-retry window stays
    # silent; withholding scenarios lower it alongside a raised retry
    # delay to make the starvation unambiguous.
    sync_age_max = f("NARWHAL_HEALTH_SYNC_AGE_S", 8)
    # Backpressure plane (InstrumentedQueue channels).  A channel reads
    # as saturated when its live depth crosses RATIO of capacity; the
    # MIN_CAP floor excludes channels that run full BY DESIGN — the
    # worker's QUORUM_WINDOW admission queue (depth 8) and the sim's
    # depth-1 race-forcing channels use fullness as their backpressure
    # MECHANISM, so fullness there is operation, not anomaly.
    queue_sat_ratio = f("NARWHAL_HEALTH_QUEUE_SAT_RATIO", 0.9)
    queue_sat_min_cap = f("NARWHAL_HEALTH_QUEUE_SAT_MIN_CAP", 16)
    queue_sat_intervals = f("NARWHAL_HEALTH_QUEUE_SAT_INTERVALS", 3)
    ingress_drop_rate = f("NARWHAL_HEALTH_INGRESS_DROP_RATE", 1.0)
    ingress_drop_window = f("NARWHAL_HEALTH_INGRESS_DROP_WINDOW_S", 5)

    def commit_lag(ctx: HealthContext) -> Dict[str, dict]:
        v = ctx.gauge("consensus.commit_lag_rounds")
        if v is not None and v > lag_max:
            return {"": {"commit_lag_rounds": v, "threshold": lag_max}}
        return {}

    def commit_stall(ctx: HealthContext) -> Dict[str, dict]:
        # Guarded on round > 2: a freshly booted or idle committee has
        # legitimately committed nothing yet; once the DAG is past its
        # first leader round, zero commit progress means a wedge.
        rnd = ctx.gauge("primary.round")
        if rnd is None or rnd <= 2:
            return {}
        age = ctx.last_change_age("consensus.committed_certificates")
        if age is not None and age > stall_s:
            return {
                "": {
                    "seconds_without_commit": round(age, 1),
                    "threshold": stall_s,
                    "round": rnd,
                }
            }
        return {}

    def pending_acks(ctx: HealthContext) -> Dict[str, dict]:
        v = ctx.gauge("net.reliable.pending_acks")
        if v is None or v < ack_floor:
            return {}
        growth = ctx.rate("net.reliable.pending_acks", ack_window)
        if growth is not None and growth > 0:
            return {
                "": {
                    "pending_acks": v,
                    "floor": ack_floor,
                    "growth_per_s": round(growth, 2),
                }
            }
        return {}

    def peer_retransmissions(ctx: HealthContext) -> Dict[str, dict]:
        out = {}
        for peer, rate in ctx.rates_prefixed(
            "net.reliable.peer.retransmissions.", retrans_window
        ).items():
            if rate > retrans_max:
                out[peer] = {
                    "retransmissions_per_s": round(rate, 2),
                    "threshold": retrans_max,
                }
        return out

    def quorum_wedge(ctx: HealthContext) -> Dict[str, dict]:
        # A worker's QuorumWaiter stuck mid-batch (e.g. at 2f stake with
        # the last ACK never arriving) previously showed only indirectly
        # via pending-ACK growth; the wait-age gauge names the wedge
        # directly, with the acked stake vs threshold in the detail.
        age = ctx.gauge("worker.quorum_wait_age_seconds")
        if age is None or age <= quorum_wedge_s:
            return {}
        detail = {
            "seconds_waiting": round(age, 1),
            "threshold": quorum_wedge_s,
        }
        stake = ctx.gauge("worker.quorum_acked_stake")
        need = ctx.gauge("worker.quorum_threshold")
        if stake is not None:
            detail["acked_stake"] = stake
        if need is not None:
            detail["quorum_threshold"] = need
        return {"": detail}

    # -- Byzantine-fault detections (fault-injection suite, ISSUE 6).
    # The first two latch: they read monotone counters of events that a
    # healthy committee NEVER produces, so once proven the anomaly stays
    # raised (there is no "un-equivocating").

    def equivocation(ctx: HealthContext) -> Dict[str, dict]:
        v = ctx.counter("primary.equivocations_detected")
        if v:
            return {"": {"equivocations_detected": v}}
        return {}

    def invalid_signature(ctx: HealthContext) -> Dict[str, dict]:
        v = ctx.counter("primary.invalid_signatures")
        if v:
            return {"": {"invalid_signatures": v}}
        return {}

    def peer_vote_silence(ctx: HealthContext) -> Dict[str, dict]:
        # A peer that votes for NONE of our headers while the DAG keeps
        # advancing is withholding (or wedged) — either way a named
        # anomaly.  Gated on real round progress over the window so an
        # idle or booting committee stays silent.
        rnd_rate = ctx.rate("primary.round", vote_window)
        if rnd_rate is None or rnd_rate * vote_window < vote_min_rounds:
            return {}
        out = {}
        for peer, rate in ctx.rates_prefixed(
            "primary.peer_votes.", vote_window
        ).items():
            if rate <= 0:
                out[peer] = {
                    "rounds_advanced": round(rnd_rate * vote_window, 1),
                    "window_s": vote_window,
                }
        return out

    def stale_replay(ctx: HealthContext) -> Dict[str, dict]:
        # Past-GC-horizon messages trickling in is normal for a lagging
        # peer; a sustained RATE of them is a replay flood.
        rate = ctx.rate("primary.stale_messages", stale_window)
        if rate is not None and rate > stale_rate_max:
            return {
                "": {
                    "stale_per_s": round(rate, 2),
                    "threshold": stale_rate_max,
                }
            }
        return {}

    # -- worker-plane availability detections (fault suite, ISSUE 8).
    # The first reads the synchronizer's oldest-unserved age (a live
    # gauge: it clears when the batch finally lands); the other two latch
    # on monotone counters of events an honest committee never produces,
    # like the equivocation/invalid_signature pair.

    def batch_withholding(ctx: HealthContext) -> Dict[str, dict]:
        # A certificate is a proof of batch availability — a requested
        # digest that stays unserved past the threshold means some quorum
        # ACKer is not serving the bytes it vouched for (or the fetch
        # plane is wedged); either way the availability claim is being
        # violated live.
        age = ctx.gauge("worker.unserved_sync_age_seconds")
        if age is not None and age > sync_age_max:
            return {
                "": {
                    "unserved_sync_age_s": round(age, 1),
                    "threshold": sync_age_max,
                }
            }
        return {}

    def helper_abuse(ctx: HealthContext) -> Dict[str, dict]:
        # Over-limit BatchRequests: the honest requesting side chunks
        # under the Helper cap, so any truncation is a peer exploiting
        # the request→reply amplification (sync_flood).
        v = ctx.counter("worker.helper_rejected_requests")
        if v:
            return {"": {"rejected_requests": v}}
        return {}

    def garbage_batches(ctx: HealthContext) -> Dict[str, dict]:
        # Oversized batch frames rejected by the size gate: an honest
        # worker's seals are bounded by batch_size, so these bytes are
        # junk someone is trying to make us hash and persist.
        v = ctx.counter("worker.garbage_batches")
        if v:
            return {"": {"garbage_batches": v}}
        return {}

    def peer_unreachable(ctx: HealthContext) -> Dict[str, dict]:
        out = {}
        for peer, v in ctx.gauges_prefixed(
            "net.reliable.peer.consecutive_failures."
        ).items():
            if v >= peer_failures:
                out[peer] = {
                    "consecutive_failures": v,
                    "threshold": peer_failures,
                }
        return out

    def queue_saturated(ctx: HealthContext) -> Dict[str, dict]:
        # One subject per channel, so a firing names the saturating
        # channel directly — the health-side mirror of the knee matrix's
        # first_saturating attribution.  Depth and capacity are the
        # plain gauges InstrumentedQueue maintains on every put/get.
        out = {}
        prefixed = ctx.gauges_prefixed("queue.")
        for name, depth in prefixed.items():
            if not name.endswith(".depth"):
                continue
            channel = name[: -len(".depth")]
            cap = prefixed.get(channel + ".capacity")
            if not cap or cap < queue_sat_min_cap:
                continue
            if depth >= queue_sat_ratio * cap:
                detail = {
                    "depth": depth,
                    "capacity": cap,
                    "fill_ratio": round(depth / cap, 3),
                    "threshold_ratio": queue_sat_ratio,
                }
                hw = prefixed.get(channel + ".high_water")
                if hw is not None:
                    detail["high_water"] = hw
                out[channel] = detail
        return out

    def ingress_drops(ctx: HealthContext) -> Dict[str, dict]:
        # Client-ingress overflow RATE, not the monotone total: a brief
        # burst parked by the BatchMaker's pause/drain cycle is normal
        # operation; a sustained overflow rate means offered load is
        # past the admission plane's capacity.
        rate = ctx.rate("worker.ingress_overflow", ingress_drop_window)
        if rate is not None and rate > ingress_drop_rate:
            return {
                "": {
                    "overflows_per_s": round(rate, 2),
                    "threshold": ingress_drop_rate,
                    "window_s": ingress_drop_window,
                }
            }
        return {}

    return [
        HealthRule("commit_lag", commit_lag, for_intervals=2),
        HealthRule(
            "commit_stall",
            commit_stall,
            series=("consensus.committed_certificates",),
        ),
        HealthRule(
            "pending_ack_growth",
            pending_acks,
            for_intervals=2,
            series=("net.reliable.pending_acks",),
        ),
        HealthRule(
            "peer_retransmission_spike",
            peer_retransmissions,
            for_intervals=2,
            series=("net.reliable.peer.retransmissions.*",),
        ),
        # for_intervals=1: a dead peer must be named within ONE
        # evaluation interval of the failure gauge crossing the
        # threshold (the failover tier-1 test pins this down).
        HealthRule("peer_unreachable", peer_unreachable, for_intervals=1),
        # for_intervals=2: the wait-age gauge is itself a duration (the
        # threshold debounces), but one extra interval rides out a
        # callback-gauge sample racing the waiter's release.
        HealthRule("quorum_wedge", quorum_wedge, for_intervals=2),
        # for_intervals=1: an equivocation/rogue signature is PROVEN by a
        # single event (we hold the signed statements) — no debounce.
        HealthRule("equivocation", equivocation),
        HealthRule("invalid_signature", invalid_signature),
        HealthRule(
            "peer_vote_silence",
            peer_vote_silence,
            for_intervals=2,
            series=("primary.round", "primary.peer_votes.*"),
        ),
        HealthRule(
            "stale_replay",
            stale_replay,
            for_intervals=2,
            series=("primary.stale_messages",),
        ),
        # for_intervals=2: the age gauge is a duration (the threshold
        # debounces) but one extra interval rides out a sample racing the
        # arrival-waiter's release, like quorum_wedge.
        HealthRule("batch_withholding", batch_withholding, for_intervals=2),
        # Latching, like equivocation: a single over-limit request or
        # oversized batch frame is already proof of hostile traffic.
        HealthRule("helper_abuse", helper_abuse),
        HealthRule("garbage_batches", garbage_batches),
        # Hysteresis (default 3 intervals): a channel legitimately
        # brushes its capacity during a burst-drain cycle; only a queue
        # that STAYS at the ceiling across evaluations is saturated.
        HealthRule(
            "queue_saturated",
            queue_saturated,
            for_intervals=max(1, int(queue_sat_intervals)),
        ),
        HealthRule(
            "ingress_drops",
            ingress_drops,
            for_intervals=2,
            series=("worker.ingress_overflow",),
        ),
    ]


class HealthMonitor:
    """Evaluates a rule set over the registry on a timer.

    Each evaluation samples the watched series (for rates and change
    ages), runs every rule, applies hysteresis per (rule, subject), and
    on FIRING/cleared transitions emits one structured anomaly event —
    a WARNING/INFO log line prefixed ``HEALTH`` plus an entry in the
    bounded ``events`` ring.  ``health_snapshot()`` is what lands in the
    registry snapshot's ``health`` section and behind ``/healthz``:

        {"status": "ok"|"failing", "evaluations": N, "interval_s": s,
         "firing": [{"rule", "subject", "since", "detail"}, …],
         "events": [last 64 transitions]}

    Not spawned by default: node/main.py attaches one per process
    (``registry().health = monitor``) unless NARWHAL_HEALTH=0.
    """

    HISTORY_CAP = 128  # samples kept per watched series

    def __init__(
        self,
        reg: Registry,
        rules: Optional[List[HealthRule]] = None,
        interval_s: Optional[float] = None,
    ) -> None:
        self.registry = reg
        self.rules = default_rules() if rules is None else rules
        self.interval_s = (
            env_float("NARWHAL_HEALTH_INTERVAL")
            if interval_s is None
            else interval_s
        )
        self.evaluations = 0
        self._was_ok = True
        self.events: Deque[dict] = collections.deque(maxlen=64)
        # (rule, subject) -> {breaches, oks, firing, since, detail}
        self._state: Dict[Tuple[str, str], dict] = {}
        self._history: Dict[str, Deque[Tuple[float, float]]] = {}
        self._last_change: Dict[str, Tuple[float, float]] = {}  # (value, t)
        self._watch_names: List[str] = []
        self._watch_prefixes: List[str] = []
        for rule in self.rules:
            for s in rule.series:
                if s.endswith(".*"):
                    self._watch_prefixes.append(s[:-1])  # keep the dot
                else:
                    self._watch_names.append(s)

    # -- sampling -------------------------------------------------------------

    def _watched_values(self) -> Dict[str, float]:
        reg = self.registry
        out: Dict[str, float] = {}
        for name in self._watch_names:
            v = _lookup_value(reg, name)
            if v is not None:
                out[name] = v
        for prefix in self._watch_prefixes:
            for pool in (reg.counters, reg.gauges):
                for name, inst in pool.items():
                    if name.startswith(prefix):
                        out[name] = float(inst.value)
        return out

    def _sample(self, now: float) -> None:
        for name, v in self._watched_values().items():
            hist = self._history.get(name)
            if hist is None:
                hist = self._history[name] = collections.deque(
                    maxlen=self.HISTORY_CAP
                )
            hist.append((now, v))
            last = self._last_change.get(name)
            if last is None or last[0] != v:
                self._last_change[name] = (v, now)

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the currently-firing anomalies.
        ``now`` is injectable so tests drive rate windows and stall ages
        deterministically."""
        now = time.time() if now is None else now
        self._sample(now)
        ctx = HealthContext(self, now)
        for rule in self.rules:
            try:
                breaches = rule.check(ctx)
            except Exception:
                # A rule crashing on a half-torn-down registry must not
                # kill the monitor loop.
                log.exception("health rule %s failed to evaluate", rule.name)
                continue
            subjects = set(breaches)
            subjects.update(
                s for (r, s) in self._state if r == rule.name
            )
            for subject in subjects:
                key = (rule.name, subject)
                st = self._state.get(key)
                if st is None:
                    st = self._state[key] = {
                        "breaches": 0,
                        "oks": 0,
                        "firing": False,
                        "since": None,
                        "detail": {},
                    }
                if subject in breaches:
                    st["breaches"] += 1
                    st["oks"] = 0
                    st["detail"] = breaches[subject]
                    if (
                        not st["firing"]
                        and st["breaches"] >= rule.for_intervals
                    ):
                        st["firing"] = True
                        st["since"] = now
                        self._transition("FIRING", rule.name, subject, st, now)
                else:
                    st["oks"] += 1
                    st["breaches"] = 0
                    if st["firing"] and st["oks"] >= rule.clear_intervals:
                        st["firing"] = False
                        self._transition(
                            "cleared", rule.name, subject, st, now
                        )
                        st["since"] = None
                    if not st["firing"] and st["oks"] >= rule.clear_intervals:
                        # Fully quiet subject: drop it so per-peer state
                        # stays bounded over churn.
                        self._state.pop(key, None)
        self.evaluations += 1
        # The /healthz ok→failing edge IS the 503 transition: the moment
        # the flight ring is most valuable (the events leading up to the
        # first firing rule), so it dumps right here — before anything
        # else can crash, restart, or truncate the node.
        now_ok = self.ok()
        if self._was_ok and not now_ok:
            self.registry.flight.dump("healthz-503")
        self._was_ok = now_ok
        return self.firing()

    def _transition(
        self, kind: str, rule: str, subject: str, st: dict, now: float
    ) -> None:
        # `now` is the evaluation clock (injectable in tests), so event
        # timestamps join against the firing entries' `since` values.
        event = {
            "event": kind,
            "rule": rule,
            "subject": subject,
            "t": round(now, 3),
            "detail": dict(st["detail"]),
        }
        self.events.append(event)
        # Health transitions are flight-ring landmarks: the recorder's
        # tick deltas around a FIRING edge are the post-mortem.
        self.registry.flight.record(
            "health", event=kind, rule=rule, subject=subject,
            detail=dict(st["detail"]),
        )
        msg = "HEALTH anomaly %s rule=%s%s detail=%s"
        sub = f" subject={subject}" if subject else ""
        if kind == "FIRING":
            log.warning(msg, kind, rule, sub, json.dumps(st["detail"]))
        else:
            log.info(msg, kind, rule, sub, json.dumps(st["detail"]))

    # -- export ---------------------------------------------------------------

    def firing(self) -> List[dict]:
        return [
            {
                "rule": rule,
                "subject": subject,
                "since": st["since"],
                "detail": dict(st["detail"]),
            }
            for (rule, subject), st in sorted(self._state.items())
            if st["firing"]
        ]

    def ok(self) -> bool:
        return not any(st["firing"] for st in self._state.values())

    def health_snapshot(self) -> dict:
        firing = self.firing()
        return {
            "status": "ok" if not firing else "failing",
            "evaluations": self.evaluations,
            "interval_s": self.interval_s,
            "firing": firing,
            "events": list(self.events),
        }

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            self.evaluate()


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


# -- snapshot writer ----------------------------------------------------------

class SnapshotWriter:
    """Periodically rewrite ``path`` with the registry snapshot.

    Atomic rewrite (write temp + ``os.replace``) so a reader — the bench
    harness polling mid-run, or an operator's ``watch cat`` — never sees a
    torn JSON document.  No fsync: the snapshot is an observability
    artifact, not durable state (unlike the consensus checkpoint, losing
    one interval to power loss costs nothing).  A final snapshot is
    flushed on cancellation so teardown captures the complete run.

    Cost control on the committee's shared core: counters/gauges/
    histograms are a few kB and serialize in <1 ms every interval, but the
    stage-trace table reaches hundreds of kB on a bench run (~12-22 ms of
    json.dumps per rewrite on a slow core — measured to dent committee
    TPS by ~10% at 1 Hz across 8 processes).  The trace is therefore
    included only every ``trace_every``-th rewrite (staleness bounded at
    ``trace_every × interval_s`` for a SIGKILLed node) and in the final
    cancellation flush, which is what the bench cross-validation reads.
    """

    def __init__(
        self,
        reg: Registry,
        path: str,
        interval_s: float = 1.0,
        trace_every: int = 10,
    ) -> None:
        self.registry = reg
        self.path = path
        self.interval_s = interval_s
        self.trace_every = max(1, trace_every)
        self._ticks = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write_once(self, include_trace: bool = True) -> None:
        # Serialize to one string first: json.dump streams thousands of
        # tiny f.write chunks (measured ~2× the dumps+single-write cost
        # with a loaded trace table).
        body = json.dumps(self.registry.snapshot(include_trace))
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, self.path)

    async def run(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.interval_s)
                self._ticks += 1
                try:
                    self.write_once(
                        include_trace=(self._ticks % self.trace_every == 0)
                    )
                except OSError:
                    # A transient write failure (ENOSPC clearing, tmp-dir
                    # hiccup) must not kill the loop for the rest of the
                    # run — the next interval retries.
                    log.exception(
                        "periodic metrics snapshot to %s failed", self.path
                    )
        finally:
            # Teardown flush: the harness reads post-mortem totals and the
            # full stage trace from this final write (cross-validation
            # needs the whole run, not the last whole interval).
            try:
                self.write_once(include_trace=True)
            except OSError:
                log.exception("final metrics snapshot to %s failed", self.path)


# -- Prometheus-text HTTP endpoint --------------------------------------------

class MetricsServer:
    """Minimal HTTP server: ``GET /metrics`` → Prometheus text,
    ``GET /metrics.json`` → the JSON snapshot (``?trace=0`` omits the
    heavyweight stage-trace table — what the bench scraper polls at
    1 Hz), ``GET /healthz`` → 200/503 + the attached HealthMonitor's
    JSON (503 iff any rule is firing; 200 with ``status: unmonitored``
    when no monitor is attached), ``GET /debug/flight`` → the flight
    recorder's live event ring (what the node was doing in its last
    seconds — pulled by the bench scraper at quiesce).  Anything else
    is 404.

    Hand-rolled over ``asyncio.start_server`` — the container bakes no
    http framework, and a scrape endpoint needs exactly one request per
    connection (Connection: close).

    Binds localhost by default: the endpoint is unauthenticated (and the
    snapshot's detail section names peer addresses), so it follows the
    same convention as every other listener here — NARWHAL_BIND_ANY=1
    widens it to 0.0.0.0 for scrapers on other hosts (receiver.py)."""

    def __init__(self, reg: Registry) -> None:
        self.registry = reg
        self._server: Optional[asyncio.AbstractServer] = None

    @classmethod
    async def spawn(
        cls, reg: Registry, port: int, host: Optional[str] = None
    ) -> "MetricsServer":
        if host is None:
            host = (
                "0.0.0.0"
                if env_flag("NARWHAL_BIND_ANY")
                else "127.0.0.1"
            )
        self = cls(reg)
        self._server = await asyncio.start_server(self._handle, host, port)
        log.info("Metrics endpoint listening on %s:%d", host, self.port)
        return self

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = request.decode("latin-1", "replace").split()
            target = parts[1] if len(parts) >= 2 else ""
            # Drain the header block (ignored) so the client sees a clean
            # close instead of a reset.  Bounded: a client streaming
            # endless garbage lines must not pin this handler forever.
            for _ in range(100):
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            else:
                return  # header flood; drop the connection
            path, _, query = target.partition("?")
            params = dict(
                kv.split("=", 1) for kv in query.split("&") if "=" in kv
            )
            if path == "/metrics":
                body = self.registry.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                status = "200 OK"
            elif path == "/metrics.json":
                body = json.dumps(
                    self.registry.snapshot(
                        include_trace=params.get("trace") != "0"
                    )
                ).encode()
                ctype = "application/json"
                status = "200 OK"
            elif path == "/debug/flight":
                # The flight ring, live: what the node was doing in its
                # last seconds, pullable without waiting for a dump
                # trigger (the scraper reads this at quiesce).
                body = json.dumps(
                    {
                        "ts": time.time(),
                        "pid": os.getpid(),
                        **self.registry.flight.snapshot(),
                    }
                ).encode()
                ctype = "application/json"
                status = "200 OK"
            elif path == "/healthz":
                monitor = self.registry.health
                if monitor is None:
                    payload: dict = {"status": "unmonitored", "firing": []}
                    status = "200 OK"
                else:
                    payload = monitor.health_snapshot()
                    status = (
                        "200 OK"
                        if payload["status"] == "ok"
                        else "503 Service Unavailable"
                    )
                body = json.dumps(payload).encode()
                ctype = "application/json"
            else:
                body = b"not found\n"
                ctype = "text/plain"
                status = "404 Not Found"
            writer.write(
                (
                    f"HTTP/1.1 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode()
                + body
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError, ValueError):
            # ValueError: readline() on an over-long request/header line
            # (stream limit overrun) — scraping garbage must not leave an
            # unhandled-task ERROR in a benchmarked node's log.
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
