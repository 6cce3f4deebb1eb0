"""The NARWHAL_* environment-variable registry and its typed accessors.

Every env knob the port reads is DECLARED here — name, type, documented
default, one doc line — and read through the typed accessors below; an
undeclared name raises at the read.  The port declares only the knobs
its own modules read: the reference's registry
(``narwhal_tpu/utils/env.py``) holds the rest.  Two consumers keep the
registry honest:

- the port's invariant linter (``python -m narwhal_tpu_torch.analysis``):
  any ``NARWHAL_*`` literal in the port that is not declared here fails
  the ``env-var-registry`` rule, as does a direct ``os.environ`` read
  outside this module and a declared entry nothing reads;
- the port's README table is generated from this registry
  (``python -m narwhal_tpu_torch.analysis --env-table``) and
  drift-checked by the same lint run.

Stdlib only: the linter executes this file to render the table.

Parsing behavior shared by every accessor: accept a valid override, fall
back LOUDLY on garbage, and warn once per (name, raw value) rather than
at call-site frequency.  Flags parse uniformly: unset → the declared
default; set → false only for ``0``/empty/``false``/``no``/``off``
(case-insensitive), true otherwise.
"""

from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

log = logging.getLogger("narwhal.config")

_UNSET = object()


@dataclass(frozen=True)
class EnvVar:
    """One declared knob.  ``default`` is the value the accessors fall
    back to when the variable is unset (``None`` = no value / feature
    off)."""

    name: str
    kind: str  # "flag" | "int" | "float" | "str"
    default: object
    doc: str

    @property
    def rendered_default(self) -> str:
        if self.default is None:
            return "unset"
        if self.kind == "flag":
            return "1" if self.default else "0"
        return str(self.default)


_VARS = [
    # -- core runtime ---------------------------------------------------------
    EnvVar(
        "NARWHAL_BIND_ANY", "flag", False,
        "Listen on 0.0.0.0 instead of the advertised committee IP "
        "(NAT'd/cloud hosts); applies to every listener including the "
        "metrics endpoint.",
    ),
    EnvVar(
        "NARWHAL_LOG", "str", None,
        "Log level for the whole `narwhal.*` hierarchy (equivalent of "
        "`node run --log-level`; wins over `-v`).",
    ),
    EnvVar(
        "NARWHAL_VOTE_FAST_PATH", "flag", True,
        "`0` restores per-header vote persists instead of the coalesced "
        "once-per-burst vote-log flush (round-cadence fast path).",
    ),
    EnvVar(
        "NARWHAL_NET_BACKOFF_MAX_S", "float", 60.0,
        "Reconnect-backoff ceiling in seconds (floor 0.2 s). Lower it "
        "for fault scenarios / latency-sensitive deployments so healed "
        "partitions are noticed quickly.",
    ),
    EnvVar(
        "NARWHAL_CHANNEL_CAPACITY", "int", 1_000,
        "Bounded-queue capacity for every inter-task channel "
        "(node/primary/worker planes; the quorum admission window keeps "
        "its own QUORUM_WINDOW depth). The knee matrix sweeps it; "
        "in-process harnesses may still pass an explicit per-node "
        "override.",
    ),
    EnvVar(
        "NARWHAL_HELPER_MAX_DIGESTS", "int", 128,
        "Per-BatchRequest digest cap at the worker Helper; unique "
        "digests past the cap are truncated and counted as "
        "`worker.helper_rejected_requests`.",
    ),
    EnvVar(
        "NARWHAL_MAX_BATCH_BYTES", "int", None,
        "Inbound batch-frame size ceiling at the worker receiver; "
        "oversized frames are rejected before hashing into "
        "`worker.garbage_batches`. Unset = 2×batch_size + 64 KiB.",
    ),
    EnvVar(
        "NARWHAL_CONSENSUS_AUDIT", "str", None,
        "Path for the consensus insert/commit audit segment consumed by "
        "the golden-oracle safety replay; unset = no audit log.",
    ),
    # -- protocol and wire ----------------------------------------------------
    EnvVar(
        "NARWHAL_WIRE_V2", "flag", True,
        "Wire-format v2 master switch (per-peer frame coalescing, "
        "per-connection digest-reference compression, compact varint/"
        "key-index encodings, residual deflate). `0` is the byte-"
        "identical legacy arm the paired wire A/B runs against; the "
        "flag is committee-wide — mixed-version committees are not "
        "supported.",
    ),
    EnvVar(
        "NARWHAL_COMMIT_RULE", "str", "classic",
        "Commit rule (equivalent of `node run --commit-rule`): `classic` "
        "(Tusk — leader commits at depth 3 on f+1 support), `lowdepth` "
        "(Mysticeti-style — leader commits the moment 2f+1 round-(L+1) "
        "certificates cite it), or `multileader` (Mysticeti multi-slot "
        "— 3 round-salted leader slots per even round, the commit "
        "anchors on the lowest 2f+1-supported slot); each non-classic "
        "rule is judged against its own frozen oracle. Committee-wide: "
        "mixed-rule committees diverge by design and fail the safety "
        "replay; checkpoints refuse a cross-rule restore.",
    ),
    EnvVar(
        "NARWHAL_CERT_SIG_SCHEME", "str", "individual",
        "Certificate signature scheme (equivalent of `node run "
        "--cert-sig-scheme`): `individual` (2f+1 ed25519 vote "
        "signatures per certificate) or `halfagg` (ed25519 "
        "half-aggregation — the vote quorum folds into one 32*(q+1)-"
        "byte blob at assembly and sanitization verifies ONE multiexp "
        "equation per certificate, at the `certificate_agg` crypto "
        "site). Committee-wide: a certificate frame from the other "
        "scheme refuses at decode (counted into "
        "primary.invalid_signatures) and a consensus checkpoint "
        "written under one scheme refuses to restore under the other. "
        "Default individual — the flip is gated on the "
        "measurement ladder (benchmark/trajectory_gate.json).",
    ),
    # -- observability --------------------------------------------------------
    EnvVar(
        "NARWHAL_METRICS", "flag", True,
        "`0` swaps the per-process instrument registry for no-ops "
        "(instrumented code needs no enabled-checks).",
    ),
    EnvVar(
        "NARWHAL_TRACE", "flag", False,
        "Per-digest TRACE instrumentation plus worker heartbeat logs "
        "(hot-path cost; debugging aid).",
    ),
    EnvVar(
        "NARWHAL_TRACE_CAP", "int", 32_768,
        "Stage-trace table capacity before eviction "
        "(`metrics.trace_evictions` counts overflow).",
    ),
    EnvVar(
        "NARWHAL_HEALTH", "flag", True,
        "HealthMonitor master switch on node boot; `0` disables rule "
        "evaluation entirely.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_INTERVAL", "float", 1.0,
        "Seconds between health-rule sweeps.",
    ),
    EnvVar(
        "NARWHAL_LOOP_WATCHDOG_MS", "int", 0,
        "Opt-in event-loop stall watchdog: >0 installs it with this "
        "threshold (ms). Stalls land in the "
        "`runtime.loop_stall_seconds` histogram with a stack excerpt in "
        "`runtime.loop_stall_last`; 0/unset = off.",
    ),
    EnvVar(
        "NARWHAL_PROFILE_HZ", "float", 67.0,
        "Sampling-profiler frequency (all-thread stack samples/s into "
        "the `profile.*` series, folded-stack + top-N tables in the "
        "snapshot detail); `0` disables the sampler thread.",
    ),
    EnvVar(
        "NARWHAL_FLIGHT", "flag", True,
        "`0` stubs the flight recorder (event ring, tick deltas, and "
        "the 503/SIGTERM/task-death dumps) without touching the rest "
        "of the metrics plane.",
    ),
    EnvVar(
        "NARWHAL_FLIGHT_CAP", "int", 512,
        "Flight-recorder ring capacity (events kept; oldest evicted).",
    ),
    EnvVar(
        "NARWHAL_FLIGHT_DIR", "str", None,
        "Directory for atomic flight-ring dump files "
        "(`flight-<node>-<n>-<reason>.json`) on the /healthz 503 "
        "transition, SIGTERM, and unhandled task death; unset = no "
        "file dumps (the ring stays pullable via `/debug/flight`).",
    ),
    EnvVar(
        "NARWHAL_FLIGHT_INTERVAL_S", "float", 1.0,
        "Seconds between flight-recorder `tick` events (per-tick "
        "wire/commit/queue deltas).",
    ),
    EnvVar(
        "NARWHAL_FAULTHANDLER_S", "float", 0.0,
        "Arm `faulthandler.dump_traceback_later` every N seconds "
        "(C-level stack dumps that fire even with a wedged event loop); "
        "0/unset = off.",
    ),
    EnvVar(
        "NARWHAL_PROFILE", "str", None,
        "cProfile the whole node, dumping stats into this directory on "
        "SIGTERM.",
    ),
    # -- health-rule thresholds (metrics.default_rules) -----------------------
    EnvVar(
        "NARWHAL_HEALTH_MAX_COMMIT_LAG", "float", 20,
        "`commit_lag` fires when `consensus.commit_lag_rounds` exceeds "
        "this.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_COMMIT_STALL_S", "float", 10,
        "`commit_stall` fires when rounds advance but no certificate "
        "commits for this long.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_PENDING_ACK_FLOOR", "float", 512,
        "`pending_acks` floor: backlog below this never fires.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_PENDING_ACK_WINDOW_S", "float", 5,
        "`pending_acks` growth-rate window in seconds.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_PEER_RETRANS_RATE", "float", 10,
        "`peer_retransmissions` fires above this many retransmits/s to "
        "one peer.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_PEER_RETRANS_WINDOW_S", "float", 5,
        "`peer_retransmissions` rate window in seconds.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_PEER_FAILURES", "float", 3,
        "`peer_unreachable` fires at this many consecutive connect "
        "failures against one peer (boot-grace gated).",
    ),
    EnvVar(
        "NARWHAL_HEALTH_QUORUM_WEDGE_S", "float", 10,
        "`quorum_wedge` fires when a sealed batch waits on its ACK "
        "quorum this long.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_VOTE_SILENCE_WINDOW_S", "float", 8,
        "`peer_vote_silence` observation window in seconds.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_VOTE_SILENCE_MIN_ROUNDS", "float", 3,
        "`peer_vote_silence` requires at least this much round progress "
        "inside the window.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_STALE_RATE", "float", 6,
        "`stale_replay` fires above this many stale messages/s — sits "
        "~2× above the measured partition-heal catch-up burst "
        "(2.4-2.9/s) and under the 10/s replay-flood attack.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_STALE_WINDOW_S", "float", 5,
        "`stale_replay` rate window in seconds.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_SYNC_AGE_S", "float", 8,
        "`batch_withholding` fires when a requested-but-unserved batch "
        "ages past this (above the stock 5 s sync retry delay).",
    ),
    EnvVar(
        "NARWHAL_HEALTH_QUEUE_SAT_RATIO", "float", 0.9,
        "`queue_saturated` fires when an instrumented channel's depth "
        "reaches this fraction of its capacity.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_QUEUE_SAT_MIN_CAP", "float", 16,
        "`queue_saturated` ignores channels with capacity below this: "
        "the quorum admission window and the sim's depth-1 channels run "
        "full as their backpressure mechanism.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_QUEUE_SAT_INTERVALS", "float", 3,
        "`queue_saturated` hysteresis: consecutive over-threshold "
        "evaluations before the rule fires.",
    ),
    EnvVar(
        "NARWHAL_HEALTH_INGRESS_DROP_RATE", "float", 1.0,
        "`ingress_drops` fires above this many client-ingress "
        "overflows/s (`worker.ingress_overflow` rate).",
    ),
    EnvVar(
        "NARWHAL_HEALTH_INGRESS_DROP_WINDOW_S", "float", 5,
        "`ingress_drops` rate window in seconds.",
    ),
    # -- crypto backend -------------------------------------------------------
    EnvVar(
        "NARWHAL_CRYPTO_BACKEND", "str", "cpu",
        "Signature-verification backend selected at node boot (equivalent "
        "of `node run --crypto-backend`): `cpu` (serial OpenSSL / "
        "pure-Python fallback) or `cuda` (the batched verifier in "
        "ops/ed25519.py, one hand-written CUDA kernel launch per batch); "
        "the reference's names for its batched verifier, `tpu` and "
        "`jax`, select `cuda`.",
    ),
    EnvVar(
        "NARWHAL_CRYPTO_BACKEND_STRICT", "flag", True,
        "`1` (default): a requested cuda backend that fails to build or "
        "load raises at boot with the error. `0`: log the error and "
        "fall back to the cpu backend — an explicit choice, never a "
        "silent downgrade mid-burst.",
    ),
    EnvVar(
        "NARWHAL_VERIFY_MESH", "flag", False,
        "EXPERIMENTAL: split the batched verify across every visible "
        "CUDA device (one equal shard of the padded batch per card, each "
        "launched on its card before any is awaited) so crypto "
        "throughput scales with cards; single-card hosts run the "
        "single-launch kernel.",
    ),
    EnvVar(
        "NARWHAL_VERIFY_BATCH_WINDOW_MS", "float", 0.0,
        "Core verify-batch accumulation window: >0 coalesces signature "
        "claims from multiple drained bursts (headers, votes, certs) "
        "arriving within this many ms into ONE backend dispatch, run in "
        "a pipelined verify task so proposer/waiter work keeps flowing "
        "during the device round trip. 0 (default) = verify each "
        "drained burst inline.",
    ),
    EnvVar(
        "NARWHAL_VERIFY_BATCH_MAX", "int", 256,
        "Max messages one coalesced verify dispatch may cover when the "
        "batch window is enabled (bounds device batch shape and the "
        "latency added ahead of the first message's replay).",
    ),
    # -- deterministic simulation (narwhal_tpu_torch/sim) ---------------------
    EnvVar(
        "NARWHAL_SIM_COMPRESSION_CAP", "float", 60.0,
        "Ceiling on a single virtual-clock quiesce jump in simulated "
        "seconds; a forgotten far-future timer advances the clock in "
        "bounded non-blocking steps instead of one leap. 0 = uncapped.",
    ),
    EnvVar(
        "NARWHAL_SIM_MAX_VIRTUAL_S", "float", 600.0,
        "Ceiling on one sim run's total virtual duration, enforced as a "
        "virtual-time wait_for: a livelocked scenario terminates with a "
        "deterministic timeout instead of spinning forever.",
    ),
    # -- fault injection ------------------------------------------------------
    EnvVar(
        "NARWHAL_FAULT_PLAN", "str", None,
        "Path to a Byzantine plan JSON (equivalent of `node run "
        "--fault-plan`); makes the node ATTACK its committee.",
    ),
    EnvVar(
        "NARWHAL_FAULT_SEED", "int", None,
        "Overrides the fault plan's RNG seed (rogue keys, twin minting, "
        "fuzz draws).",
    ),
    EnvVar(
        "NARWHAL_FAULT_NETEM", "str", None,
        "Path to a WAN-emulation spec consumed by `faults/netem.py`; "
        "unset = no emulation.",
    ),
    EnvVar(
        "NARWHAL_FAULT_NODE", "str", "",
        "This node's name in the netem spec (selects its link profile).",
    ),
]

REGISTRY: Dict[str, EnvVar] = {v.name: v for v in _VARS}
assert len(REGISTRY) == len(_VARS), "duplicate EnvVar declaration"


def declared(name: str) -> EnvVar:
    """The declaration for ``name``; raises on an undeclared knob."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name} is not declared in narwhal_tpu_torch/utils/env.py REGISTRY "
            "— declare it (name, type, default, doc) before reading it"
        ) from None


def env_raw(
    name: str, env: Optional[Mapping[str, str]] = None
) -> Optional[str]:
    """The raw string value (or None), with the declaration check.
    ``env`` overrides ``os.environ`` for injectable call sites."""
    declared(name)
    return (os.environ if env is None else env).get(name)


_FALSE = {"", "0", "false", "no", "off"}


def env_flag(
    name: str,
    default: object = _UNSET,
    env: Optional[Mapping[str, str]] = None,
) -> bool:
    raw = env_raw(name, env)
    if raw is None:
        d = REGISTRY[name].default if default is _UNSET else default
        return bool(d)
    return raw.strip().lower() not in _FALSE


def env_str(
    name: str,
    default: object = _UNSET,
    env: Optional[Mapping[str, str]] = None,
):
    raw = env_raw(name, env)
    if raw is not None:
        return raw
    return REGISTRY[name].default if default is _UNSET else default


@functools.lru_cache(maxsize=128)
def _parse_number(name: str, raw: str, caster, fallback) -> object:
    # Memoized per raw value: misconfiguration must warn once, not at
    # call-site frequency.
    try:
        return caster(raw)
    except (TypeError, ValueError):
        log.warning(
            "%s=%r is not a valid %s; using %r",
            name, raw, caster.__name__, fallback,
        )
        return fallback


def env_int(
    name: str,
    default: object = _UNSET,
    env: Optional[Mapping[str, str]] = None,
):
    raw = env_raw(name, env)
    d = REGISTRY[name].default if default is _UNSET else default
    if raw is None:
        return d
    if not isinstance(raw, str):  # injected mapping may carry parsed values
        return int(raw)
    return _parse_number(name, raw, int, d)


def env_float(
    name: str,
    default: object = _UNSET,
    env: Optional[Mapping[str, str]] = None,
):
    raw = env_raw(name, env)
    d = REGISTRY[name].default if default is _UNSET else default
    if raw is None:
        return d
    if not isinstance(raw, str):
        return float(raw)
    return _parse_number(name, raw, float, d)


@functools.lru_cache(maxsize=64)
def _parse_positive_int(name: str, raw: str, default: int) -> int:
    try:
        v = int(raw)
        if v > 0:
            return v
    except ValueError:
        pass
    log.warning(
        "%s=%r is not a positive integer; using %d", name, raw, default
    )
    return default


def positive_int(name: str, default: int) -> int:
    """``int(os.environ[name])`` when set and positive, else ``default``
    (with a once-per-value warning on garbage).  The default stays at the
    call site because these knobs compute it (e.g. from batch_size)."""
    raw = env_raw(name)
    if raw is None:
        return default
    return _parse_positive_int(name, raw, default)


# -- README table -------------------------------------------------------------

# The port's own markers: the reference's table lives in the same README
# between its own pair, and neither pair contains the other.
TABLE_BEGIN = (
    "<!-- torch-env-table:begin (generated: "
    "python -m narwhal_tpu_torch.analysis --env-table) -->"
)
TABLE_END = "<!-- torch-env-table:end -->"


def render_table() -> str:
    """The port's README env-var markdown table, generated from the
    registry so the doc and the code cannot drift (the linter compares
    this output against the README section)."""
    lines = [
        "| Variable | Type | Default | Meaning |",
        "|---|---|---|---|",
    ]
    for v in sorted(REGISTRY.values(), key=lambda v: v.name):
        lines.append(
            f"| `{v.name}` | {v.kind} | {v.rendered_default} | {v.doc} |"
        )
    return "\n".join(lines)
