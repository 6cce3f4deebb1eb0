"""Committee-at-scale simulation: boot, drive, and judge one scenario.

:func:`run_sim_scenario` takes the same declarative
:class:`~narwhal_tpu.faults.spec.FaultScenario` the socketed
``benchmark/fault_bench.py`` runs, but executes the WHOLE committee —
every primary, worker and client of an N=4..50 validator set, plus its
Byzantine plans, WAN shaping and crash/restart timeline — as a single
process on one :class:`~narwhal_tpu.sim.clock.VirtualClockLoop`, with
the in-memory transport installed behind the ``network/`` seam and
in-memory stores throughout.  A 60-virtual-second scenario completes in
wall seconds; the run seed pins both the schedule exploration and every
stochastic draw, so the same ``(seed, spec)`` replays byte-for-byte.

The judge is the existing three-verdict engine:

- **safety** — per-node audit segments replayed through the frozen
  golden oracle (``consensus/replay.py``, the arXiv:2407.02167
  invariants) plus committee-wide commit-prefix consistency;
- **liveness** — honest survivors keep committing client payload after
  the fault settles, measured on the VIRTUAL clock;
- **detection** — every expected health rule FIRES into a
  :class:`~narwhal_tpu.metrics.HealthMonitor` driven on virtual time
  (and a clean scenario fires nothing).

Fidelity notes (documented, deliberate): all nodes share one process
registry, so detection is committee-aggregated (a rule firing anywhere
counts — per-node attribution belongs to the socketed harness); a sim
"crash" is an abrupt task teardown rather than a SIGKILL (the retained
in-memory store preserves exactly what the on-disk store preserves, but
torn-file recovery itself stays the socketed suite's subject); and
signatures run in sim-MAC mode (``crypto/keys.py``) — key-binding
semantics preserved, ed25519 math elided.
"""

from __future__ import annotations

import gc
import hashlib
import json
import random
from typing import Dict, List, Optional

from .. import metrics
from ..config import (
    Authority,
    Committee,
    Parameters,
    PrimaryAddresses,
    WorkerAddresses,
)
from ..consensus.replay import cross_node_prefix, replay_segments
from ..crypto import KeyPair
from ..crypto.keys import set_sim_mac
from ..faults.byzantine import ByzantinePlan
from ..faults.spec import FaultScenario
from ..metrics import HealthMonitor, default_rules
from ..network import clocksync
from ..network import transport as net_seam
from ..network.framing import frame
from ..utils.clock import set_wall_base, skew_scope
from ..utils.tasks import spawn
from .clock import run_virtual
from .transport import SimTransport, compile_wan

# Virtual-time settle margins (fault_bench's wall margins exist to absorb
# host scheduling noise; virtual time has none, only protocol cadence).
_RESTART_SETTLE_S = 6.0
_HEAL_SETTLE_S = 3.0
# Committee-wide client rate ceiling: the sim's subject is schedule/fault
# diversity, not ingress throughput, and wall cost is linear in frames.
_RATE_CAP = 600

# Which evidence counter backs each counter-latched detection rule (the
# metrics.DETECTION_COUNTERS set, joined rule-side): the verdict reads
# the per-node `detect.<counter>.<node>` shadows through this table to
# name observers.
_RULE_EVIDENCE_COUNTERS = {
    "equivocation": "primary.equivocations_detected",
    "invalid_signature": "primary.invalid_signatures",
    "stale_replay": "primary.stale_messages",
    "garbage_batches": "worker.garbage_batches",
    "helper_abuse": "worker.helper_rejected_requests",
}


def _effective_rule(commit_rule: Optional[str]) -> str:
    """The rule the committee actually ran: None defers to the
    NARWHAL_COMMIT_RULE env knob inside Consensus, and the artifact must
    record that resolution, not assume classic."""
    from ..consensus import resolve_commit_rule

    return resolve_commit_rule(commit_rule)


def sim_parameters(scenario: FaultScenario) -> Parameters:
    """Scenario parameters with the sim profile applied: committees past
    N=10 stretch the round cadence so a 60-virtual-second scenario stays
    inside single-digit wall seconds (protocol WORK is real CPU even
    under a virtual clock — only waiting compresses).  Explicit
    ``parameters`` overrides in the spec always win."""
    defaults: Dict[str, int] = {"batch_size": 50_000}
    if scenario.nodes > 10:
        # Large-committee cadence: a WAN committee of N=20+ under real
        # crypto runs multi-second rounds anyway; frame volume per round
        # is N², so this is where the wall budget goes.
        defaults.update(
            max_header_delay=5_000, max_batch_delay=3_000,
            sync_retry_delay=6_000,
        )
    elif scenario.nodes > 4:
        defaults.update(max_header_delay=500, max_batch_delay=400)
    defaults.update(scenario.parameters)
    return Parameters(**defaults)


def _health_env(scenario: FaultScenario, params: Parameters) -> Dict[str, str]:
    """Health thresholds for the sim run: the scenario's env block, with
    the cadence-sensitive windows floored proportionally to the round
    period.  The stock defaults assume ~100 ms rounds; under the
    stretched large-committee cadence a 10 s commit-stall threshold is
    only ~4 rounds and the boot window alone trips it, and a 6 s
    vote-silence window cannot see the 3 rounds of progress its rule
    requires — the thresholds must scale with the clock they watch."""
    period_s = max(0.1, params.max_header_delay / 1000.0)
    batch_s = max(0.1, params.max_batch_delay / 1000.0)
    env = dict(scenario.env)

    from ..utils.env import env_float

    def floor(key: str, minimum: float) -> None:
        # Effective value = scenario override or the registry default;
        # the floor only ever RAISES it (a scenario that pinned a low
        # window for its detection contract keeps it at small N, where
        # the minima do not bind).
        current = float(env_float(key, env=env))
        if current < minimum:
            env[key] = str(minimum)

    floor("NARWHAL_HEALTH_COMMIT_STALL_S", 8 * period_s + 4)
    floor("NARWHAL_HEALTH_VOTE_SILENCE_WINDOW_S", 5 * period_s)
    floor("NARWHAL_HEALTH_QUORUM_WEDGE_S", 5 * batch_s + 4)
    return env


def sim_keypairs(scenario: FaultScenario) -> List[KeyPair]:
    """Deterministic identities from the scenario seed (schedule seeds
    must not perturb them: commit digests are part of the bit-repro
    contract)."""
    return [
        KeyPair.generate(
            hashlib.sha256(
                f"narwhal-sim:{scenario.seed}:{i}".encode()
            ).digest()
        )
        for i in range(scenario.nodes)
    ]


def build_sim_committee(
    keypairs: List[KeyPair], workers: int, base_port: int = 40_000
) -> Committee:
    """Address-shaped committee for the in-memory transport (the
    host:port strings are pure routing keys — nothing binds them)."""
    authorities = {}
    port = base_port
    for kp in keypairs:
        def addr() -> str:
            nonlocal port
            a = f"127.0.0.1:{port}"
            port += 1
            return a

        primary = PrimaryAddresses(
            primary_to_primary=addr(), worker_to_primary=addr()
        )
        ws = {
            wid: WorkerAddresses(
                transactions=addr(),
                worker_to_worker=addr(),
                primary_to_worker=addr(),
            )
            for wid in range(workers)
        }
        authorities[kp.name] = Authority(stake=1, primary=primary, workers=ws)
    return Committee(authorities)


def _tx(counter: int, size: int) -> bytes:
    """Filler transaction (byte0=1 + u64 counter, zero-padded), framed."""
    body = bytes([1]) + counter.to_bytes(8, "little")
    return frame(body + bytes(max(0, size - len(body))))


def deterministic_blob(artifact: dict) -> bytes:
    """The bit-reproducibility surface of a sim artifact: everything
    except the wall-clock sections, canonically serialized.  Two runs of
    the same (seed, spec) must produce byte-identical blobs.  ``queues``
    is excluded with ``wall``: its put-wait/residence histograms measure
    host time (time.monotonic), not virtual time — the counts are
    schedule-determined but the means are wall noise."""
    core = {k: v for k, v in artifact.items() if k not in ("wall", "queues")}
    return json.dumps(core, sort_keys=True, separators=(",", ":")).encode()


def run_sim_scenario(
    scenario: FaultScenario,
    run_seed: int,
    workdir: str,
    parameters: Optional[Parameters] = None,
    consensus_cls_by_node: Optional[Dict[int, type]] = None,
    rate_cap: int = _RATE_CAP,
    max_virtual_s: Optional[float] = None,
    commit_rule: Optional[str] = None,
    large_n_rate_cap: Optional[int] = 60,
    clock_skew_ms: Optional[Dict[int, float]] = None,
) -> dict:
    """Run one scenario arm in simulation; returns the artifact dict
    (see module docstring).  ``consensus_cls_by_node`` swaps a node's
    Consensus runner (the planted-mutation arms).  ``commit_rule``
    selects the consensus commit rule for the WHOLE committee (the
    flag-flip sweep's arm knob); each node's audit segment records it,
    so the safety replay judges against the matching frozen oracle with
    no further plumbing.  ``large_n_rate_cap`` is the extra offered-load
    clamp applied above 10 nodes (wall cost of the sim is linear in
    frames); the knee matrix passes ``None`` to sweep real rates at
    N=10/20.  ``clock_skew_ms`` maps authority index → injected wall-
    clock skew: that authority's whole plane (primary + workers) stamps
    traces and ACKs with a clock running that far ahead/behind the
    virtual truth — the skew-injection arm that validates the clocksync
    correction against known ground truth (the protocol itself never
    reads the wall clock, so the schedule is skew-invariant)."""
    import os
    import shutil

    # Fresh workdir per run: AuditWriter rolls to `<path>.N` when a
    # segment file already exists, so judging a reused directory would
    # silently replay the PREVIOUS run's segments under this run's name.
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    params = sim_parameters(scenario) if parameters is None else parameters
    keypairs = sim_keypairs(scenario)
    names = [kp.name for kp in keypairs]
    committee = build_sim_committee(keypairs, scenario.workers)
    wan_table = compile_wan(scenario, committee, names)
    backoff_cap = float(scenario.env.get("NARWHAL_NET_BACKOFF_MAX_S", 60.0))

    plans: Dict[int, ByzantinePlan] = {}
    for b in scenario.byzantine:
        plans[b.node] = ByzantinePlan(
            behaviors=b.behaviors,
            seed=scenario.seed ^ (b.node + 1),
            withhold_targets=(
                {names[t] for t in b.targets} if b.targets else None
            ),
            replay_interval_ms=b.replay_interval_ms,
            flood_interval_ms=b.flood_interval_ms,
            garbage_bytes=b.garbage_bytes,
        )

    byz = set(scenario.byzantine_nodes())
    dead_forever = {c.node for c in scenario.crash if c.restart_at_s is None}
    honest = [i for i in range(scenario.nodes) if i not in byz]
    survivors = [i for i in honest if i not in dead_forever]
    settle_s = 0.0
    for c in scenario.crash:
        settle_s = max(
            settle_s,
            (c.restart_at_s + _RESTART_SETTLE_S)
            if c.restart_at_s is not None
            else c.at_s,
        )
    if scenario.wan:
        for part in scenario.wan.partitions:
            if part.until_s is not None:
                settle_s = max(settle_s, part.until_s + _HEAL_SETTLE_S)

    # Offered load scales DOWN with committee size: the sim's subject is
    # schedule/fault diversity, wall cost is linear in frames, and the
    # batch plane broadcasts every seal to N-1 peers.
    rate = min(scenario.rate, rate_cap)
    if scenario.nodes > 10 and large_n_rate_cap is not None:
        rate = min(rate, large_n_rate_cap)
    audit_segments: Dict[int, List[str]] = {}
    commits: Dict[int, List] = {i: [] for i in range(scenario.nodes)}
    monitor_events: List[dict] = []

    # Cross-run isolation: zero the shared registry and collect the
    # previous run's dead components out of the metrics WeakSets before
    # anything records — a stale synchronizer's pending entry must not
    # leak into this run's batch_withholding input.
    reg = metrics.registry()
    reg.reset()
    # reset() deliberately keeps instrument IDENTITY (module-level code
    # holds direct references), but per-PEER families are keyed by the
    # previous run's committee — and a zeroed `primary.peer_votes.<x>`
    # counter for a peer that no longer exists reads as a vote-silent
    # validator to the health rules (a measured false-FIRING source in
    # back-to-back sweeps).  Those names are only ever fetched at
    # component construction, never bound at import, so dropping them
    # is safe; the next run re-creates its own.
    for pool in (reg.counters, reg.gauges, reg.histograms):
        for name in [
            n for n in pool
            if n.startswith(
                (
                    "primary.peer_votes.",
                    "primary.quorum_straggler.",
                    "consensus.support_straggler.",
                    "net.reliable.peer.",
                    "clock.",
                    "detect.",
                )
            )
        ]:
            del pool[name]
    # Clock-offset estimators are keyed by the previous run's committee
    # too, and a retained smoothed estimate would leak into this run.
    clocksync.reset_estimators()
    gc.collect()
    random.seed(scenario.seed ^ (run_seed * 2654435761))

    transport = SimTransport(
        seed=scenario.seed ^ run_seed,
        wan_table=wan_table,
        backoff_cap_s=backoff_cap,
    )

    async def main() -> dict:
        import asyncio

        from ..node import spawn_primary_node, spawn_worker_node
        from ..store import Store

        loop = asyncio.get_running_loop()
        start = loop.time()
        transport.anchor(start)
        # Wall stamps (trace tables, ACK clock stamps) ride the virtual
        # clock — deterministic per (seed, spec) — plus each node's
        # injected skew; uninstalled in the run's outer finally.
        set_wall_base(loop.time)

        prim_stores = {i: Store(None) for i in range(scenario.nodes)}
        worker_stores = {
            (i, wid): Store(None)
            for i in range(scenario.nodes)
            for wid in range(scenario.workers)
        }
        primaries: Dict[int, object] = {}
        worker_nodes: Dict[int, List[object]] = {}
        incarnation: Dict[int, int] = {}

        def auth_addresses(i: int) -> List[str]:
            auth = committee.authorities[names[i]]
            out = [
                auth.primary.primary_to_primary,
                auth.primary.worker_to_primary,
            ]
            for w in auth.workers.values():
                out += [
                    w.transactions, w.worker_to_worker, w.primary_to_worker
                ]
            return out

        async def spawn_authority(i: int, replay: bool) -> None:
            inc = incarnation.get(i, 0)
            incarnation[i] = inc + 1
            audit = os.path.join(workdir, f"audit-primary-{i}.seg{inc}.bin")
            audit_segments.setdefault(i, []).append(audit)
            plan = plans.get(i)
            # One injected skew per AUTHORITY (primary + its workers):
            # the physical model is one mis-synced host per validator.
            skew_s = (clock_skew_ms or {}).get(i, 0.0) / 1000.0
            # node_scope: detection counters built by this authority's
            # components also feed per-node `detect.*` shadows, so the
            # verdict can name WHICH validator observed the evidence (the
            # one registry is otherwise committee-aggregated).
            with transport.node(f"primary-{i}"), reg.node_scope(
                f"primary-{i}"
            ), skew_scope(skew_s):
                primaries[i] = await spawn_primary_node(
                    keypairs[i],
                    committee,
                    params,
                    on_commit=(
                        lambda cert, i=i: commits[i].append(
                            (loop.time(), cert)
                        )
                    ),
                    fault_plan=plan,
                    audit_path=audit,
                    store=prim_stores[i],
                    consensus_cls=(consensus_cls_by_node or {}).get(i),
                    replay_persisted=replay,
                    commit_rule=commit_rule,
                    # Mutated nodes get depth-1 consensus channels so
                    # every commit-burst put genuinely suspends — the
                    # forcing without which a planted await-window race
                    # can never open (race_explore's pipeline applies
                    # the same).
                    channel_capacity=(
                        1 if i in (consensus_cls_by_node or {}) else None
                    ),
                )
            ws = []
            for wid in range(scenario.workers):
                # Worker-plane evidence is attributed to its AUTHORITY
                # (the verdict's node names are primary-<i>).
                with transport.node(f"worker-{i}-{wid}"), reg.node_scope(
                    f"primary-{i}"
                ), skew_scope(skew_s):
                    ws.append(
                        await spawn_worker_node(
                            keypairs[i],
                            wid,
                            committee,
                            params,
                            fault_plan=plan,
                            store=worker_stores[(i, wid)],
                        )
                    )
            worker_nodes[i] = ws

        async def crash_authority(i: int) -> None:
            transport.set_down(auth_addresses(i))
            node = primaries.pop(i, None)
            if node is not None:
                await node.shutdown()
                if node.consensus is not None and node.consensus._audit:
                    node.consensus._audit.close()
            for w in worker_nodes.pop(i, []):
                await w.shutdown()

        for i in range(scenario.nodes):
            await spawn_authority(i, replay=False)

        # Health monitor on the virtual clock; thresholds come from the
        # scenario's env block (injected, never os.environ).
        monitor = HealthMonitor(
            reg,
            rules=default_rules(env=_health_env(scenario, params)),
            interval_s=1.0,
        )
        reg.health = monitor

        async def health_driver() -> None:
            while True:
                await asyncio.sleep(monitor.interval_s)
                monitor.evaluate(now=loop.time())

        health_task = spawn(health_driver(), name="sim-health")

        # Clients: one per worker, paced on the virtual clock.  Filler
        # txs only — liveness is judged on payload-batch commits, not
        # parsed latency samples.
        stop_clients = asyncio.Event()
        per_client = max(1, rate // max(1, scenario.nodes * scenario.workers))

        async def client(i: int, wid: int, idx: int) -> None:
            address = committee.worker(names[i], wid).transactions
            counter = idx << 40
            burst = max(1, per_client // 2)
            conn = None
            while not stop_clients.is_set():
                if conn is None or conn.transport.closed:
                    try:
                        conn = transport.open_tx_connection(address)
                    except OSError:
                        await asyncio.sleep(1.0)  # crashed worker: retry
                        continue
                chunk = b"".join(
                    _tx(counter + k, scenario.tx_size) for k in range(burst)
                )
                counter += burst
                conn.write(chunk)
                await asyncio.sleep(0.5)

        client_tasks = [
            spawn(client(i, wid, i * scenario.workers + wid),
                  name="sim-client")
            for i in range(scenario.nodes)
            for wid in range(scenario.workers)
        ]

        # Fault timeline (virtual offsets from the launch anchor).
        events = sorted(
            [("crash", c.at_s, c.node) for c in scenario.crash]
            + [
                ("restart", c.restart_at_s, c.node)
                for c in scenario.crash
                if c.restart_at_s is not None
            ],
            key=lambda e: e[1],
        )
        for kind, at_s, node_i in events:
            delay = (start + at_s) - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            if kind == "crash":
                await crash_authority(node_i)
            else:
                transport.set_up(auth_addresses(node_i))
                await spawn_authority(node_i, replay=True)

        remaining = (start + scenario.duration) - loop.time()
        if remaining > 0:
            await asyncio.sleep(remaining)

        settle_ts = start + settle_s

        def payload_commits_after(i: int, ts: float) -> int:
            return sum(
                1
                for t, cert in commits[i]
                if t >= ts and cert.header.payload
            )

        # Virtual-time liveness grace: cheap to grant, bounded by the
        # scenario's progress_wait.
        grace_deadline = loop.time() + scenario.progress_wait
        while loop.time() < grace_deadline:
            if all(payload_commits_after(i, settle_ts) > 0 for i in survivors):
                break
            await asyncio.sleep(1.0)

        stop_clients.set()
        for t in client_tasks:
            t.cancel()
        health_task.cancel()
        monitor.evaluate(now=loop.time())
        monitor_events.extend(monitor.events)

        for i in list(primaries):
            node = primaries.pop(i)
            await node.shutdown()
            if node.consensus is not None and node.consensus._audit:
                node.consensus._audit.close()
        for i in list(worker_nodes):
            for w in worker_nodes.pop(i):
                await w.shutdown()
        await transport.shutdown()
        await asyncio.gather(
            *client_tasks, health_task, return_exceptions=True
        )
        return {
            "settle_ts": settle_ts,
            "start": start,
            "liveness_nodes": {
                f"primary-{i}": {
                    "payload_commits_post_settle": payload_commits_after(
                        i, settle_ts
                    ),
                    "ok": payload_commits_after(i, settle_ts) > 0,
                }
                for i in survivors
            },
        }

    from ..primary.messages import set_decode_cache

    import asyncio

    net_seam.install(transport)
    set_sim_mac(True)
    set_decode_cache(True)
    # Certificate-signature scheme per scenario (the sim arm of the
    # --cert-sig-scheme A/B): a NARWHAL_CERT_SIG_SCHEME entry in the
    # scenario's env dict scopes the scheme to this run; absent, the
    # harness/process setting stands.  Saved/restored like the sim-MAC
    # bracket so sweeps with mixed arms can't leak a scheme.
    from ..crypto.aggregate import (
        resolve_scheme as _resolve_cert_scheme,
        scheme_override as _cert_scheme_override,
        set_scheme as _set_cert_scheme,
    )

    prev_cert_scheme = _cert_scheme_override()
    scenario_scheme = scenario.env.get("NARWHAL_CERT_SIG_SCHEME")
    if scenario_scheme is not None:
        _set_cert_scheme(_resolve_cert_scheme(str(scenario_scheme)))
    timed_out = False
    try:
        try:
            result, stats = run_virtual(
                main, run_seed, max_virtual_s=max_virtual_s
            )
        # asyncio.TimeoutError: on 3.10 it is NOT the builtin
        # TimeoutError (they merged in 3.11), and a bare `except
        # TimeoutError` would let the guard crash the whole sweep.
        except (TimeoutError, asyncio.TimeoutError):
            # A livelocked/deadlocked scenario: deterministic by seed —
            # itself a finding, judged below on whatever was recorded.
            timed_out = True
            result, stats = None, {
                "seed": run_seed, "ticks": 0, "permutations": 0,
                "jumps": 0, "capped_jumps": 0, "virtual_s": None,
                "wall_s": None, "compression": None,
            }
    finally:
        set_sim_mac(False)
        set_decode_cache(False)
        _set_cert_scheme(prev_cert_scheme)
        set_wall_base(None)
        net_seam.reset()
        reg.health = None

    # -- verdicts (sync, outside the loop) ------------------------------------

    safety_nodes: Dict[str, dict] = {}
    sequences: Dict[str, List[str]] = {}
    for i in honest:
        verdict = replay_segments(
            committee, params.gc_depth, audit_segments.get(i, [])
        )
        sequences[f"primary-{i}"] = verdict.pop("commit_digests")
        safety_nodes[f"primary-{i}"] = verdict
    cross = cross_node_prefix(sequences)
    safety = {
        "ok": cross["ok"] and all(v["ok"] for v in safety_nodes.values()),
        "nodes": safety_nodes,
        "cross_node": cross,
    }

    liveness = {
        "ok": (
            not timed_out
            and result is not None
            and bool(result["liveness_nodes"])
            and all(v["ok"] for v in result["liveness_nodes"].values())
        ),
        "settle_offset_s": settle_s,
        "nodes": result["liveness_nodes"] if result else {},
        "timed_out": timed_out,
    }

    fired = sorted(
        {
            e["rule"]
            for e in monitor_events
            if e.get("event") == "FIRING"
        }
    )
    missing = [r for r in scenario.expect_rules if r not in fired]
    # Per-node attribution: counter-backed rules name the validator(s)
    # whose components observed the evidence (the `detect.*` shadows fed
    # via Registry.node_scope).  Gauge- and per-peer-backed rules have no
    # single observing counter and stay committee-level.
    observers: Dict[str, List[str]] = {}
    for rule, counter_name in _RULE_EVIDENCE_COUNTERS.items():
        prefix = f"detect.{counter_name}."
        seen = sorted(
            name[len(prefix):]
            for name, c in reg.counters.items()
            if name.startswith(prefix) and c.value > 0
        )
        if seen:
            observers[rule] = seen
    detection = {
        "ok": not missing,
        "expected": scenario.expect_rules,
        "fired": fired,
        "missing": missing,
        "observers": observers,
    }
    if scenario.is_clean():
        detection["ok"] = not fired
        detection["expected"] = []

    # Virtual-time cert→commit: the committee-aggregated
    # consensus.cert_to_commit_seconds histogram rides the virtual clock
    # here, so its mean is pure protocol cadence (commit depth × round
    # period) with zero host noise — the series that prices a
    # commit-rule latency claim before any socketed run.
    c2c = reg.histograms.get("consensus.cert_to_commit_seconds")
    cert_to_commit = {
        "count": c2c.count if c2c is not None else 0,
        "mean_virtual_s": (
            round(c2c.sum / c2c.count, 6)
            if c2c is not None and c2c.count
            else None
        ),
    }
    # Same virtual clock, consensus side: per-leader first→quorum-th
    # direct-support arrival spread (ms) — the multi-leader flip's
    # before-number at N=10/20 with zero host noise.
    sa = reg.histograms.get("consensus.support_arrival_ms")
    support_arrival = {
        "count": sa.count if sa is not None else 0,
        "mean_virtual_ms": (
            round(sa.sum / sa.count, 3)
            if sa is not None and sa.count
            else None
        ),
    }
    # Clock-offset estimation, judged against injected ground truth: the
    # sim's channels feed per-(source node, destination address) offset
    # estimators (clocksync — the shared registry cannot carry per-node
    # gauges), mapped back to authorities here and reconciled with the
    # SAME zero-mean formula metrics_check applies to live snapshots.
    # Everything rides the virtual clock, so the section is part of the
    # deterministic blob: offsets are bit-reproducible per (seed, spec).
    addr_to_auth: Dict[str, int] = {}
    for i, nm in enumerate(names):
        auth = committee.authorities[nm]
        addr_to_auth[auth.primary.primary_to_primary] = i
        addr_to_auth[auth.primary.worker_to_primary] = i
        for w in auth.workers.values():
            for a in (
                w.transactions, w.worker_to_worker, w.primary_to_worker
            ):
                addr_to_auth[a] = i

    def _label_auth(label: str) -> Optional[int]:
        parts = label.split("-")
        if parts[0] in ("primary", "worker") and len(parts) > 1:
            try:
                return int(parts[1])
            except ValueError:
                return None
        return None

    pairwise: Dict[int, Dict[int, List[float]]] = {}
    for src_label, peers in clocksync.offsets_by_source().items():
        s = _label_auth(src_label)
        if s is None:
            continue
        for addr, info in peers.items():
            d = addr_to_auth.get(addr)
            if d is None or d == s:
                continue
            pairwise.setdefault(s, {}).setdefault(d, []).append(
                info["offset_ms"]
            )
    peer_offsets_ms = {
        f"primary-{s}": {
            f"primary-{d}": round(sum(v) / len(v), 3)
            for d, v in sorted(peers.items())
        }
        for s, peers in sorted(pairwise.items())
    }
    clock = {
        "injected_skew_ms": {
            f"primary-{i}": v
            for i, v in sorted((clock_skew_ms or {}).items())
        },
        "peer_offsets_ms": peer_offsets_ms,
        "reconciled_ms": {
            node: round(v, 3)
            for node, v in clocksync.reconcile_zero_mean(
                peer_offsets_ms
            ).items()
        },
    }

    # Quorum-straggler attribution over the shared registry, with the
    # per-address counters folded back to authority labels.  Counts are
    # schedule-determined — also inside the deterministic blob.
    stragglers: Dict[str, Dict[str, int]] = {}
    for section, prefix in (
        ("quorum", "primary.quorum_straggler."),
        ("support", "consensus.support_straggler."),
    ):
        agg: Dict[str, int] = {}
        for counter_name, c in reg.counters.items():
            if counter_name.startswith(prefix) and c.value > 0:
                idx = addr_to_auth.get(counter_name[len(prefix):])
                label = (
                    f"primary-{idx}"
                    if idx is not None
                    else counter_name[len(prefix):]
                )
                agg[label] = agg.get(label, 0) + c.value
        stragglers[section] = dict(sorted(agg.items()))

    # Per-channel backpressure accounting over the shared registry: the
    # sim runs the whole committee in one process, so channel series
    # aggregate committee-wide (same convention as the queue-depth
    # gauge_fns).  No scrape timeline here — first_saturating uses the
    # high-water fallback.  The join lives in the reference's bench
    # package, which imports the reference package, so the port omits
    # the section (deterministic_blob leaves it out in both).
    queues = {}

    artifact = {
        "name": scenario.name,
        "generated_by": "narwhal_tpu_torch/sim",
        "nodes": scenario.nodes,
        "workers": scenario.workers,
        "scenario_seed": scenario.seed,
        "run_seed": run_seed,
        "sim_rate": rate,
        "commit_rule": _effective_rule(commit_rule),
        "cert_to_commit": cert_to_commit,
        "support_arrival": support_arrival,
        "clock": clock,
        "stragglers": stragglers,
        "queues": queues,
        "parameters": params.to_json(),
        "verdicts": {
            "safety": safety,
            "liveness": liveness,
            "detection": detection,
        },
        "ok": safety["ok"] and liveness["ok"] and detection["ok"],
        "commit_sequences": sequences,
        "events": [
            {
                "event": e["event"],
                "rule": e["rule"],
                "subject": e["subject"],
                "t": e["t"],
            }
            for e in monitor_events
        ],
        "schedule": {
            k: stats[k]
            for k in ("seed", "ticks", "permutations", "jumps", "virtual_s")
        },
        # Wall-clock section: EXCLUDED from deterministic_blob().
        "wall": {
            "wall_s": stats["wall_s"],
            "compression": stats["compression"],
            "capped_jumps": stats["capped_jumps"],
        },
    }
    return artifact
