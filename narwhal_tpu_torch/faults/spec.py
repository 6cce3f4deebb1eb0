"""Declarative fault-scenario specs (the input to benchmark/fault_bench.py).

A scenario is one JSON file naming a committee shape, a load profile, and
up to three fault planes:

- ``byzantine``: per-node behavior lists drawn from
  :data:`BYZANTINE_BEHAVIORS` — primary-plane behaviors executed
  in-process by ``narwhal_tpu.faults.byzantine.ByzantineCore``/
  ``ByzantineProposer``, worker-plane behaviors (batch withholding,
  garbage serving, sync flooding) by
  ``narwhal_tpu.faults.byzantine_worker``;
- ``crash``: kill an authority's processes mid-run (SIGKILL — the point is
  to exercise the torn-file/far-frontier restore paths) and restart them
  from their on-disk store + consensus checkpoint while the committee is
  under load;
- ``wan``: latency/jitter/loss defaults, per-directed-pair overrides, and
  time-windowed partitions, compiled by the runner into the per-node
  config ``narwhal_tpu.faults.netem`` loads inside each process.

Fault planes COMPOSE: one scenario may put different planes on distinct
nodes (a Byzantine worker on one authority while another crashes, an
equivocating primary under committee-wide WAN loss, ...) — the parser
enforces the BFT bound over the UNION of byzantine + crashed +
partitioned nodes so a composition can never silently cost quorum.

``expect.rules`` names the HealthMonitor rules the scenario must light up
(the detection verdict); the safety and liveness verdicts are computed
mechanically from the consensus audit logs and the scraped timeline and
need no per-scenario configuration.

Everything randomized (netem jitter/loss draws, Byzantine peer-set
splits) derives from ``seed``; the ``NARWHAL_FAULT_SEED`` env var
overrides the file so CI can re-roll a flaky draw without editing the
scenario.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.env import env_raw

PRIMARY_BEHAVIORS = (
    "equivocate",       # two conflicting headers per round, disjoint peer sets
    "wrong_key",        # headers broadcast with a rogue-key signature
    "withhold_votes",   # never vote for targeted authors' headers
    "replay_stale",     # re-broadcast own old certificates forever
)

# Worker-plane behaviors (narwhal_tpu.faults.byzantine_worker): the
# payload-availability attacks.  A behavior list may mix primary and
# worker behaviors — the runner hands the same plan to the authority's
# primary AND its workers and each plane acts only on its own set.
WORKER_BEHAVIORS = (
    "withhold_batches",  # certify via the ACK quorum, never serve the bytes
    "garbage_batches",   # serve corrupted/oversized junk to sync requests
    "sync_flood",        # repeated max-size BatchRequests (amplification)
)

BYZANTINE_BEHAVIORS = PRIMARY_BEHAVIORS + WORKER_BEHAVIORS


class SpecError(ValueError):
    pass


@dataclass
class ByzantineSpec:
    node: int                       # authority index (keypair order)
    behaviors: List[str]
    # withhold_votes: authority indices to starve; empty = every other
    # authority (resolved to base64 public keys by the runner).
    targets: List[int] = field(default_factory=list)
    replay_interval_ms: int = 250
    # sync_flood: cadence of the flood requests.
    flood_interval_ms: int = 200
    # garbage_batches: size of the junk batch served to sync requests.
    # The default sits well above the worker's default accepted-batch
    # ceiling (2 x batch_size + 64 KiB; see worker.max_batch_bytes) so
    # the junk is REJECTED and counted, not hashed and persisted.
    garbage_bytes: int = 2_200_000


@dataclass
class CrashSpec:
    node: int
    at_s: float                     # SIGKILL (primary + workers) at this offset
    restart_at_s: Optional[float]   # respawn offset; None = stays dead


@dataclass
class WanPairSpec:
    src: int                        # authority index whose OUTBOUND traffic
    dst: int                        # toward this authority is shaped
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    loss: float = 0.0


@dataclass
class PartitionSpec:
    group: List[int]                # isolated authority indices
    from_s: float
    until_s: Optional[float]        # None = never heals


@dataclass
class WanSpec:
    # Committee-wide defaults applied to every directed pair.
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    loss: float = 0.0
    pairs: List[WanPairSpec] = field(default_factory=list)
    partitions: List[PartitionSpec] = field(default_factory=list)


@dataclass
class FaultScenario:
    name: str
    nodes: int = 4
    workers: int = 1
    rate: int = 2_000
    tx_size: int = 512
    duration: int = 20
    seed: int = 0
    # Parameter overrides forwarded to narwhal_tpu.config.Parameters.
    parameters: Dict[str, int] = field(default_factory=dict)
    byzantine: List[ByzantineSpec] = field(default_factory=list)
    crash: List[CrashSpec] = field(default_factory=list)
    wan: Optional[WanSpec] = None
    # Extra environment for every node process — per-scenario health
    # thresholds (NARWHAL_HEALTH_*) and network knobs
    # (NARWHAL_NET_BACKOFF_MAX_S).  Carried into the control arm too, so
    # lowering a detection threshold keeps the control honest.
    env: Dict[str, str] = field(default_factory=dict)
    # Detection verdict: every named rule must FIRE (on >=1 node) in the
    # fault arm; the control arm must fire no rule at all.
    expect_rules: List[str] = field(default_factory=list)
    # Extra seconds the liveness gate may stretch waiting for payload
    # commits (matches local_bench's progress_wait semantics).
    progress_wait: float = 30.0

    # -- derived -------------------------------------------------------------

    def byzantine_nodes(self) -> List[int]:
        return sorted({b.node for b in self.byzantine})

    def honest_nodes(self) -> List[int]:
        byz = set(self.byzantine_nodes())
        return [i for i in range(self.nodes) if i not in byz]

    def is_clean(self) -> bool:
        return not (self.byzantine or self.crash or self.wan)

    def control_arm(self) -> "FaultScenario":
        """The same committee/load with every fault plane stripped — the
        arm whose timeline must show ZERO firing rules."""
        return FaultScenario(
            name=f"{self.name}.control",
            nodes=self.nodes,
            workers=self.workers,
            rate=self.rate,
            tx_size=self.tx_size,
            duration=self.duration,
            seed=self.seed,
            parameters=dict(self.parameters),
            env=dict(self.env),
            progress_wait=self.progress_wait,
        )


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


def load_scenario(path: str, env: Optional[Dict[str, str]] = None) -> FaultScenario:
    with open(path) as f:
        return parse_scenario(json.load(f), env=env)


def parse_scenario(
    obj: dict, env: Optional[Dict[str, str]] = None
) -> FaultScenario:
    env = os.environ if env is None else env
    _require(isinstance(obj, dict), "scenario must be a JSON object")
    _require("name" in obj, "scenario needs a name")
    known = {
        "name", "nodes", "workers", "rate", "tx_size", "duration", "seed",
        "parameters", "byzantine", "crash", "wan", "expect", "env",
        "progress_wait",
    }
    unknown = set(obj) - known
    _require(not unknown, f"unknown scenario field(s): {sorted(unknown)}")

    nodes = int(obj.get("nodes", 4))
    # Up to 10 is what the socketed one-host runner can carry; the
    # deterministic simulation harness (narwhal_tpu/sim) runs the same
    # specs at N=20/50 on one event loop.
    _require(4 <= nodes <= 50, "nodes must be in [4, 50]")

    # The override must fail LOUD on garbage (unlike the warn-and-default
    # registry accessors): the fault suite's premise is byte-for-byte
    # replayability from a seed, and a silently-ignored override would
    # run a different stochastic draw than the one the operator asked
    # to reproduce while the artifact claims otherwise.
    raw_seed = env_raw("NARWHAL_FAULT_SEED", env=env)
    if raw_seed is not None:
        try:
            seed = int(raw_seed)
        except ValueError:
            raise SpecError(
                f"NARWHAL_FAULT_SEED={raw_seed!r} is not an integer"
            ) from None
    else:
        seed = int(obj.get("seed", 0))

    byz = []
    for b in obj.get("byzantine", []):
        behaviors = list(b.get("behaviors", []))
        _require(behaviors, "byzantine entry needs behaviors")
        node_dup = int(b["node"])
        _require(
            node_dup not in {x.node for x in byz},
            f"duplicate byzantine entry for node {node_dup} (one entry "
            "per node — the runner writes ONE plan file per authority, "
            "so a second entry would silently replace the first; list "
            "all of a node's behaviors in one entry)",
        )
        for beh in behaviors:
            _require(
                beh in BYZANTINE_BEHAVIORS,
                f"unknown byzantine behavior {beh!r} "
                f"(known: {list(BYZANTINE_BEHAVIORS)})",
            )
        node = int(b["node"])
        _require(0 <= node < nodes, f"byzantine node {node} out of range")
        targets = [int(t) for t in b.get("targets", [])]
        for t in targets:
            _require(0 <= t < nodes and t != node, f"bad withhold target {t}")
        byz.append(
            ByzantineSpec(
                node=node,
                behaviors=behaviors,
                targets=targets,
                replay_interval_ms=int(b.get("replay_interval_ms", 250)),
                flood_interval_ms=int(b.get("flood_interval_ms", 200)),
                garbage_bytes=int(b.get("garbage_bytes", 2_200_000)),
            )
        )
    # One node's Helper can refuse sync requests or poison them, not both
    # — the two behaviors own the same serve decision.
    for b in byz:
        _require(
            not {"withhold_batches", "garbage_batches"} <= set(b.behaviors),
            f"node {b.node}: withhold_batches and garbage_batches "
            "conflict (both decide what the Helper serves)",
        )
    # Faults must stay within BFT tolerance or the verdicts are vacuous.
    f_tol = (nodes - 1) // 3
    _require(
        len({b.node for b in byz}) <= f_tol,
        f"{len(byz)} byzantine node(s) exceeds f={f_tol} for n={nodes}",
    )

    crash = []
    for c in obj.get("crash", []):
        node = int(c["node"])
        _require(0 <= node < nodes, f"crash node {node} out of range")
        at_s = float(c["at_s"])
        restart = c.get("restart_at_s")
        if restart is not None:
            restart = float(restart)
            _require(restart > at_s, "restart_at_s must come after at_s")
        crash.append(CrashSpec(node=node, at_s=at_s, restart_at_s=restart))
    _require(
        len({c.node for c in crash} | {b.node for b in byz}) <= f_tol,
        f"crashed+byzantine nodes exceed f={f_tol} for n={nodes}",
    )

    wan = None
    if "wan" in obj and obj["wan"]:
        w = obj["wan"]
        pairs = []
        for p in w.get("pairs", []):
            src, dst = int(p["src"]), int(p["dst"])
            _require(
                0 <= src < nodes and 0 <= dst < nodes and src != dst,
                f"bad wan pair {src}->{dst}",
            )
            pairs.append(
                WanPairSpec(
                    src=src,
                    dst=dst,
                    latency_ms=float(p.get("latency_ms", 0.0)),
                    jitter_ms=float(p.get("jitter_ms", 0.0)),
                    loss=float(p.get("loss", 0.0)),
                )
            )
        partitions = []
        for p in w.get("partitions", []):
            group = sorted({int(g) for g in p["group"]})
            _require(group, "partition needs a non-empty group")
            for g in group:
                _require(0 <= g < nodes, f"partition node {g} out of range")
            _require(
                len(group) <= f_tol,
                f"partitioned group of {len(group)} exceeds f={f_tol}",
            )
            # Fault planes compose: a node that is byzantine or crashed
            # WHILE another is partitioned away counts against the same
            # f — otherwise the committee silently loses quorum and the
            # verdicts are vacuous.
            _require(
                len(
                    set(group)
                    | {c.node for c in crash}
                    | {b.node for b in byz}
                )
                <= f_tol,
                f"partitioned+crashed+byzantine nodes exceed f={f_tol} "
                f"for n={nodes}",
            )
            until = p.get("until_s")
            partitions.append(
                PartitionSpec(
                    group=group,
                    from_s=float(p["from_s"]),
                    until_s=None if until is None else float(until),
                )
            )
        loss = float(w.get("loss", 0.0))
        _require(0.0 <= loss < 1.0, "wan.loss must be in [0, 1)")
        wan = WanSpec(
            latency_ms=float(w.get("latency_ms", 0.0)),
            jitter_ms=float(w.get("jitter_ms", 0.0)),
            loss=loss,
            pairs=pairs,
            partitions=partitions,
        )

    # Every timed fault must land INSIDE the declared measurement window:
    # an offset past `duration` would silently stretch the run (the event
    # loop sleeps until the offset before acting) and push the liveness
    # settle point outside the scraped window, hollowing out the verdict.
    duration = int(obj.get("duration", 20))
    for c in crash:
        _require(
            c.at_s < duration,
            f"crash at_s={c.at_s} is at/after duration={duration}",
        )
        if c.restart_at_s is not None:
            _require(
                c.restart_at_s < duration,
                f"restart_at_s={c.restart_at_s} is at/after "
                f"duration={duration}",
            )
    if wan is not None:
        for p in wan.partitions:
            _require(
                p.from_s < duration,
                f"partition from_s={p.from_s} is at/after "
                f"duration={duration}",
            )
            if p.until_s is not None:
                _require(
                    p.until_s <= duration,
                    f"partition until_s={p.until_s} is after "
                    f"duration={duration}",
                )

    expect = obj.get("expect", {}) or {}
    expect_rules = list(expect.get("rules", []))

    env_extra = {}
    for k, v in (obj.get("env", {}) or {}).items():
        _require(
            isinstance(k, str) and isinstance(v, (str, int, float)),
            f"env entries must be string-keyed scalars: {k!r}",
        )
        env_extra[k] = str(v)

    return FaultScenario(
        name=str(obj["name"]),
        nodes=nodes,
        workers=int(obj.get("workers", 1)),
        rate=int(obj.get("rate", 2_000)),
        tx_size=int(obj.get("tx_size", 512)),
        duration=duration,
        seed=seed,
        parameters=dict(obj.get("parameters", {})),
        byzantine=byz,
        crash=crash,
        wan=wan,
        env=env_extra,
        expect_rules=expect_rules,
        progress_wait=float(obj.get("progress_wait", 30.0)),
    )
