"""Fuzzed fault-scenario generation: one seed → one replayable scenario.

``generate(seed)`` derives a random-but-fully-seeded scenario instance —
which fault planes run, on which node, with what timing windows and
netem shape — as a PLAIN scenario-spec dict (the benchmark/scenarios
JSON schema).  benchmark/fault_bench.py replays generated scenarios
through the same three-verdict engine as the hand-written ones, and
dumps each as a normal JSON spec first, so any fuzz catch is replayable
byte-for-byte with ``--scenario`` and no fuzzer in the loop.

Design constraints that keep every draw judgeable:

- **Detection stays derivable.**  Each behavior carries its detection
  contract — the health rule it must light up plus the env/parameter
  knobs that make the rule's timing deterministic on a shared-core host
  (the same values the hand-written scenarios pinned).  ``expect.rules``
  is the union over the drawn behaviors, so the detection verdict is
  never vacuous.
- **BFT bound by construction.**  All byzantine behaviors land on ONE
  node, and a drawn crash hits that same node — the faulted-node union
  is always 1 ≤ f, whatever the seed (parse_scenario re-checks anyway).
- **WAN noise is noise.**  The optional netem shape is mild (it has no
  expected rule of its own); fault arms tolerate extra firings, and the
  control arm strips it, so the shape can randomize freely.

The generator never touches the process RNG: everything flows from one
``random.Random(seed)``, so ``generate(s) == generate(s)`` exactly.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

# Committee sizes a draw may pick.  4/7/10 are what the socketed
# one-host runner can carry (it passes a pruned pool); 20 is the
# committee-at-scale point the deterministic simulation harness
# (narwhal_tpu/sim, benchmark/sim_bench.py) exists to explore.
SIZES: Tuple[int, ...] = (4, 7, 10, 20)

# (behavior, expected rules, env knobs, parameter overrides) — the
# detection contract of each plane, mirrored from the hand-written
# scenarios that validated these values end-to-end.
_PRIMARY_POOL: List[Tuple[str, List[str], Dict[str, str], Dict[str, int]]] = [
    ("equivocate", ["equivocation"], {}, {}),
    ("wrong_key", ["invalid_signature"], {}, {}),
    (
        "withhold_votes",
        ["peer_vote_silence"],
        {"NARWHAL_HEALTH_VOTE_SILENCE_WINDOW_S": "6"},
        {},
    ),
    # gc_depth 8 so the replayed certificates fall behind the horizon
    # within the window (byz_replay_stale.json's values).
    ("replay_stale", ["stale_replay"], {}, {"gc_depth": 8}),
]

_WORKER_POOL: List[Tuple[str, List[str], Dict[str, str], Dict[str, int]]] = [
    # A raised retry delay + lowered age threshold makes the starvation
    # window unambiguous before escalation recovers the bytes.
    (
        "withhold_batches",
        ["batch_withholding"],
        {"NARWHAL_HEALTH_SYNC_AGE_S": "3"},
        {"sync_retry_delay": 6_000},
    ),
    (
        "garbage_batches",
        ["garbage_batches"],
        {"NARWHAL_HEALTH_SYNC_AGE_S": "3"},
        {"sync_retry_delay": 4_000},
    ),
    ("sync_flood", ["helper_abuse"], {}, {}),
]


def generate(seed: int, sizes: Sequence[int] = SIZES) -> dict:
    """One seeded scenario-spec dict (see module docstring).  Pass the
    result to ``narwhal_tpu.faults.spec.parse_scenario`` (fault_bench
    and sim_bench do) — the generator stays within the schema's bounds,
    and parsing re-validates every invariant regardless.

    ``sizes`` is the committee-size pool the draw picks from (the
    socketed runner prunes it to what one host can carry; the sim
    harness uses the full pool).  All faults still land on ONE node, so
    the faulted-node union is 1 ≤ f at every size in the pool."""
    rng = random.Random(seed)
    nodes = rng.choice(list(sizes))

    env: Dict[str, str] = {}
    parameters: Dict[str, int] = {}
    rules: set = set()
    behaviors: List[str] = []

    primary = rng.random() < 0.7 and rng.choice(_PRIMARY_POOL)
    worker = rng.random() < 0.7 and rng.choice(_WORKER_POOL)
    if not primary and not worker:
        # Every scenario needs at least one behavior; re-draw the plane
        # the dice liked least (still pure-seed-derived).
        worker = rng.choice(_WORKER_POOL)
    for pick in (primary, worker):
        if not pick:
            continue
        behavior, expect, env_knobs, param_knobs = pick
        behaviors.append(behavior)
        rules.update(expect)
        env.update(env_knobs)
        parameters.update(param_knobs)
    # Behavior masking: wrong_key makes every header of the adversary
    # invalid, so honest peers never accept the headers that would
    # reference its batches — and without accepted references nobody
    # requests the bytes, which is the ONLY evidence path the
    # batch-availability rules observe.  The worker behavior still runs
    # (stress), but its rule leaves the detection contract: expecting it
    # would make the verdict fail for a reason that is protocol
    # semantics, not a detection gap (found by the sim sweep at N=10).
    if "wrong_key" in behaviors:
        rules.discard("batch_withholding")
        rules.discard("garbage_batches")

    # Duration draw: scenario length varies per seed; replay_stale needs
    # the extra tail for the GC horizon to pass the replayed rounds.
    duration = rng.choice([25, 30, 35])
    if "replay_stale" in behaviors:
        duration = max(duration, 35)
        if nodes > 10:
            # Staleness evidence needs the committee's COMMITTED round to
            # clear gc_depth (8) past the replayed early rounds, and the
            # sim stretches large-committee cadence to ~5 s rounds — at
            # 35 s the horizon never moves and the rule provably cannot
            # fire (sweep points 7017/7036 at N=20 sat at committed
            # round 2 all run).  ~16 rounds is enough with margin.
            duration = max(duration, 80)
    byz_node = rng.randrange(nodes)
    byz_entry: dict = {"node": byz_node, "behaviors": behaviors}
    if "replay_stale" in behaviors:
        byz_entry["replay_interval_ms"] = 100
    if "sync_flood" in behaviors:
        byz_entry["flood_interval_ms"] = rng.choice([100, 200, 400])

    obj: dict = {
        "name": f"fuzz_{seed}",
        "nodes": nodes,
        "workers": 1,
        "rate": rng.choice([1_500, 2_000, 2_500]),
        "tx_size": 512,
        "duration": duration,
        "seed": seed,
        "byzantine": [byz_entry],
    }
    if parameters:
        obj["parameters"] = parameters

    # Optional crash/restart of the SAME node (union stays 1 ≤ f): the
    # adversary has been active since boot, so its detections fire well
    # before the kill; the restart respawns it with the same plan.
    if rng.random() < 0.35:
        at_s = rng.randrange(14, 19)
        restart_at_s = at_s + rng.randrange(5, 9)
        obj["duration"] = max(obj["duration"], restart_at_s + 23)
        obj["crash"] = [
            {"node": byz_node, "at_s": at_s, "restart_at_s": restart_at_s}
        ]
        env["NARWHAL_NET_BACKOFF_MAX_S"] = "2"
        rules.add("peer_unreachable")

    # Optional mild WAN shape — pure noise, no expected rule.
    if rng.random() < 0.5:
        obj["wan"] = {
            "latency_ms": rng.randrange(10, 41),
            "jitter_ms": rng.randrange(0, 11),
            "loss": rng.choice([0.0, 0.02, 0.05]),
        }

    if env:
        obj["env"] = env
    obj["expect"] = {"rules": sorted(rules)}
    obj["progress_wait"] = 45
    return obj
