"""Node CLI (reference node/src/main.rs, 141 LoC).

    python -m narwhal_tpu.node generate_keys --filename keys.json
    python -m narwhal_tpu.node run --keys k.json --committee c.json \
        [--parameters p.json] --store db primary
    python -m narwhal_tpu.node run ... worker --id 0
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys

from ..analysis.watchdog import install_from_env as install_loop_watchdog
from ..config import Committee, Parameters, export_keypair, load_keypair
from ..crypto import KeyPair
from ..utils.env import env_flag, env_float, env_str
from ..utils.tasks import spawn
from .node import spawn_primary_node, spawn_worker_node


class JsonLogFormatter(logging.Formatter):
    """One-line-JSON log records: {ts, level, logger, msg, node} (+exc).

    ``ts`` is unix epoch seconds (float) so log events join directly
    against the metrics time-series and scraper timeline, which all use
    ``time.time()`` — no timestamp re-parsing.  ``node`` identifies the
    process in a committee-wide merged stream (role + worker id + key
    prefix).  HealthMonitor anomaly lines come through here too, which is
    the point: one machine-joinable event stream per node.
    """

    def __init__(self, node_id: str) -> None:
        super().__init__()
        self.node_id = node_id

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "node": self.node_id,
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def setup_logging(
    verbosity: int,
    level_name: str | None = None,
    json_logs: bool = False,
    node_id: str = "",
) -> None:
    # Explicit --log-level (or the NARWHAL_LOG env var) wins over -v; the
    # level is applied to the whole `narwhal.*` hierarchy — every module
    # logs under it (narwhal.worker, narwhal.primary, narwhal.consensus,
    # narwhal.network, narwhal.node, narwhal.client, narwhal.metrics).
    level_name = level_name or env_str("NARWHAL_LOG")
    if level_name:
        level = getattr(logging, level_name.upper(), None)
        if not isinstance(level, int):
            raise SystemExit(f"unknown log level {level_name!r}")
    else:
        level = [logging.ERROR, logging.INFO, logging.DEBUG][min(verbosity, 2)]
    # Millisecond timestamps: the benchmark log parser depends on them
    # (reference main.rs:54-55).  --log-json swaps the formatter for the
    # machine-joinable one-line-JSON form; the human format stays the
    # default (and is what the bench log parser requires).
    logging.basicConfig(
        level=level,
        format="%(asctime)s.%(msecs)03dZ %(levelname)s %(name)s %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
        stream=sys.stderr,
        force=True,
    )
    if json_logs:
        formatter = JsonLogFormatter(node_id)
        for handler in logging.getLogger().handlers:
            handler.setFormatter(formatter)
    logging.getLogger("narwhal").setLevel(level)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="narwhal-tpu-node",
        description="A PyTorch/CUDA implementation of Narwhal and Tusk.",
    )
    parser.add_argument("-v", action="count", default=1, dest="verbosity")
    parser.add_argument(
        "--log-level",
        choices=["debug", "info", "warning", "error", "critical"],
        default=None,
        help="Log level for the whole narwhal.* hierarchy (overrides -v; "
        "the NARWHAL_LOG env var is the equivalent knob for harnesses "
        "that cannot edit the command line)",
    )
    parser.add_argument(
        "--log-json",
        action="store_true",
        default=False,
        help="Emit one-line-JSON log records ({ts, level, logger, msg, "
        "node}, ts = unix epoch) instead of the human format, so anomaly "
        "events and logs join machine-side with the metrics time-series. "
        "The bench log parser requires the human default.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    gen = sub.add_parser("generate_keys", help="Print a fresh keypair to file")
    gen.add_argument("--filename", required=True)

    run = sub.add_parser("run", help="Run a node")
    run.add_argument("--keys", required=True)
    run.add_argument("--committee", required=True)
    run.add_argument("--parameters")
    run.add_argument("--store", required=True)
    run.add_argument("--benchmark", action="store_true", default=False)
    run.add_argument(
        "--experimental-consensus-kernel",
        action="store_true",
        default=False,
        help="EXPERIMENTAL: run Tusk's order_leaders on the card's "
        "hand-written CUDA kernels (a count window resident on the card, "
        "one W-bool commit fetch per commit opportunity); --device cpu "
        "runs their plain PyTorch twins.",
    )
    run.add_argument(
        "--device",
        default=None,
        help="Where the device path runs (the cuda crypto backend and the "
        "consensus kernel): unset means the GPU, and cpu runs the "
        "kernels' plain PyTorch twins.  Without a GPU, a cuda or kernel "
        "request fails at boot unless this is cpu.",
    )
    run.add_argument(
        "--crypto-backend",
        choices=["cpu", "cuda", "tpu", "jax"],
        default=None,
        help="Signature verification backend: cpu (serial) or cuda (the "
        "batched verifier, one hand-written CUDA kernel launch per burst "
        "on the card; --device cpu runs its plain PyTorch twin).  tpu "
        "and jax, the reference's names for its batched verifier, select "
        "cuda, so one command line serves a mixed committee.  Default: "
        "the NARWHAL_CRYPTO_BACKEND env knob, else cpu.  A cuda request "
        "that finds no card or cannot build its kernels fails AT BOOT "
        "unless NARWHAL_CRYPTO_BACKEND_STRICT=0.",
    )
    run.add_argument(
        "--cert-sig-scheme",
        choices=["individual", "halfagg"],
        default=None,
        help="Certificate signature scheme: individual (2f+1 ed25519 "
        "vote signatures per certificate, the default) or halfagg "
        "(ed25519 half-aggregation: the quorum folds into ONE 32*(q+1)-"
        "byte blob verified by a single multiexp equation — ~44%% fewer "
        "certificate signature bytes and 1 verify op per certificate "
        "instead of 2f+1).  Default: the NARWHAL_CERT_SIG_SCHEME env "
        "knob, else individual.  Committee-wide — a cross-scheme frame "
        "refuses at decode, a cross-scheme checkpoint refuses at boot.",
    )
    run.add_argument(
        "--commit-rule",
        choices=["classic", "lowdepth", "multileader"],
        default=None,
        help="Consensus commit rule: classic (Tusk, depth-3 commits on "
        "f+1 support), lowdepth (Mysticeti-style direct commit on "
        "2f+1 support one round after the leader), or multileader "
        "(Mysticeti multi-slot: 3 round-salted leader slots per even "
        "round, the commit anchors on the lowest supported slot) — each "
        "non-classic rule judged against its own golden oracle.  "
        "Default: the NARWHAL_COMMIT_RULE env knob, else classic.  "
        "Committee-wide — every node must run the same rule, and a "
        "checkpoint written under one rule refuses to restore under "
        "another.",
    )
    run.add_argument(
        "--metrics-path",
        default=None,
        help="Write a JSON metrics snapshot (atomic rewrite) to this path "
        "every --metrics-interval seconds, plus a final one at shutdown. "
        "Unset = no snapshot file.",
    )
    run.add_argument(
        "--metrics-interval",
        type=float,
        default=1.0,
        help="Seconds between metrics snapshot rewrites (default 1.0)",
    )
    run.add_argument(
        "--metrics-port",
        type=int,
        default=0,
        help="Serve Prometheus text metrics on this port (GET /metrics; "
        "GET /metrics.json for the snapshot form, ?trace=0 to omit the "
        "stage-trace table; GET /healthz for the 200/503 anomaly-rule "
        "verdict).  0 = disabled.",
    )
    run.add_argument(
        "--fault-plan",
        default=None,
        help="FAULT INJECTION: path to a Byzantine plan JSON "
        "({behaviors, seed, withhold_targets, replay_interval_ms, "
        "flood_interval_ms, garbage_bytes}).  On a primary it swaps the "
        "Proposer/Core for their Byzantine wrappers "
        "(narwhal_tpu/faults/byzantine.py); on a worker it swaps the "
        "BatchMaker/Helper and spawns the sync flooder "
        "(narwhal_tpu/faults/byzantine_worker.py) — each role acts only "
        "on its own plane's behaviors, so one plan file serves a whole "
        "authority.  The NARWHAL_FAULT_PLAN env var is the equivalent "
        "knob for harnesses.  Never set this on a node you care about: "
        "it makes the node ATTACK its committee.",
    )
    run.add_argument(
        "--health-interval",
        type=float,
        default=None,
        help="Seconds between health-rule evaluations (default 1.0, or "
        "the NARWHAL_HEALTH_INTERVAL env var).  NARWHAL_HEALTH=0 "
        "disables the monitor entirely; rule thresholds are tuned via "
        "NARWHAL_HEALTH_* env vars (see README 'Observability').",
    )
    runsub = run.add_subparsers(dest="role", required=True)
    runsub.add_parser("primary", help="Run a single primary")
    wrk = runsub.add_parser("worker", help="Run a single worker")
    wrk.add_argument("--id", type=int, required=True)

    warm = sub.add_parser(
        "prewarm",
        help="Build the CUDA kernel library (into build/ beside the "
        "package), then run the verifier at every burst pad of a "
        "committee and a consensus kernel window once, then exit.  Run "
        "this once before launching card-flagged nodes, so that they "
        "load a built library instead of all building it at once.",
    )
    warm.add_argument(
        "--device",
        default=None,
        help="Where the device path runs (the cuda crypto backend and the "
        "consensus kernel): unset means the GPU, and cpu runs the "
        "kernels' plain PyTorch twins.  Without a GPU, a cuda or kernel "
        "request fails at boot unless this is cpu.",
    )
    warm.add_argument("--committee", required=True)
    warm.add_argument(
        "--experimental-consensus-kernel",
        action="store_true",
        default=False,
    )
    warm.add_argument("--gc-depth", type=int, default=None)
    warm.add_argument(
        "--skip-verify",
        action="store_true",
        default=False,
        help="Skip the verify-kernel warmup (e.g. consensus-kernel-only "
        "runs keep CPU crypto)",
    )

    args = parser.parse_args(argv)

    if args.command == "generate_keys":
        export_keypair(KeyPair.generate(), args.filename)
        return 0

    if args.command == "prewarm":
        setup_logging(args.verbosity, args.log_level)
        log = logging.getLogger("narwhal.node")
        committee = Committee.load(args.committee)
        from ..ops import library, resolve_device

        if resolve_device(args.device).type == "cuda":
            log.info("Building the kernel library...")
            library()
            log.info("Kernel library ready")
        if not args.skip_verify:
            from ..crypto import backend as crypto_backend
            from .node import derive_max_claims

            crypto_backend.set_backend("cuda", device=args.device)
            backend = crypto_backend.get_backend()
            log.info("Prewarming cuda verify backend...")
            backend.warmup(max_claims=derive_max_claims(committee))
            log.info("Verify backend ready")
        if args.experimental_consensus_kernel:
            from ..ops.reachability import KernelTusk

            gc_depth = (
                args.gc_depth
                if args.gc_depth is not None
                else Parameters().gc_depth
            )
            log.info("Prewarming consensus kernel...")
            KernelTusk(committee, gc_depth, device=args.device).prewarm()
            log.info("Consensus kernel ready")
        return 0

    # Keypair first: the JSON log formatter stamps every record with a
    # node id derived from it (role + worker id + key prefix).
    keypair = load_keypair(args.keys)
    node_id = f"{args.role}-{keypair.name.encode_base64()[:8]}"
    if args.role == "worker":
        node_id = f"{args.role}{args.id}-{keypair.name.encode_base64()[:8]}"
    setup_logging(
        args.verbosity, args.log_level, json_logs=args.log_json,
        node_id=node_id,
    )
    committee = Committee.load(args.committee)
    parameters = (
        Parameters.load(args.parameters) if args.parameters else Parameters()
    )
    parameters.log(logging.getLogger("narwhal.node"))
    # Crypto backend selection happens HERE, at boot (CLI flag, else the
    # NARWHAL_CRYPTO_BACKEND env knob, else cpu): a jax/tpu request whose
    # import fails raises NOW with the import error instead of deep in
    # the first verify burst (NARWHAL_CRYPTO_BACKEND_STRICT=0 downgrades
    # that to a logged cpu fallback).  The warmup that pre-compiles the
    # burst shapes runs in spawn_primary_node, against whatever backend
    # this call selected.
    from ..crypto import backend as crypto_backend

    requested = crypto_backend.set_backend_from_env(
        args.crypto_backend, device=args.device
    )
    logging.getLogger("narwhal.node").info(
        "Crypto backend: %s (requested %s)",
        crypto_backend.get_backend().name, requested,
    )
    # Commit rule resolves the same way (CLI > NARWHAL_COMMIT_RULE >
    # classic) and is logged at boot so a bench arm's logs prove which
    # rule actually ran; garbage raises HERE, before any socket binds.
    from ..consensus import resolve_commit_rule

    logging.getLogger("narwhal.node").info(
        "Commit rule: %s", resolve_commit_rule(args.commit_rule)
    )
    # Certificate-signature scheme: same precedence (CLI >
    # NARWHAL_CERT_SIG_SCHEME > individual), pinned process-wide before
    # any certificate is assembled or decoded; garbage raises here.
    from ..crypto import aggregate as cert_sig

    cert_sig.set_scheme(cert_sig.resolve_scheme(args.cert_sig_scheme))
    logging.getLogger("narwhal.node").info(
        "Certificate signature scheme: %s", cert_sig.scheme()
    )

    async def run_node() -> None:
        # Graceful SIGTERM: set the stop event from the loop (raising out of
        # a sync signal handler would interrupt arbitrary tasks and litter
        # the logs with spurious exceptions the bench parser flags).
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)

        # Observability plane: periodic JSON snapshots and/or the
        # Prometheus endpoint.  Both read the same per-process registry.
        from .. import metrics as _metrics

        snapshot_task = None
        metrics_server = None
        health_task = None
        flight_task = None
        # Loop-stall watchdog (NARWHAL_LOOP_WATCHDOG_MS): measured proof
        # that no callback holds this node's event loop — the runtime
        # half of the narwhal-lint invariant suite.
        loop_watchdog = install_loop_watchdog()
        # Sampling profiler (NARWHAL_PROFILE_HZ, default ~67 Hz): all-
        # thread stack samples folded into the `profile.*` series —
        # general CPU attribution with no hand-placed probes.  Armed only
        # where a snapshot path or a metrics port exports them.
        from .. import profiling as _profiling

        profiler_thread = _profiling.install_from_env(
            exported=bool(args.metrics_path or args.metrics_port)
        )
        # Flight recorder: the registry-attached ring records landmarks
        # from everywhere; this process stamps its identity on it (dump
        # filenames + /debug/flight) and runs the per-tick delta sampler.
        flight = _metrics.registry().flight
        flight.node_id = node_id
        if flight.enabled:
            flight_task = spawn(flight.run(), name="flight-ticks")
        if args.metrics_path:
            snapshot_task = spawn(
                _metrics.SnapshotWriter(
                    _metrics.registry(),
                    args.metrics_path,
                    interval_s=args.metrics_interval,
                ).run(),
                name="metrics-snapshot",
            )
        # Live health: always on when metrics are (cost: one rule sweep
        # per interval).  Attached to the registry so snapshots carry a
        # `health` section and /healthz answers from it.
        if _metrics.registry().enabled and env_flag("NARWHAL_HEALTH"):
            monitor = _metrics.HealthMonitor(
                _metrics.registry(), interval_s=args.health_interval
            )
            _metrics.registry().health = monitor
            health_task = spawn(monitor.run(), name="health-monitor")
        if args.metrics_port:
            metrics_server = await _metrics.MetricsServer.spawn(
                _metrics.registry(), args.metrics_port
            )

        # One plan file serves a whole authority: each role acts only on
        # its own plane's behaviors (primary.py / worker.py filter via
        # primary_behaviors()/worker_behaviors()).
        fault_plan = None
        plan_path = args.fault_plan or env_str("NARWHAL_FAULT_PLAN")
        if plan_path:
            from ..faults.byzantine import ByzantinePlan

            fault_plan = ByzantinePlan.load(plan_path)
            active = (
                fault_plan.primary_behaviors()
                if args.role == "primary"
                else fault_plan.worker_behaviors()
            )
            if active:
                logging.getLogger("narwhal.node").warning(
                    "FAULT INJECTION ACTIVE: byzantine %s behaviors %s",
                    args.role, sorted(active),
                )

        if args.role == "primary":
            node = await spawn_primary_node(
                keypair,
                committee,
                parameters,
                store_path=f"{args.store}/store.log",
                benchmark=args.benchmark,
                use_kernel=args.experimental_consensus_kernel,
                fault_plan=fault_plan,
                commit_rule=args.commit_rule,
                device=args.device,
            )
        else:
            node = await spawn_worker_node(
                keypair,
                args.id,
                committee,
                parameters,
                store_path=f"{args.store}/store.log",
                benchmark=args.benchmark,
                fault_plan=fault_plan,
            )
        try:
            await stop.wait()  # run until SIGTERM/SIGINT
            # Logged BEFORE teardown: a node whose log simply stops is
            # indistinguishable from a wedged event loop — this line is
            # what tells a fault-suite post-mortem "shutdown was asked
            # for" from "the node went dark".
            logging.getLogger("narwhal.node").info(
                "Shutdown signal received; tearing down"
            )
            # SIGTERM is one of the flight recorder's dump triggers: the
            # ring written here is the node's own account of its last
            # seconds, independent of any scraper having been attached.
            flight.record("shutdown", signal="SIGTERM")
            flight.dump("sigterm")
        finally:
            await node.shutdown()
            if metrics_server is not None:
                await metrics_server.shutdown()
            if health_task is not None:
                health_task.cancel()
                await asyncio.gather(health_task, return_exceptions=True)
            if snapshot_task is not None:
                # Cancellation triggers the writer's final flush, so the
                # snapshot on disk covers the whole run.
                snapshot_task.cancel()
                await asyncio.gather(snapshot_task, return_exceptions=True)
            if flight_task is not None:
                flight_task.cancel()
                await asyncio.gather(flight_task, return_exceptions=True)
            if loop_watchdog is not None:
                await loop_watchdog.shutdown()
            if profiler_thread is not None:
                profiler_thread.shutdown()

    # NARWHAL_FAULTHANDLER_S=<seconds>: C-level watchdog that dumps every
    # thread's stack to stderr each interval — it fires even when the
    # event loop is wedged in CPU-bound Python (where nothing above the
    # loop can log), which is exactly the state a fault-suite post-mortem
    # needs to see.  Debug aid; off by default.
    interval = env_float("NARWHAL_FAULTHANDLER_S")
    if interval and interval > 0:
        import faulthandler

        faulthandler.dump_traceback_later(interval, repeat=True)

    # NARWHAL_PROFILE=<dir>: cProfile the whole node, dumping stats on
    # SIGTERM (the harness sends SIGTERM before SIGKILL for this reason).
    profile_dir = env_str("NARWHAL_PROFILE")
    profiler = None
    if profile_dir:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()

    try:
        asyncio.run(run_node())
    except KeyboardInterrupt:
        pass
    finally:
        if profiler is not None:
            profiler.disable()
            os.makedirs(profile_dir, exist_ok=True)
            role = args.role if args.command == "run" else "node"
            profiler.dump_stats(
                os.path.join(profile_dir, f"{role}-{os.getpid()}.prof")
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
