"""Node assembly: wire Primary + Consensus (+ application sink), or a Worker.

Reference node/src/main.rs:69-141: `run … primary` spawns the Primary and
the Consensus task joined by channels (the consensus output loops back to the
primary's GarbageCollector); `run … worker --id N` spawns a Worker;
`analyze()` is the application layer stub that consumes committed
certificates.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, List, Optional

from .. import metrics
from ..config import Committee, Parameters, WorkerId
from ..utils.env import env_int, env_str
from ..utils.tasks import spawn
from ..consensus import Consensus
from ..crypto import KeyPair
from ..primary import Primary
from ..store import Store
from ..worker import Worker

log = logging.getLogger("narwhal.node")

CHANNEL_CAPACITY = 1_000


def derive_max_claims(committee: Committee) -> int:
    """Largest claim batch a Core burst can produce: the max messages
    per verify dispatch (DRAIN_LIMIT, or NARWHAL_VERIFY_BATCH_MAX when
    the accumulation window coalesces several drains into one dispatch),
    each a certificate carrying its header claim plus one quorum of vote
    claims.  Worst case is the LARGEST vote set that can form a quorum
    (smallest stakes first), not the smallest.  Shared between node boot
    and the bench harness's device pre-warm step so both compile exactly
    the same pad shapes."""
    from ..primary.core import Core
    from ..utils.env import env_float, env_int

    max_items = Core.DRAIN_LIMIT
    if env_float("NARWHAL_VERIFY_BATCH_WINDOW_MS") > 0:
        max_items = max(max_items, env_int("NARWHAL_VERIFY_BATCH_MAX"))
    stakes = sorted(a.stake for a in committee.authorities.values())
    acc, worst_votes = 0, 0
    for s in stakes:
        acc += s
        worst_votes += 1
        if acc >= committee.quorum_threshold():
            break
    return max_items * (worst_votes + 1)


class PrimaryNode:
    def __init__(self) -> None:
        self.primary: Optional[Primary] = None
        self.tasks: List[asyncio.Task] = []
        self.store: Optional[Store] = None
        # The Consensus instance, retained so in-process harnesses (the
        # simulation committee) can flush/close its audit segment at
        # quiesce — a subprocess node does this on SIGTERM instead.
        self.consensus = None

    async def shutdown(self) -> None:
        for task in self.tasks:
            task.cancel()
        if self.primary is not None:
            await self.primary.shutdown()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        if self.store is not None:
            self.store.close()


async def spawn_primary_node(
    keypair: KeyPair,
    committee: Committee,
    parameters: Parameters,
    store_path: Optional[str] = None,
    benchmark: bool = False,
    on_commit: Optional[Callable] = None,
    use_kernel: bool = False,
    fault_plan=None,
    audit_path: Optional[str] = None,
    store: Optional[Store] = None,
    consensus_cls=None,
    replay_persisted: bool = False,
    channel_capacity: Optional[int] = None,
    commit_rule: Optional[str] = None,
    device=None,
) -> PrimaryNode:
    """Primary + Consensus pair with the GC feedback loop.  `on_commit`
    (sync callable) is the application layer — the reference's `analyze()`
    stub (main.rs:137-141).

    ``fault_plan`` wires the Byzantine Proposer/Core wrappers (fault
    suite); ``audit_path`` (default: the ``NARWHAL_CONSENSUS_AUDIT`` env
    var) makes Consensus append its insert/commit audit segment for the
    golden-oracle safety replay.

    Injectable wiring for in-process harnesses (the simulation committee
    boots dozens of these on one loop): ``store`` hands the node an
    existing Store object (a sim crash/restart preserves the in-memory
    store across incarnations the way a SIGKILL preserves the on-disk
    one); ``consensus_cls`` swaps the Consensus runner (planted-mutation
    arms); ``replay_persisted`` forces the boot-time certificate replay
    even without a ``store_path`` (the retained-store restart needs it).

    ``device`` is where the consensus kernel (``use_kernel``) runs: None
    means the GPU, and ``"cpu"`` runs the kernels' plain PyTorch twins."""
    node = PrimaryNode()
    if audit_path is None:
        audit_path = env_str("NARWHAL_CONSENSUS_AUDIT") or None
    loop = asyncio.get_running_loop()
    # The boot's host phases, each a gauge in the registry beside the
    # device phases (``node.boot.*``).
    t = time.perf_counter()
    node.store = Store(store_path) if store is None else store
    metrics.gauge("node.boot.store_seconds").set(time.perf_counter() - t)

    # If the TPU verify backend is selected, compile/cache-load the kernel
    # for the live burst shapes BEFORE joining the committee: the first
    # device call can cost tens of seconds of XLA compile, which must not
    # land on the first certificate's critical path.
    from ..crypto import backend as crypto_backend

    backend = crypto_backend.get_backend()
    if hasattr(backend, "warmup"):
        # Warm every pad shape up to the worst-case burst so no live burst
        # hits XLA compile (sizing rationale in derive_max_claims).
        log.info("Warming up %s verify backend...", backend.name)
        t = time.perf_counter()
        backend.warmup(max_claims=derive_max_claims(committee))
        metrics.gauge("node.boot.verify_warmup_seconds").set(
            time.perf_counter() - t
        )
        log.info("Verify backend %s ready", backend.name)

    # One capacity for all three channels: the env knob (declared
    # NARWHAL_CHANNEL_CAPACITY, sweepable by the knee matrix) unless the
    # harness passed an explicit override.  Before the knob existed,
    # tx_new_certificates silently ignored ``channel_capacity`` by
    # reading the module constant instead of ``cap``.
    cap = (
        env_int("NARWHAL_CHANNEL_CAPACITY", CHANNEL_CAPACITY)
        if channel_capacity is None
        else channel_capacity
    )
    tx_new_certificates = metrics.InstrumentedQueue(
        cap, channel="node.tx_new_certificates"
    )
    tx_feedback = metrics.InstrumentedQueue(cap, channel="node.tx_feedback")
    tx_output = metrics.InstrumentedQueue(cap, channel="node.tx_output")

    # Same for the consensus kernel: compile its one static window shape
    # before the primary joins the committee (KernelTusk.prewarm docstring),
    # which is why the Consensus is built before Primary.spawn logs the
    # boot banner the harness waits on.
    consensus = (consensus_cls or Consensus)(
        committee,
        parameters.gc_depth,
        rx_primary=tx_new_certificates,
        tx_primary=tx_feedback,
        tx_output=tx_output,
        benchmark=benchmark,
        use_kernel=use_kernel,
        # Committed-frontier crash recovery (beyond reference parity):
        # a small atomically-rewritten file next to the store log, so a
        # restarted primary's ordering anchors at its old frontier and
        # replayed history can't re-enter the commit sequence (rationale
        # in Consensus.__init__).  Memory-only nodes (store_path=None,
        # tests/benches) skip it.
        checkpoint_path=(
            store_path + ".consensus.ckpt" if store_path else None
        ),
        audit_path=audit_path,
        # None defers to NARWHAL_COMMIT_RULE inside Consensus; the CLI
        # value (node run --commit-rule) arrives here already resolved.
        commit_rule=commit_rule,
        device=device,
    )
    if hasattr(consensus.tusk, "prewarm"):
        log.info("Warming up consensus kernel...")
        t = time.perf_counter()
        consensus.tusk.prewarm()
        metrics.gauge("node.boot.consensus_warmup_seconds").set(
            time.perf_counter() - t
        )
        log.info("Consensus kernel ready")
    node.consensus = consensus

    node.primary = await Primary.spawn(
        keypair,
        committee,
        parameters,
        node.store,
        tx_consensus=tx_new_certificates,
        rx_consensus=tx_feedback,
        benchmark=benchmark,
        fault_plan=fault_plan,
    )
    node.tasks.append(spawn(consensus.run(), name="consensus"))

    async def analyze() -> None:
        while True:
            certificate = await tx_output.get()
            if on_commit is not None:
                on_commit(certificate)

    node.tasks.append(spawn(analyze(), name="analyze"))

    # Far-frontier restore, second half (found by the crash/restart fault
    # scenario): the checkpoint anchors the committed FRONTIER, but the
    # DAG between the frontier and the pre-crash head lives only in the
    # persisted store — and on a store-preserving restart those
    # certificates never reach consensus again (peers' deliveries pass
    # their dependency checks against the store, so nothing re-routes the
    # history), leaving a permanent HOLE in this node's commit sequence
    # where every healthy peer committed.  Re-seed consensus from the
    # store: every parseable certificate above the restored per-author
    # frontier, oldest round first.  Runs as a task after the Primary is
    # up so the consensus GC feedback loop is already draining.
    if store_path is not None or replay_persisted:
        node.tasks.append(
            spawn(
                _replay_persisted_certificates(
                    node.store, consensus.tusk.state, tx_new_certificates
                ),
                name="certificate-replay",
            )
        )
    return node


async def _replay_persisted_certificates(
    store: Store, state, tx_consensus: asyncio.Queue
) -> None:
    """Feed certificates persisted by a previous incarnation back into
    the commit rule.  Values that are not certificates (headers fail the
    decode, payload markers are empty) are skipped; certificates at or
    below the restored frontier can never commit again (order_dag's ≥
    skip) and are dropped here instead of costing queue slots.

    Certificates persisted under the OTHER cert-sig scheme refuse to
    decode (SchemeMismatch); they are counted and reported in one loud
    warning naming both schemes rather than silently skipped — the
    consensus checkpoint refuses the cross-scheme boot outright, but a
    checkpoint-less store must not quietly drop its history."""
    from ..crypto import SchemeMismatch
    from ..primary.messages import Certificate

    certs = []
    cross_scheme = 0
    cross_scheme_detail = ""
    for i, value in enumerate(store.values()):
        if i % 256 == 0 and i:
            # The scan runs on the freshly booted node's event loop while
            # peers are already retrying against it — yield so sync
            # requests, votes and /healthz stay answerable throughout.
            await asyncio.sleep(0)
        if len(value) < 140:  # smaller than any vote-carrying certificate
            continue
        try:
            cert = Certificate.deserialize(value)
        except SchemeMismatch as e:
            cross_scheme += 1
            cross_scheme_detail = str(e)
            continue
        except Exception:
            continue  # a header or foreign record
        if not cert.votes and cert.agg is None:
            continue
        if cert.round <= state.last_committed.get(cert.origin, 0):
            continue
        certs.append(cert)
    if cross_scheme:
        metrics.counter("primary.invalid_signatures").inc(cross_scheme)
        log.warning(
            "Persisted store holds %d certificate(s) from the other "
            "cert-sig scheme; they cannot re-enter consensus (%s)",
            cross_scheme,
            cross_scheme_detail,
        )
    if not certs:
        return
    certs.sort(key=lambda c: c.round)
    for cert in certs:
        await tx_consensus.put(cert)
    log.info(
        "Replayed %d persisted certificates into consensus "
        "(restored frontier round %d)",
        len(certs),
        state.last_committed_round,
    )


class WorkerNode:
    def __init__(self, worker: Worker, store: Store) -> None:
        self.worker = worker
        self.store = store

    async def shutdown(self) -> None:
        await self.worker.shutdown()
        self.store.close()


async def spawn_worker_node(
    keypair: KeyPair,
    worker_id: WorkerId,
    committee: Committee,
    parameters: Parameters,
    store_path: Optional[str] = None,
    benchmark: bool = False,
    fault_plan=None,
    store: Optional[Store] = None,
) -> WorkerNode:
    """``fault_plan`` wires the Byzantine worker wrappers (batch
    withholding / garbage serving / sync flooding — the fault suite's
    worker-plane adversary); None is the honest worker.  ``store`` hands
    the worker an existing Store object (sim crash/restart; see
    spawn_primary_node)."""
    store = Store(store_path) if store is None else store
    worker = await Worker.spawn(
        keypair.name,
        worker_id,
        committee,
        parameters,
        store,
        benchmark=benchmark,
        fault_plan=fault_plan,
    )
    return WorkerNode(worker, store)
