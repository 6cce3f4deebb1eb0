"""The port's node (``node/*``) against the JAX package's, on the CPU.

- ``tests/test_e2e.py`` runs again through the port's
  ``spawn_primary_node`` / ``spawn_worker_node``: committees of primaries
  and workers in one process commit client transactions, at N=4 and
  N=10, with two workers, under a crash fault, across a restart, and
  ``node prewarm`` (here with ``--device cpu``).
- A mixed committee with workers: authorities 0–1 from ``narwhal_tpu.node``,
  2–3 from the port.  Transactions sent to a reference worker and to a
  port worker commit in one sequence at every primary of both packages.
- A committee started through ``python -m narwhal_tpu_torch.node`` as the
  reference's local bench starts one (a process per primary, per worker
  and per client, ``--device cpu``), whose logs
  ``benchmark/logs.py::parse_logs`` reads with samples and no error,
  started and checked by ``chip_smoke.py``'s node phase code.
- The crypto backend's names: ``tpu``, ``jax`` and ``cuda`` select the
  batched verifier and the boot line names the requested one; any other
  name fails at boot.  Without a card, a primary asked for ``cuda`` or
  the consensus kernel without ``--device cpu`` fails at boot.

Port blocks: the mirrored cases 24000–25299, the mixed committee
26300–26319, the CLI committee 26400–26419, the backend names
26500–26519, the no-card boots 26600–26619; no other test binds them."""

import asyncio
import os
import subprocess

import pytest
import torch

from narwhal_tpu.config import Committee as JCommittee
from narwhal_tpu.config import Parameters as JParameters
from narwhal_tpu.crypto import KeyPair as JKeyPair
from narwhal_tpu.node import spawn_primary_node as jspawn_primary
from narwhal_tpu.node import spawn_worker_node as jspawn_worker
from narwhal_tpu_torch.config import Committee as TCommittee
from narwhal_tpu_torch.config import Parameters as TParameters
from narwhal_tpu_torch.crypto import KeyPair as TKeyPair
from narwhal_tpu_torch.crypto import backend as tbackend
from narwhal_tpu_torch.crypto import digest32
from narwhal_tpu_torch.messages import encode_batch
from narwhal_tpu_torch.network.framing import parse_address, write_frame
from narwhal_tpu_torch.node import spawn_primary_node as tspawn_primary
from narwhal_tpu_torch.node import spawn_worker_node as tspawn_worker

import chip_smoke
from tests.common import committee, keys
from tests.test_torch_tasks import mirror, package_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIRRORED = mirror(
    globals(), "test_e2e",
    # On the CPU the port's device path runs its plain twins only when
    # asked: prewarm takes --device cpu.  The port's verifier compiles
    # nothing per batch shape, so it has no knob to cut the shapes it
    # warms: prewarm warms every pad up to the committee's largest burst.
    subs=(('["prewarm", "--committee", path, "--experimental-consensus-kernel",',
           '["prewarm", "--committee", path, "--experimental-consensus-kernel",'
           ' "--device", "cpu",'),
          ('monkeypatch.setenv("NARWHAL_TPU_WARMUP_SHAPES", "16")', 'pass')),
)


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED) == 6


# -- the mixed committee ------------------------------------------------------

_PARAMS = dict(header_size=32, max_header_delay=100, batch_size=400,
               max_batch_delay=100)


async def _mixed_with_workers():
    c = committee(base_port=26300)
    jc = JCommittee.from_json(c.to_json())
    tc = TCommittee.from_json(c.to_json())
    seeds = [bytes([i]) * 32 for i in range(4)]
    commits = [[] for _ in range(4)]
    nodes = []
    try:
        for i, seed in enumerate(seeds):
            record = commits[i].append
            if i < 2:
                kp = JKeyPair.generate(seed)
                nodes.append(await jspawn_primary(
                    kp, jc, JParameters(**_PARAMS), on_commit=record))
                nodes.append(await jspawn_worker(kp, 0, jc, JParameters(**_PARAMS)))
            else:
                kp = TKeyPair.generate(seed)
                nodes.append(await tspawn_primary(
                    kp, tc, TParameters(**_PARAMS), on_commit=record,
                    use_kernel=True, device="cpu"))
                nodes.append(await tspawn_worker(kp, 0, tc, TParameters(**_PARAMS)))
        # Four transactions to a reference worker, four to a port worker:
        # each worker seals them into one batch of 400 B.
        expected, writers = {}, []
        for i in (0, 2):
            host, port = parse_address(c.worker(keys()[i].name, 0).transactions)
            _, w = await asyncio.open_connection(host, port)
            writers.append(w)
            txs = [bytes([1]) + (100 * i + k).to_bytes(8, "little") + bytes(91)
                   for k in range(4)]
            for tx in txs:
                await write_frame(w, tx)
            expected[bytes(digest32(encode_batch(txs)))] = i

        def payload(seq):
            return {bytes(d) for cert in seq for d in cert.header.payload}

        while not all(set(expected) <= payload(s) for s in commits):
            await asyncio.sleep(0.05)
        for w in writers:
            w.close()
        return expected, [[bytes(cert.digest()) for cert in s] for s in commits]
    finally:
        for node in nodes:
            await node.shutdown()


def test_mixed_committee_with_workers_commits_one_sequence():
    with package_state():
        tbackend.set_backend("cpu")
        expected, seqs = asyncio.run(asyncio.wait_for(_mixed_with_workers(), 60))
    assert sorted(expected.values()) == [0, 2]
    for i in range(4):
        for j in range(i + 1, 4):
            k = min(len(seqs[i]), len(seqs[j]))
            assert k > 0 and seqs[i][:k] == seqs[j][:k], (i, j)


# -- the node CLI -------------------------------------------------------------

CLI_RATE = 50  # tx/s a client
CLI_LOAD_S = 10.0
WORKER = ("worker", "--id", "0")


def test_cli_committee_commits_client_transactions(tmp_path):
    """4 primaries (``--experimental-consensus-kernel --device cpu``), 4
    workers and 4 benchmark clients, each its own process, started and
    checked by ``chip_smoke.py``'s node phase code."""
    run = chip_smoke.run_node_committee(
        str(tmp_path), 4, 26400, CLI_RATE, CLI_LOAD_S,
        primary_flags=("--experimental-consensus-kernel", "--device", "cpu"),
        primary_boot=("Consensus kernel ready", chip_smoke.BOOTED))
    assert run["processes"] == 12
    checks = chip_smoke.node_checks(run, min_leaders=2)
    assert checks["samples"] > 0 and checks["committed_batches"] > 0
    assert min(checks["committed_headers"]) > 0
    assert checks["replay_equal"] and min(checks["replayed_headers"]) > 0
    assert sorted(run["snapshots"]) == [f"primary-{i}" for i in range(4)]
    for snap in run["snapshots"].values():
        assert snap["counters"]["consensus.kernel.dispatches"] > 0
        assert snap["counters"]["consensus.committed_certificates"] > 0
    # Four primaries that agree on a wrong order still fail: each is
    # held to the plain Tusk over its own store.
    swapped = {name: s[1::-1] + s[2:] for name, s in run["sequences"].items()}
    with pytest.raises(AssertionError, match="plain Tusk"):
        chip_smoke.node_checks(dict(run, sequences=swapped), min_leaders=2)


def test_node_checks_refuse_a_bad_run():
    """The node phase's checks fail a run whose processes or logs or
    sequences are wrong."""
    _, c = chip_smoke.loopback_committee(4, 26400, chip_smoke.NODE_SALT)
    names = sorted(c.authorities)
    leader = {r: names[r % 4] for r in (2, 4)}
    good = dict(
        committee=c, codes={"primary-0": 0, "primary-1": 0},
        logs={"primary-0": "", "primary-1": ""},
        lives={0: ["primary-0"], 1: ["primary-1"]},
        sequences={"primary-0": [(2, "h2"), (4, "h4")], "primary-1": [(2, "h2")]},
        origins={"h2": leader[2], "h4": leader[4]})
    assert chip_smoke.committed_leaders(
        good["sequences"]["primary-0"], good["origins"], c) == 2
    for broken, match in (
        (dict(codes={"primary-0": 0, "primary-1": -15}), "exited non-zero"),
        (dict(logs={"primary-0": "x ERROR y", "primary-1": ""}), "ERROR"),
    ):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.node_checks({**good, **broken}, min_leaders=1)
    # The reference's parser refuses logs without the primaries' boot
    # echo of their parameters.
    with pytest.raises(AssertionError, match="config echo missing"):
        chip_smoke.node_checks(good, min_leaders=1)


def test_commit_sequence_and_leaders_from_logs():
    log = ("t INFO narwhal.consensus Committed B2(AAAA) -> dA\n"
           "t INFO narwhal.consensus Committed B2(AAAA) -> dB\n"
           "t INFO narwhal.consensus Committed B3(BBBB)\n"
           "t INFO narwhal.consensus Committed B4(CCCC) -> dC\n")
    seq = chip_smoke.commit_sequence(log)
    assert seq == [(2, "AAAA"), (3, "BBBB"), (4, "CCCC")]
    _, c = chip_smoke.loopback_committee(4, 26400, chip_smoke.NODE_SALT)
    names = sorted(c.authorities)
    origins = {"AAAA": names[2], "BBBB": names[3], "CCCC": names[1]}
    assert chip_smoke.committed_leaders(seq, origins, c) == 1


def _processes(tmp_path, port):
    chip_smoke.node_files(str(tmp_path), 4, port, chip_smoke.NODE_SALT)
    return chip_smoke.NodeProcesses(str(tmp_path))


def test_crypto_backend_names_select_the_batched_verifier(tmp_path):
    """``tpu`` and ``jax`` (the reference's names) and ``cuda`` select the
    batched verifier, from the flag or from NARWHAL_CRYPTO_BACKEND, and
    the boot line names the requested one; another name fails at boot.
    Workers verify no signature, so each boots in seconds."""
    asks = {
        "flag-tpu": (["--crypto-backend", "tpu"], {}),
        "env-jax": ([], {"NARWHAL_CRYPTO_BACKEND": "jax"}),
        "flag-cuda": (["--crypto-backend", "cuda"], {}),
        "env-other": ([], {"NARWHAL_CRYPTO_BACKEND": "tensorflow"}),
    }
    booted = ["flag-tpu", "env-jax", "flag-cuda"]
    with _processes(tmp_path, 26500) as procs:
        for i, (name, (flags, env)) in enumerate(asks.items()):
            procs.start(name, chip_smoke.node_command(
                str(tmp_path), i, WORKER, *flags, "--device", "cpu"), env)
        missing = procs.wait_for({n: [chip_smoke.BOOTED] for n in booted}, 60)
        assert not missing, [procs.log(n)[-2000:] for n in missing]
        procs.procs["env-other"].wait(timeout=60)
        codes = procs.stop()
    assert [codes[n] for n in booted] == [0, 0, 0] and codes["env-other"] != 0, codes
    for name, requested in (("flag-tpu", "tpu"), ("env-jax", "jax"),
                            ("flag-cuda", "cuda")):
        assert f"Crypto backend: cuda (requested {requested})" in procs.log(name)
    other = procs.log("env-other")
    assert "unknown crypto backend 'tensorflow'" in other
    assert chip_smoke.BOOTED not in other
    # The CLI refuses a name outside its choices before anything boots.
    out = subprocess.run(
        chip_smoke.node_command(str(tmp_path), 0, WORKER, "--crypto-backend", "tensorflow"),
        capture_output=True, text=True, timeout=60, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 2 and "invalid choice" in out.stderr


def test_set_backend_from_env_maps_reference_names(monkeypatch):
    try:
        for name in ("tpu", "jax", "cuda"):
            assert tbackend.set_backend_from_env(name, device="cpu") == name
            assert tbackend.get_backend().name == "cuda"
            assert tbackend.get_backend().device.type == "cpu"
        monkeypatch.setenv("NARWHAL_CRYPTO_BACKEND", "jax")
        assert tbackend.set_backend_from_env(None, device="cpu") == "jax"
        assert tbackend.get_backend().name == "cuda"
        assert tbackend.set_backend_from_env("cpu") == "cpu"
        assert tbackend.get_backend().name == "cpu"
        # set_backend itself stays strict about its own names.
        for name in ("tpu", "jax", "tensorflow"):
            with pytest.raises(ValueError, match="unknown crypto backend"):
                tbackend.set_backend(name, device="cpu")
    finally:
        tbackend.set_backend("cpu")


def test_warmup_covers_every_pad_up_to_the_largest_burst(monkeypatch):
    """The verifier's warm-up runs once at each pad from 16 up to the
    first that holds ``max_claims`` (64 when it is not given), each as a
    warm-up launch; explicit ``shapes`` replace the ladder."""
    from narwhal_tpu_torch import ops
    from narwhal_tpu_torch.ops import ed25519 as E

    seen = []

    def fake(m, k, s, device):
        seen.append((len(m), ops._warming.on))

    monkeypatch.setattr(E, "verify_batch_arrays", fake)
    backend = E.CudaBackend(device="cpu")
    backend.warmup(max_claims=100)
    assert seen == [(16, True), (32, True), (64, True), (128, True)]
    seen.clear()
    backend.warmup()
    assert [n for n, _ in seen] == [16, 32, 64]
    seen.clear()
    backend.warmup(shapes=[16, 48])
    assert [n for n, _ in seen] == [16, 48]
    assert not getattr(ops._warming, "on", False)


def test_launches_reach_the_snapshot_with_warmups_apart():
    """A launch the wrappers count (``ops.check_launch``) also counts in
    the metrics registry, so a node's snapshot carries its process's
    launches; those made inside ``warming()`` count apart, as the boot's
    warm-ups, and only on the thread that warms."""
    import threading

    from narwhal_tpu_torch import metrics, ops

    name = "leader_commit_scan"
    live = metrics.counter(f"kernel.launches.{name}")
    warm = metrics.counter(f"kernel.warmup_launches.{name}")
    saved, start = dict(ops.LAUNCHES), (live.value, warm.value)
    try:
        ops.check_launch(name, 0)
        with ops.warming():
            ops.check_launch(name, 0)
            ops.check_launch(name, 0)
            other = threading.Thread(target=ops.check_launch, args=(name, 0))
            other.start()
            other.join()
        ops.check_launch(name, 0)
        assert ops.LAUNCHES[name] - saved[name] == 5
        assert (live.value - start[0], warm.value - start[1]) == (3, 2)
        snap = metrics.registry().snapshot()["counters"]
        assert snap[f"kernel.launches.{name}"] == live.value
        with pytest.raises(RuntimeError, match="cudaError 2"):
            ops.check_launch(name, 2)
        assert ops.LAUNCHES[name] - saved[name] == 5
    finally:
        ops.LAUNCHES.update(saved)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card refusals cannot be shown")


def test_primary_without_card_fails_at_boot(no_card, tmp_path):
    """No fallback hides the card: without ``--device cpu`` a primary
    asked for the cuda verifier or the consensus kernel exits non-zero
    before it boots."""
    with _processes(tmp_path, 26600) as procs:
        procs.start("cuda", chip_smoke.node_command(
            str(tmp_path), 0, "primary", "--crypto-backend", "cuda"))
        procs.start("kernel", chip_smoke.node_command(
            str(tmp_path), 1, "primary", "--experimental-consensus-kernel"))
        codes = {name: p.wait(timeout=60) for name, p in procs.procs.items()}
    assert codes["cuda"] != 0 and codes["kernel"] != 0, codes
    for name in ("cuda", "kernel"):
        log = procs.log(name)
        assert "no CUDA device" in log and chip_smoke.BOOTED not in log, log[-2000:]


def test_verify_launch_timing_check_wants_every_launch_timed():
    """The node phase holds each primary's verify launches to its
    CUDA-event timings: equal, and never fewer timings than bursts."""
    ok = chip_smoke.verify_launches_timed
    assert ok(900, 900, 899) and ok(876, 876, 876)
    assert not ok(877, 876, 876) and not ok(876, 877, 876)
    assert not ok(876, 876, 877)
