"""The port's Byzantine planes (``faults/byzantine.py``,
``faults/byzantine_worker.py``, ``faults/fuzz.py``) on the CPU.

- Mixed committees: a port Byzantine primary among reference honest
  primaries, and a reference Byzantine primary among port honest
  primaries (``KernelTusk`` on its plain twins), for the ``wrong_key``
  and ``equivocate`` behaviors: the honest side detects the other
  package's attack, its health rule fires, and it commits one sequence
  with clients' payload in it.
- A 4-authority committee through the port's node CLI (``--device cpu``)
  under a published fault plan, run and judged by ``chip_smoke.py``'s
  faults phase code: ``--fault-plan`` (``wrong_key``) detected while the
  committee commits, and a SIGKILL and restart over the same store, each
  honest audit segment replayed by the port's golden oracle.
- Then the cases of ``tests/test_byzantine.py``,
  ``tests/test_worker_faults.py`` and the Byzantine plan's cases of
  ``tests/test_faults.py`` run again on the port.

Port blocks: the mirrored cases 22000–22239 and 25900–25959, the mixed
committees 26700–26779, the CLI committees 26800–26839; no other test
binds them."""

import asyncio

import pytest

import chip_smoke
import narwhal_tpu.config as jconfig
import narwhal_tpu.crypto as jcrypto
import narwhal_tpu.faults.byzantine as jbyzantine
import narwhal_tpu.metrics as jmetrics
import narwhal_tpu.node as jnode
import narwhal_tpu_torch.config as tconfig
import narwhal_tpu_torch.crypto as tcrypto
import narwhal_tpu_torch.faults.byzantine as tbyzantine
import narwhal_tpu_torch.metrics as tmetrics
import narwhal_tpu_torch.node as tnode
from narwhal_tpu_torch.crypto import backend as tbackend
from narwhal_tpu_torch.crypto import digest32
from narwhal_tpu_torch.messages import encode_batch
from narwhal_tpu_torch.network.framing import parse_address, write_frame

from tests.common import committee, keys
from tests.test_torch_faults_spec import PLAN_CASES
from tests.test_torch_tasks import mirror, package_state

MIRRORED_BYZANTINE = mirror(globals(), "test_byzantine")
MIRRORED_WORKER = mirror(globals(), "test_worker_faults")
MIRRORED_PLAN = mirror(globals(), "test_faults", only=PLAN_CASES)


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED_BYZANTINE) == 2
    assert len(MIRRORED_WORKER) == 17
    assert len(MIRRORED_PLAN) == 2


# -- mixed committees ---------------------------------------------------------

PACKAGES = {
    "jax": (jconfig, jcrypto, jbyzantine, jmetrics, jnode),
    "torch": (tconfig, tcrypto, tbyzantine, tmetrics, tnode),
}
_PARAMS = dict(header_size=32, max_header_delay=100, batch_size=400,
               max_batch_delay=100)
DETECTION = {"wrong_key": ("primary.invalid_signatures", "invalid_signature",
                           "faults.byzantine.wrong_key_headers"),
             "equivocate": ("primary.equivocations_detected", "equivocation",
                            "faults.byzantine.twins_minted")}


def _tx(i: int) -> bytes:
    return bytes([1]) + (0xFB0000 + i).to_bytes(8, "little") + bytes(91)


async def _mixed_byzantine(base_port: int, honest: str, byzantine: str, behavior: str):
    """Authorities 0–2 from package ``honest``, authority 3 from package
    ``byzantine`` running ``behavior``; payload sent to authority 0's
    worker before and after the detection.  Returns the honest commit
    sequences (digests) and the two registries' counts."""
    counter, rule, attack = DETECTION[behavior]
    c = committee(base_port=base_port)
    regs = {pkg: PACKAGES[pkg][3].registry() for pkg in (honest, byzantine)}
    for reg in regs.values():
        reg.reset()
    commits = [[] for _ in range(4)]
    nodes = []
    try:
        for i in range(4):
            pkg = byzantine if i == 3 else honest
            config, crypto, byz, _, node = PACKAGES[pkg]
            kp = crypto.KeyPair.generate(bytes([i]) * 32)
            cm = config.Committee.from_json(c.to_json())
            params = config.Parameters(**_PARAMS)
            kwargs = {"use_kernel": True, "device": "cpu"} if pkg == "torch" and i < 3 else {}
            nodes.append(await node.spawn_primary_node(
                kp, cm, params, on_commit=commits[i].append,
                fault_plan=byz.ByzantinePlan([behavior], seed=5) if i == 3 else None,
                **kwargs))
            nodes.append(await node.spawn_worker_node(kp, 0, cm, params))
        monitor = PACKAGES[honest][3].HealthMonitor(
            regs[honest], rules=PACKAGES[honest][3].default_rules({}), interval_s=0.5)
        host, port = parse_address(c.worker(keys()[0].name, 0).transactions)

        async def send(ids):
            _, w = await asyncio.open_connection(host, port)
            txs = [_tx(k) for k in ids]
            for tx in txs:
                await write_frame(w, tx)
            w.close()
            return bytes(digest32(encode_batch(txs)))

        async def committed(digest, timeout_s=50.0):
            end = asyncio.get_running_loop().time() + timeout_s
            while not all(digest in {bytes(d) for cert in commits[i]
                                     for d in cert.header.payload} for i in range(3)):
                assert asyncio.get_running_loop().time() < end, (
                    "payload never committed on every honest primary; commits "
                    f"{[len(s) for s in commits]}, last rounds "
                    f"{[s[-1].round if s else None for s in commits]}")
                await asyncio.sleep(0.05)

        await committed(await send(range(4)))
        while not regs[honest].counters.get(counter) or not regs[honest].counters[counter].value:
            await asyncio.sleep(0.05)
        fired = {f["rule"] for f in monitor.evaluate()}
        await committed(await send(range(100, 104)))
        counts = {"detected": regs[honest].counters[counter].value,
                  "attacks": regs[byzantine].counters[attack].value}
        return [[bytes(cert.digest()) for cert in s] for s in commits[:3]], fired, counts
    finally:
        for n in nodes:
            await n.shutdown()


MIXED = [(honest, byzantine, behavior)
         for honest, byzantine in (("jax", "torch"), ("torch", "jax"))
         for behavior in ("wrong_key", "equivocate")]


@pytest.mark.parametrize("honest,byzantine,behavior", MIXED,
                         ids=["-".join(m) for m in MIXED])
def test_mixed_committee_detects_the_other_package_attack(honest, byzantine, behavior):
    base_port = 26700 + 20 * MIXED.index((honest, byzantine, behavior))
    with package_state():
        tbackend.set_backend("cpu")
        seqs, fired, counts = asyncio.run(asyncio.wait_for(
            _mixed_byzantine(base_port, honest, byzantine, behavior), 120))
    assert counts["detected"] > 0 and counts["attacks"] > 0, counts
    assert DETECTION[behavior][1] in fired, fired
    for i in range(3):
        for j in range(i + 1, 3):
            k = min(len(seqs[i]), len(seqs[j]))
            assert k > 0 and seqs[i][:k] == seqs[j][:k], (i, j)


# -- the node CLI under a fault plan ------------------------------------------

CLI = {
    # A published Byzantine plan: authority 2 signs with a wrong key.
    "wrong_key": dict(byzantine=("byz_wrong_key",), crashed=None, load_s=10.0),
    # crash_restart.json's SIGKILL at 12 s and restart at 18 s (authority 1).
    "crash_restart": dict(byzantine=(), crashed=1, load_s=24.0),
}


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_committee_under_a_fault_plan_is_judged_safe(tmp_path, name):
    """4 primaries (``--experimental-consensus-kernel --device cpu``), 4
    workers and 4 clients through the port's node CLI, run and judged by
    ``chip_smoke.py``'s faults phase code: every honest audit segment
    replays cleanly through the port's golden oracle, the honest commits
    form one prefix, and the plan's rules fire."""
    args = CLI[name]
    spec = chip_smoke.faults_scenario(n=4, rate=50, **args)
    run = chip_smoke.run_node_committee(
        str(tmp_path), 4, 26800 + 20 * sorted(CLI).index(name), 50, args["load_s"],
        primary_flags=("--experimental-consensus-kernel", "--device", "cpu"),
        primary_boot=("Consensus kernel ready", chip_smoke.BOOTED), scenario=spec)
    checks = chip_smoke.fault_checks(run, min_leaders=2)
    assert checks["detection"]["expected"] == spec["expect"]["rules"]
    honest = [i for i in range(4) if i not in run["byzantine"]]
    assert sorted(checks["safety"]["nodes"]) == [f"primary-{i}" for i in honest]
    for i in honest:
        snap = run["snapshots"][run["lives"][i][-1]]
        assert snap["counters"]["consensus.kernel.dispatches"] > 0
    if name == "wrong_key":
        attacker = run["snapshots"]["primary-2"]["counters"]
        assert attacker["faults.byzantine.wrong_key_headers"] > 0
        assert all(run["snapshots"][f"primary-{i}"]["counters"]["primary.invalid_signatures"] > 0
                   for i in honest)
        assert "FAULT INJECTION ACTIVE" in run["logs"]["primary-2"]
    else:
        assert run["lives"][1] == ["primary-1", "primary-1.r1"]
        assert checks["safety"]["nodes"]["primary-1"]["segments"] == 2
        assert chip_smoke.RESTORED.search(run["logs"]["primary-1.r1"])
        # The second life committed past its store's head at the crash.
        ((head, last),) = checks["liveness"]["rejoined_rounds"].values()
        assert head == chip_smoke.store_head(
            str(tmp_path / "crash-primary-1.store.log"), run["committee"]) > 0
        assert last > head and checks["liveness"]["payload_commits_after_settle"][1]
        # The same run fails when the second life's commits stay at or
        # below that head.
        with pytest.raises(AssertionError, match="store's head at the crash"):
            chip_smoke.fault_checks(
                dict(run, rejoined_rounds={1: (last, last)}), min_leaders=2)
    # The same run fails when a rule it expects never fired.
    with pytest.raises(AssertionError, match="never fired"):
        chip_smoke.fault_checks(
            dict(run, scenario=dict(spec, expect={"rules": ["equivocation"]})),
            min_leaders=2)


def test_joined_sequence_takes_a_restart_that_commits_again():
    replay = [(r, f"h{r}") for r in range(10)]
    assert chip_smoke.joined_sequence([replay[:4], replay[3:7]], replay) == replay[:7]
    assert chip_smoke.joined_sequence([replay[:4], replay[4:9]], replay) == replay[:9]
    with pytest.raises(AssertionError, match="first life"):
        chip_smoke.joined_sequence([replay[1:4]], replay)
    with pytest.raises(AssertionError, match="restarted life"):
        chip_smoke.joined_sequence([replay[:4], replay[5:8]], replay)
    with pytest.raises(AssertionError, match="restarted life"):
        chip_smoke.joined_sequence([replay[:4], []], replay)


def test_restart_payload_commits_count_only_past_the_store_head():
    """A restarted life's commits of rounds its store already held (its
    replay at boot) are no sign that it rejoined the committee: only
    payload commits past that head, and after the settle point, count."""
    line = "2026-01-01T00:00:{:02d}.000Z INFO narwhal.consensus Committed B{}(h{}){}\n".format
    at = chip_smoke._log_local_time(line(10, 0, 0, ""))
    replayed = line(20, 35, 3, " -> d") + line(21, 48, 4, " -> d")
    assert chip_smoke.payload_commits_after(replayed, at) == 2
    assert chip_smoke.payload_commits_after(replayed, at, above=48) == 0
    rejoined = replayed + line(30, 52, 5, " -> d") + line(31, 53, 6, "")
    assert chip_smoke.payload_commits_after(rejoined, at, above=48) == 1
    early = line(5, 60, 7, " -> d")
    assert chip_smoke.payload_commits_after(early, at, above=48) == 0
