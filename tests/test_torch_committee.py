"""The port's slice as a whole, on the CPU: committees of primaries on
loopback TCP that commit.

(a) Four port primaries (``chip_smoke.PortNode``, booted by the port's
``spawn_primary_node``), each verifying on the port's ``cpu`` crypto
backend and committing through
``Consensus(use_kernel=True, device="cpu")``, commit at least 5 leaders
each.  Every node commits the same prefix; each node's sequence is what
the port's plain ``Tusk`` commits from the certificates in the order that
node's Consensus took them, and what the reference's
``Tusk.process_certificate`` commits from the same certificates decoded
from their wire bytes by ``narwhal_tpu.primary.messages``.

(b) A mixed committee: primaries 0–1 from ``narwhal_tpu`` (its own
``spawn_primary_node`` and Consensus), 2–3 from the port.  All four
commit one sequence on their common prefix.

(c) ``chip_smoke.py``'s checks of the kernels at the committee phase's
shapes (the verifier at its burst pads, the commit scan and the ring
update at its window) agree on the CPU, where each wrapper runs its
plain version, and count mismatches for a kernel that answers wrongly.

Each committee runs under its own ``asyncio.wait_for`` limit of 60 s, on
ports 26000–26039, which no other test binds."""

import asyncio
import random

import torch

import narwhal_tpu.messages as jmessages
import narwhal_tpu.primary.messages as jpm
import narwhal_tpu_torch.primary.messages as tpm
from narwhal_tpu.config import Committee as JCommittee
from narwhal_tpu.config import Parameters as JParameters
from narwhal_tpu.consensus import Tusk as JTusk
from narwhal_tpu.crypto import KeyPair as JKeyPair
from narwhal_tpu_torch.config import Parameters as TParameters
from narwhal_tpu_torch.crypto import backend as tbackend
from narwhal_tpu_torch.ops import ed25519 as E
from narwhal_tpu_torch.ops import reachability as R

import chip_smoke
from tests.test_torch_tasks import package_state

LEADERS = 5
LIMIT_S = 60.0


def test_port_committee_commits_what_both_tusks_commit():
    keys, committee = chip_smoke.loopback_committee(4, 26000, salt=7)
    parameters = TParameters()
    jc = JCommittee.from_json(committee.to_json())
    with package_state(), chip_smoke.TaskDeaths() as deaths:
        tbackend.set_backend("cpu")
        nodes, _, _ = asyncio.run(asyncio.wait_for(chip_smoke.run_committee(
            keys, committee, parameters, LEADERS, LIMIT_S, device="cpu"), LIMIT_S))
        assert all(type(n.consensus.tusk).__name__ == "KernelTusk" for n in nodes)
        assert min(n.leaders for n in nodes) >= LEADERS
        checks = chip_smoke.committee_checks(nodes, committee, parameters.gc_depth)
        assert checks["prefix_agrees"] and checks["replay_equal"]
        # The reference's Tusk, fed each node's certificates from their
        # wire bytes, commits that node's sequence.
        jmessages.set_wire_committee(jc)
        for node in nodes:
            tusk = JTusk(jc, parameters.gc_depth)
            want = [bytes(c.digest()) for cert in node.received
                    for c in tusk.process_certificate(jpm.decode_primary_message(
                        tpm.encode_primary_message(cert))[1])]
            got = [bytes(c.digest()) for c in node.committed]
            assert got and want[:len(got)] == got
    assert deaths.records == []


def _leaders(seq, names):
    """Committed leaders in a sequence of certificates (round-robin over
    the sorted authority names, even rounds)."""
    return sum(1 for c in seq if c.round % 2 == 0
               and bytes(c.origin) == names[c.round % len(names)])


async def _mixed(keys, committee, seeds):
    from narwhal_tpu.node.node import spawn_primary_node

    jc = JCommittee.from_json(committee.to_json())
    names = sorted(bytes(n) for n in committee.authorities)
    jparams, tparams = JParameters(), TParameters()
    ref_nodes, ref_seqs, port_nodes = [], [[], []], []
    try:
        for i in range(2):
            ref_nodes.append(await spawn_primary_node(
                JKeyPair.generate(seeds[i]), jc, jparams,
                on_commit=ref_seqs[i].append))
        for kp in keys[2:]:
            port_nodes.append(await chip_smoke.PortNode.boot(
                kp, committee, tparams, device="cpu"))
        seqs = lambda: ref_seqs + [n.committed for n in port_nodes]  # noqa: E731
        while min(_leaders(s, names) for s in seqs()) < LEADERS:
            await asyncio.sleep(0.02)
        origins = {bytes(c.origin) for n in port_nodes for c in n.received}
        return [[bytes(c.digest()) for c in s] for s in seqs()], origins
    finally:
        for node in port_nodes + ref_nodes:
            await node.shutdown()


def test_mixed_committee_commits_one_sequence():
    keys, committee = chip_smoke.loopback_committee(4, 26020, salt=8)
    seeds = [chip_smoke.key_seed(8, i) for i in range(4)]
    assert [JKeyPair.generate(s).name for s in seeds] == [
        bytes(kp.name) for kp in keys]
    with package_state(), chip_smoke.TaskDeaths() as deaths:
        tbackend.set_backend("cpu")
        seqs, origins = asyncio.run(asyncio.wait_for(
            _mixed(keys, committee, seeds), LIMIT_S))
    assert deaths.records == []
    # The port's Consensus took certificates of both packages' authors.
    assert origins == {bytes(kp.name) for kp in keys}
    assert all(seqs)
    for i in range(4):
        for j in range(i + 1, 4):
            k = min(len(seqs[i]), len(seqs[j]))
            assert seqs[i][:k] == seqs[j][:k], (i, j)


def test_committee_pad_checks_hold_the_verifier(monkeypatch):
    keys, committee = chip_smoke.make_committee(4)
    dag = chip_smoke.signed_rounds(keys, committee, 3, random.Random(1))
    claims = sum(1 + len(c.votes) for certs in dag for c in certs)
    rows, kind = chip_smoke.verify_rows(dag, keys, claims + 8, random.Random(2))
    args = E.to_device(E.prepare_batch(*zip(*rows), E.pad_size(len(rows))), "cpu")
    verdict = E.verify_plain(*args).numpy()[:len(rows)]
    (pad,) = chip_smoke.committee_pad_checks(rows, kind, verdict, "cpu", [16])
    assert (pad["pad"], pad["claims"], pad["hostile"]) == (16, 13, 6)
    assert pad["corrupted"] > 0 and pad["mismatches"] == 0
    # A verifier that accepts every row disagrees at the pad.
    monkeypatch.setattr(E, "verify_kernel", lambda *a: torch.ones(
        a[0].shape[0], dtype=torch.bool))
    (pad,) = chip_smoke.committee_pad_checks(rows, kind, verdict, "cpu", [16])
    assert pad["mismatches"] > 0


def test_committee_window_checks_hold_scan_and_update(monkeypatch):
    _, committee = chip_smoke.loopback_committee(
        chip_smoke.COMMITTEE_N, chip_smoke.COMMITTEE_BASE_PORT, 1)
    assert chip_smoke.committee_pads(committee) == [16, 32, 64, 128, 256, 512, 1024]
    shapes = chip_smoke.committee_window_checks(committee, "cpu")
    update, scan = shapes["window_update"], shapes["leader_commit_scan"]
    assert (update["window"], update["committee"], update["rows"]) == (64, 10, 64)
    assert update["mismatches"] == 0 and scan["mismatches"] == 0
    assert scan["committed"] > 0
    # An update that changes nothing and a scan that answers the
    # complement both disagree at the committee's shape.
    plain = R.leader_commit_scan_plain
    monkeypatch.setattr(R, "window_update", lambda *a, **k: None)
    monkeypatch.setattr(R, "leader_commit_scan", lambda *a: ~plain(*a))
    shapes = chip_smoke.committee_window_checks(committee, "cpu")
    assert shapes["window_update"]["mismatches"] > 0
    assert shapes["leader_commit_scan"]["mismatches"] > 0
