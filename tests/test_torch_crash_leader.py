"""Tusk over a DAG with a crashed validator, and the commit rule's leader
counters (``consensus.leaders_committed``, ``consensus.leaders_skipped``).

The validator whose key sorts first authors nothing, as in the
benchmark's ``committee10-crash1`` cell (``portbench/run.py::crashed``),
so every n-th even round has no leader.  The port's ``Consensus`` runs
the certificates on the plain ``Tusk`` and on ``KernelTusk`` (its plain
twins on the CPU); both must commit exactly the order of the
benchmark's own oracle (``portbench/reference/tusk.py``), and the skipped
counter must gain exactly the leader rounds that order passes over.
"""

import asyncio
import hashlib
import json
import os
import random

import pytest

from narwhal_tpu_torch import metrics
from narwhal_tpu_torch.config import (
    Authority,
    Committee,
    PrimaryAddresses,
    WorkerAddresses,
)
from narwhal_tpu_torch.consensus.tusk import Consensus, Tusk, leader_tally
from narwhal_tpu_torch.crypto import Digest, PublicKey
from narwhal_tpu_torch.primary.messages import Certificate, Header, genesis
from portbench import layers
from portbench import run as harness
from portbench.reference import tusk as oracle
from portbench.reference import wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GC_DEPTH = 50
SKIPPED = "consensus.leaders_skipped"
COMMITTED = "consensus.leaders_committed"


def _committee(keys):
    addr = PrimaryAddresses(primary_to_primary="127.0.0.1:0",
                            worker_to_primary="127.0.0.1:0")
    worker = WorkerAddresses(transactions="127.0.0.1:0",
                             worker_to_worker="127.0.0.1:0",
                             primary_to_worker="127.0.0.1:0")
    return Committee({PublicKey(k): Authority(stake=1, primary=addr,
                                              workers={0: worker})
                      for k in keys})


def _keys(n, salt):
    return [PublicKey(hashlib.sha256(f"{salt}-{i}".encode()).digest())
            for i in range(n)]


def _cert(author, round_, parents, payload):
    header = Header(author=author, round=round_, payload=payload,
                    parents=set(parents))
    header.id = header.compute_digest()
    return Certificate(header=header)


def _dag(committee, rng, rounds, dead=(), unlinked=()):
    """Certificates of ``rounds`` rounds in delivery order: every
    authority but the ``dead`` certifies each round, citing a random 2f+1
    or more of the round below, in a random order within the round.  The
    leaders of the ``unlinked`` rounds are cited by no certificate of the
    next round."""
    names = sorted(committee.authorities)
    n, quorum = len(names), committee.quorum_threshold()
    live = [k for k in names if k not in dead]
    below = {c.origin: c.digest() for c in genesis(committee)}
    out = []
    for r in range(1, rounds + 1):
        cited = dict(below)
        if r - 1 in unlinked:
            cited.pop(names[(r - 1) % n], None)
        row = {}
        for a in live:
            parents = rng.sample(sorted(cited.values()),
                                 rng.randint(quorum, len(cited)))
            payload = {Digest(hashlib.sha256(bytes(a) + bytes([r])).digest()): 0}
            cert = _cert(a, r, parents, payload)
            row[a] = cert
        out += rng.sample(list(row.values()), len(row))
        below = {a: c.digest() for a, c in row.items()}
    return out


def _as_wire(cert):
    h = cert.header
    return wire.Cert(bytes(h.author), h.round,
                     {bytes(d): w for d, w in h.payload.items()},
                     [bytes(p) for p in h.parents], bytes(h.id), bytes(64))


def _reference(committee, certs):
    """The oracle's commit order and the leader rounds its chains hold."""
    keys = sorted(bytes(k) for k in committee.authorities)
    tusk = oracle.Tusk(keys, wire.genesis(keys), GC_DEPTH)
    chains = []
    walk = tusk._order_leaders
    tusk._order_leaders = lambda leader: chains.append(walk(leader)) or chains[-1]
    order = []
    for c in certs:
        w = _as_wire(c)
        assert w.digest() == bytes(c.digest())
        order += [(x.round, x.header_id) for x in tusk.process(w)]
    return order, sorted({x.round for chain in chains for x in chain})


def _passed_over(committee, leader_rounds):
    """{even round: its leader} for each round up to the last committed
    leader that the chains do not hold."""
    names = sorted(committee.authorities)
    top = max(leader_rounds, default=0)
    return {r: names[r % len(names)] for r in range(2, top, 2)
            if r not in leader_rounds}


def _consensus(committee, certs, use_kernel, commit_rule="classic"):
    """(commit order, leaders committed, leaders skipped, last committed
    round) of the port's Consensus fed ``certs``, the counters read as
    their gain."""

    async def main():
        rx, to_primary, out = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()
        consensus = Consensus(committee, GC_DEPTH, rx, to_primary, out,
                              use_kernel=use_kernel, commit_rule=commit_rule,
                              device="cpu" if use_kernel else None)
        counters = metrics.registry().counters
        before = {k: counters[k].value for k in (COMMITTED, SKIPPED)}
        for c in certs:
            rx.put_nowait(c)
        task = asyncio.create_task(consensus.run())
        while not rx.empty():
            await asyncio.sleep(0)
        for _ in range(3):
            await asyncio.sleep(0)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        order = []
        while not out.empty():
            c = out.get_nowait()
            order.append((c.round, bytes(c.header.id)))
        if use_kernel:
            # The chain came from the window scan, not the Python walk.
            assert type(consensus.tusk).__name__ == "KernelTusk"
            assert consensus.tusk.python_fallbacks == 0
        return (order, counters[COMMITTED].value - before[COMMITTED],
                counters[SKIPPED].value - before[SKIPPED],
                consensus.tusk.state.last_committed_round)

    return asyncio.run(main())


def _check(committee, certs, use_kernel):
    """Holds the port to the oracle; returns the rounds passed over."""
    want, leader_rounds = _reference(committee, certs)
    order, committed, skipped, _ = _consensus(committee, certs, use_kernel)
    assert want, "the DAG committed nothing"
    assert order == want
    assert committed == len(leader_rounds)
    passed = _passed_over(committee, leader_rounds)
    assert skipped == len(passed)
    return passed


@pytest.mark.parametrize("use_kernel", [False, True], ids=["tusk", "kernel"])
@pytest.mark.parametrize("n,seed", [(10, 1), (10, 2), (10, 3), (4, 1), (4, 2)])
def test_crashed_leader_is_passed_over_and_counted(n, seed, use_kernel):
    committee = _committee(_keys(n, f"crash{n}"))
    dead = sorted(committee.authorities)[0]
    rounds = 41 if n == 10 else 23
    certs = _dag(committee, random.Random(seed), rounds, dead={dead})
    passed = _check(committee, certs, use_kernel)
    # Every round passed over is the dead authority's, and each of its
    # rounds below the last committed leader is passed over.
    assert set(passed.values()) == {dead}
    assert sorted(passed) == list(range(n, max(passed) + 1, n))
    assert len(passed) >= (3 if n == 10 else 4)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["tusk", "kernel"])
@pytest.mark.parametrize("seed", [1, 2])
def test_every_validator_up_skips_no_leader(seed, use_kernel):
    committee = _committee(_keys(10, "up"))
    certs = _dag(committee, random.Random(seed), 31)
    assert _check(committee, certs, use_kernel) == {}


@pytest.mark.parametrize("use_kernel", [False, True], ids=["tusk", "kernel"])
def test_unlinked_leader_is_counted_as_skipped(use_kernel):
    committee = _committee(_keys(10, "up"))
    certs = _dag(committee, random.Random(7), 31, unlinked={6, 14})
    passed = _check(committee, certs, use_kernel)
    names = sorted(committee.authorities)
    assert passed == {6: names[6], 14: names[4]}


@pytest.mark.parametrize("rule", ["classic", "lowdepth", "multileader"])
def test_every_rule_counts_each_leader_round_once(rule):
    # Each even round up to the last commit either has a leader in a
    # committed chain or is passed over, under every commit rule.
    committee = _committee(_keys(10, "crash10"))
    dead = sorted(committee.authorities)[0]
    certs = _dag(committee, random.Random(1), 41, dead={dead})
    order, committed, skipped, last = _consensus(committee, certs, False, rule)
    assert order and last >= 30
    assert committed + skipped == last // 2
    if rule != "multileader":  # (a backup slot can anchor a dead slot's round)
        assert skipped >= 3


def test_leader_tally_counts_even_rounds_strictly_between():
    committee = _committee(_keys(4, "tally"))
    a, b, c = sorted(committee.authorities)[:3]
    chain = [_cert(a, 12, (), {}), _cert(b, 8, (), {}), _cert(c, 4, (), {})]
    # Rounds 2, 6 and 10 lie between 0 and the anchor at 12, not in the
    # chain; the anchor itself is never counted.
    assert leader_tally(0, chain) == (3, 3)
    assert leader_tally(4, chain[:2]) == (2, 2)
    assert leader_tally(10, chain[:1]) == (1, 0)


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_crash_configuration_is_committee10_with_one_fault():
    steady, crash = _config("committee10"), _config("committee10-f1")
    changed = {"name", "source", "source_detail", "faults",
               "source_rate_tx_s", "reduced", "assumed"}
    assert set(steady) == set(crash)
    assert {k for k in steady if steady[k] != crash[k]} == changed
    assert crash["faults"] == 1 and crash["key_salt"] == "committee10"
    assert set(crash["reduced"]) == {"rate_tx_s"}
    assert set(crash["assumed"]) == set(steady["assumed"]) | {"crashed"}
    assert all(crash["assumed"][k] == v for k, v in steady["assumed"].items())
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == "committee10-f1")
    assert entry["reduced"] == ["rate_tx_s"]
    assert entry["source"] == crash["source"]
    assert entry["source"] not in {c["source"] for c in bench["configs"]
                                   if c["name"] != "committee10-f1"}
    cell = next(w for w in bench["workloads"] if w["name"] == "committee10-crash1")
    assert (cell["config"], cell["chips"]) == ("committee10-f1", 1)


def test_crashed_authority_leads_every_tenth_round():
    keys = harness.public_keys(_config("committee10-f1"))
    (dead,) = harness.crashed(keys, 1)
    tusk = Tusk(_committee(keys), GC_DEPTH)
    leads = [r for r in range(0, 60, 2) if tusk._leader_name(r) == keys[dead]]
    assert leads == [0, 10, 20, 30, 40, 50]


def test_skipped_reader_takes_the_largest_gain_and_none_without_the_counter():
    read = layers.reader(os.path.join(ROOT, "portbench", "metrics"), SKIPPED)

    def snap(**counters):
        return {"counters": counters}

    obs = layers.Observations(window=(0.0, 20.0))
    obs.snapshots = {
        "primary-0": (snap(**{SKIPPED: 3}), snap(**{SKIPPED: 12})),
        "primary-2": (snap(**{SKIPPED: 2}), snap(**{SKIPPED: 12})),
        "worker-0": (snap(), snap()),
    }
    assert read(obs) == 10.0
    # A program without the counter (the parent of this change) gives
    # nothing to read, and the harness leaves the metric out.
    obs.snapshots = {"primary-0": (snap(), snap(**{COMMITTED: 5}))}
    assert read(obs) is None
