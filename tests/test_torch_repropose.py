"""A primary re-proposes the batches of its own headers that Tusk can no
longer commit (``Proposer.own_committed``, told by the
``GarbageCollector`` of each of the primary's certificates committed).

- A lockstep committee of four: each authority's own ``Proposer`` (its
  run loop, sealing a header at two digests) and ``GarbageCollector``,
  and a plain ``Tusk`` per primary whose commits go back through the
  collector's queue.  The test forms each certificate from 2f+1 votes
  and chooses what the next round's headers cite.  One primary's round-5
  certificate is held back until every round-6 header is minted (cited
  by none: orphaned), or never forms (its header never certified): its
  batches come back in a later header of the same primary, every primary
  commits each batch exactly once, and each primary's order equals the
  benchmark judge's Tusk (``portbench/reference/tusk.py``) over the
  certificates in the order it took them.  With no header lost, the
  counter reads 0 and every header is byte for byte what the reference
  package's proposer mints from the same inputs.
- The proposer and collector alone: a payload goes back once, and an own
  certificate committed earlier in the same sequence is not re-proposed.
- The simulated committee (``sim/``) at the sources' setting,
  ``header_linger`` 0, one primary cut off for half a second: every
  certified batch commits exactly once.  The mechanism acts only once a
  later certificate of the same primary commits; a primary that falls
  into a standing lag behind the others' quorum (none of its later
  certificates cited, as on run seed 6) keeps losing its batches, and
  those are told apart from the rest by that rule.
"""

import asyncio
import collections
import hashlib

import pytest

import narwhal_tpu.messages as jmessages
import narwhal_tpu.primary.messages as jpm
from narwhal_tpu.config import Committee as JCommittee
from narwhal_tpu.crypto import Digest as JDigest
from narwhal_tpu.crypto import KeyPair as JKeyPair
from narwhal_tpu.crypto import SignatureService as JSignatureService
from narwhal_tpu.primary.proposer import Proposer as JProposer
from narwhal_tpu_torch import metrics
from narwhal_tpu_torch.consensus.replay import TAG_COMMIT, TAG_INSERT, read_audit
from narwhal_tpu_torch.consensus.tusk import Tusk
from narwhal_tpu_torch.crypto import Digest, KeyPair, SignatureService
from narwhal_tpu_torch.faults.spec import parse_scenario
from narwhal_tpu_torch.messages import set_wire_committee
from narwhal_tpu_torch.primary.core import AtomicRound
from narwhal_tpu_torch.primary.garbage_collector import GarbageCollector
from narwhal_tpu_torch.primary.messages import (
    Certificate,
    Vote,
    encode_primary_message,
    genesis,
)
from narwhal_tpu_torch.primary.proposer import Proposer
from narwhal_tpu_torch.sim.committee import (
    build_sim_committee,
    run_sim_scenario,
    sim_keypairs,
)
from portbench.reference import tusk as judge_tusk
from portbench.reference import wire

from tests.test_torch_tasks import package_state

N = 4
GC_DEPTH = 50
BATCHES = 2  # digests a round a primary; a header seals at two
ROUNDS = 20
REPROPOSED = "primary.proposer.reproposed_batches"


class _Drop:
    """The collector's Cleanup messages go nowhere."""

    def send(self, *args, **kwargs) -> None:
        pass


def _digest(*parts) -> bytes:
    return hashlib.sha256(repr(parts).encode()).digest()


async def _settle() -> None:
    for _ in range(8):
        await asyncio.sleep(0)


class _Lockstep:
    """Four primaries' proposers and collectors, a Tusk each, driven a
    round at a time."""

    def __init__(self) -> None:
        self.seeds = [bytes([i + 1]) * 32 for i in range(N)]
        self.keypairs = [KeyPair.generate(s) for s in self.seeds]
        self.names = [kp.name for kp in self.keypairs]
        self.committee = build_sim_committee(self.keypairs, 1)
        set_wire_committee(self.committee)
        self.services = [SignatureService(kp) for kp in self.keypairs]
        self.proposers, self.feedback, self.tasks = [], [], []
        self.tusks = [Tusk(self.committee, GC_DEPTH) for _ in range(N)]
        self.headers = [[] for _ in range(N)]
        self.inputs = [[] for _ in range(N)]  # (parents, digests) a round
        self.arrivals = [[] for _ in range(N)]  # certificates, as taken
        self.sequences = [[] for _ in range(N)]  # certificates committed

    async def start(self) -> None:
        for i, kp in enumerate(self.keypairs):
            p = Proposer(kp.name, self.committee, self.services[i], 32 * BATCHES,
                         60_000, None, asyncio.Queue(), asyncio.Queue(),
                         gc_depth=GC_DEPTH)
            q = asyncio.Queue()
            gc = GarbageCollector(kp.name, self.committee, AtomicRound(), q, p)
            gc.sender = _Drop()
            self.proposers.append(p)
            self.feedback.append(q)
            self.tasks += [asyncio.ensure_future(p.run()),
                           asyncio.ensure_future(gc.run())]

    async def stop(self) -> None:
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        for s in self.services:
            s.close()

    async def mint(self, i: int, r: int, parents) -> object:
        p = self.proposers[i]
        if r > 1:
            p.deliver_parents([Digest(d) for d in parents], r - 1)
        digests = [(_digest(i, r, k), 0) for k in range(BATCHES)]
        for d, w in digests:
            p.rx_workers.put_nowait((Digest(d), w))
        header = await asyncio.wait_for(p.tx_core.get(), 10)
        self.inputs[i].append((list(parents), digests))
        self.headers[i].append(header)
        return header

    def certify(self, header) -> Certificate:
        votes = []
        for kp in self.keypairs[: 2 * N // 3 + 1]:
            vote = Vote(id=header.id, round=header.round, origin=header.author,
                        author=kp.name)
            votes.append((kp.name, kp.sign(vote.digest(), site="vote")))
        return Certificate(header=header, votes=votes)

    async def deliver(self, certificates) -> None:
        for j in range(N):
            # Each primary takes a round's certificates in its own order.
            for cert in certificates[j:] + certificates[:j]:
                self.arrivals[j].append(cert)
                for committed in self.tusks[j].process_certificate(cert):
                    self.sequences[j].append(committed)
                    self.feedback[j].put_nowait(committed)
        await _settle()

    async def run(self, hold=None, kind="orphaned") -> None:
        """``hold`` = (authority, round): that certificate is cited by no
        header; ``kind`` "orphaned" delivers it once every next-round
        header is minted, "uncertified" never forms it."""
        parents = [bytes(c.digest()) for c in genesis(self.committee)]
        late = None
        for r in range(1, ROUNDS + 1):
            headers = [await self.mint(i, r, parents) for i in range(N)]
            certs = [self.certify(h) for h in headers]
            if late is not None:
                await self.deliver([late])
                late = None
            if hold is not None and hold[1] == r:
                held = certs.pop(hold[0])
                late = held if kind == "orphaned" else None
            await self.deliver(certs)
            parents = [bytes(c.digest()) for c in certs]


def _run(lockstep: _Lockstep, **kw) -> None:
    async def main():
        await lockstep.start()
        try:
            await lockstep.run(**kw)
        finally:
            await lockstep.stop()

    asyncio.run(main())


def _judge_order(lockstep: _Lockstep, j: int):
    keys = sorted(bytes(n) for n in lockstep.names)
    certs = [wire.decode_certificate(bytes(c.serialize()), keys)
             for c in lockstep.arrivals[j]]
    return judge_tusk.commit_sequence(keys, wire.genesis(keys), certs, GC_DEPTH)


@pytest.mark.parametrize("kind", ["orphaned", "uncertified"])
def test_dead_header_batches_come_back_once_in_tusk_order(kind):
    x, r = 1, 5
    with package_state():
        metrics.registry().reset()
        metrics.flight().events.clear()
        ls = _Lockstep()
        _run(ls, hold=(x, r), kind=kind)
        held = [h for h in ls.headers[x] if h.round == r][0]
        lost = {bytes(d) for d in held.payload}
        assert len(lost) == BATCHES
        # The held batches come back in a later header of the same primary.
        again = [h for h in ls.headers[x]
                 if h.round > r and lost <= {bytes(d) for d in h.payload}]
        assert len(again) == 1
        # Every batch of a delivered certificate, those of the dead header
        # among them, committed exactly once by every primary (the last
        # rounds' have not had their leaders yet).
        settled = {bytes(d) for i in range(N) for h in ls.headers[i]
                   for d in h.payload if h.round <= ROUNDS - 6}
        for j in range(N):
            counts = collections.Counter(
                bytes(d) for c in ls.sequences[j] for d in c.header.payload)
            assert set(counts.values()) == {1}, j
            assert lost <= set(counts), j
            assert settled <= set(counts), j
            # The dead certificate itself never commits.
            assert held.id not in {c.header.id for c in ls.sequences[j]}
            assert _judge_order(ls, j) == [
                (c.round, bytes(c.header.id)) for c in ls.sequences[j]]
        assert metrics.registry().counters[REPROPOSED].value == BATCHES
        events = [e for e in metrics.flight().events if e["kind"] == "repropose"]
        assert [(e["round"], e["batches"]) for e in events] == [(r, BATCHES)]


async def _reference_headers(seed: bytes, committee, inputs):
    """What the reference package's proposer mints from the same inputs."""
    kp = JKeyPair.generate(seed)
    service = JSignatureService(kp)
    rx_workers, tx_core = asyncio.Queue(), asyncio.Queue()
    p = JProposer(kp.name, committee, service, 32 * BATCHES, 60_000, None,
                  rx_workers, tx_core)
    task = asyncio.ensure_future(p.run())
    out = []
    try:
        for r, (parents, digests) in enumerate(inputs, 1):
            if r > 1:
                p.deliver_parents([JDigest(d) for d in parents], r - 1)
            for d, w in digests:
                rx_workers.put_nowait((JDigest(d), w))
            out.append(jpm.encode_primary_message(
                await asyncio.wait_for(tx_core.get(), 10)))
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        service.close()
    return out


def test_no_dead_header_counts_zero_and_mints_the_reference_headers():
    with package_state():
        metrics.registry().reset()
        ls = _Lockstep()
        _run(ls)
        assert metrics.registry().counters[REPROPOSED].value == 0
        for j in range(N):
            assert len(ls.sequences[j]) > 10 * N
            assert _judge_order(ls, j) == [
                (c.round, bytes(c.header.id)) for c in ls.sequences[j]]
        jc = JCommittee.from_json(ls.committee.to_json())
        jmessages.set_wire_committee(jc)
        for i in range(N):
            want = asyncio.run(_reference_headers(ls.seeds[i], jc, ls.inputs[i]))
            got = [encode_primary_message(h) for h in ls.headers[i]]
            assert got == want and len(got) == ROUNDS, i


def _one_primary(gc_depth: int = GC_DEPTH):
    kp = KeyPair.generate(bytes([7]) * 32)
    committee = build_sim_committee([kp] + [KeyPair.generate(bytes([8 + i]) * 32)
                                            for i in range(N - 1)], 1)
    set_wire_committee(committee)
    service = SignatureService(kp)
    p = Proposer(kp.name, committee, service, 32 * BATCHES, 60_000, None,
                 asyncio.Queue(), asyncio.Queue(), gc_depth=gc_depth)
    q = asyncio.Queue()
    gc = GarbageCollector(kp.name, committee, AtomicRound(), q, p)
    gc.sender = _Drop()
    return p, q, gc, service


async def _mint(p, r: int) -> object:
    if r > 1:
        p.deliver_parents([Digest(_digest("parent", r, k)) for k in range(3)],
                          r - 1)
    for k in range(BATCHES):
        p.rx_workers.put_nowait((Digest(_digest("own", r, k)), 0))
    return await asyncio.wait_for(p.tx_core.get(), 10)


def test_payload_goes_back_once_and_not_for_one_committed_in_the_same_sequence():
    async def main():
        p, q, gc, service = _one_primary()
        tasks = [asyncio.ensure_future(p.run()), asyncio.ensure_future(gc.run())]
        counter = metrics.registry().counters[REPROPOSED]
        try:
            h = {r: await _mint(p, r) for r in range(1, 5)}
            commit = lambda *rs: [q.put_nowait(Certificate(header=h[r])) for r in rs]
            # Round 2 committed: round 1 is dead and goes back.
            commit(2)
            await _settle()
            assert counter.value == BATCHES
            assert {bytes(d) for d, _ in p.digests} == {bytes(d) for d in h[1].payload}
            # Rounds 3 and 4 in one sequence: 3 came back before 4.
            commit(3, 4)
            await _settle()
            assert counter.value == BATCHES
            # The dead payload rides round 5's header, which commits;
            # round 6's commit finds nothing more to send back.
            h[5] = await _mint(p, 5)
            assert set(h[1].payload) <= set(h[5].payload)
            h[6] = await _mint(p, 6)
            commit(5, 6)
            await _settle()
            assert counter.value == BATCHES
            # A later commit past a dead round-7 header sends only its own.
            h[7] = await _mint(p, 7)
            h[8] = await _mint(p, 8)
            commit(8)
            await _settle()
            assert counter.value == BATCHES + len(h[7].payload)
            assert {bytes(d) for d, _ in p.digests} >= {bytes(d) for d in h[7].payload}
            assert not set(h[1].payload) & {d for d, _ in p.digests}
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            service.close()

    with package_state():
        metrics.registry().reset()
        asyncio.run(main())


def test_remembered_payloads_stop_at_gc_depth():
    async def main():
        p, q, gc, service = _one_primary(gc_depth=3)
        task = asyncio.ensure_future(p.run())
        try:
            for r in range(1, 9):
                await _mint(p, r)
            assert sorted(p._proposed) == [5, 6, 7, 8]
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            service.close()

    with package_state():
        asyncio.run(main())


# -- the simulated committee at header_linger 0 --------------------------------

SIM_SPEC = {
    "name": "repropose_linger_off", "nodes": 4, "workers": 1, "rate": 600,
    "tx_size": 512, "duration": 12, "seed": 3,
    "parameters": {"header_linger": 0},
    "wan": {"latency_ms": 2, "jitter_ms": 2,
            "partitions": [{"group": [3], "from_s": 4, "until_s": 4.5}]},
}
JUDGED_BEFORE_END = 30  # rounds: a batch certified later may not commit yet


@pytest.mark.parametrize("run_seed", [1, 2, 3, 6])
def test_linger_off_committee_commits_every_certified_batch(tmp_path, run_seed):
    with package_state():
        scenario = parse_scenario(SIM_SPEC, env={})
        art = run_sim_scenario(scenario, run_seed, str(tmp_path))
        assert art["verdicts"]["safety"]["ok"], art["verdicts"]["safety"]
        reproposed = metrics.registry().counters[REPROPOSED].value
        keypairs = sim_keypairs(scenario)
        names = [kp.name for kp in keypairs]
        set_wire_committee(build_sim_committee(keypairs, 1))
        stranded = set()
        for i in range(N):
            records = read_audit(str(tmp_path / f"audit-primary-{i}.seg0.bin"))
            inserted = {bytes(c.digest()): c for c in (
                Certificate.deserialize(p) for t, p in records if t == TAG_INSERT)}
            committed = [inserted[p] for t, p in records if t == TAG_COMMIT]
            last = max(c.round for c in committed)
            counts = collections.Counter(
                bytes(d) for c in committed for d in c.header.payload)
            assert set(counts.values()) == {1}, i
            own_rounds = collections.defaultdict(list)
            for c in committed:
                own_rounds[c.origin].append(c.round)
            for c in inserted.values():
                if c.round > last - JUDGED_BEFORE_END:
                    continue
                # Re-proposal needs a later certificate of the same primary
                # to commit in time for its next header to commit too.
                later = [r for r in own_rounds[c.origin]
                         if c.round < r <= last - JUDGED_BEFORE_END // 2]
                for d in c.header.payload:
                    if not later:
                        stranded.add((names.index(c.origin), bytes(d)))
                    else:
                        assert counts[bytes(d)] == 1, (i, c.round)
        if run_seed == 6:
            # The cut-off primary does not get back into the others' quorum.
            assert {a for a, _ in stranded} <= {3}
        else:
            assert reproposed > 0 and not stranded
