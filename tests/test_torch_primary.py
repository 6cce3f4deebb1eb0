"""The port's primary (``Proposer``, the two aggregators, ``Core``)
against the JAX package's, on the CPU.

- Proposers with one key, fed the same parents and digests, mint
  byte-identical headers.
- The aggregators, fed the same votes and certificates, give
  byte-identical certificates and the same parent lists.
- A ``Core`` in each package is fed one seeded stream of headers, votes
  and certificates from 4 keys, as drained bursts: the reference verifies
  on its ``CpuBackend``, the port on ``set_backend("cuda", device="cpu")``
  (the plain twin of the verify kernel).  Both send the same messages, as
  bytes, to the same peers, hand the same certificates to consensus and
  the same parents to the proposer.

Then the cases of ``tests/test_core.py``, ``tests/test_proposer.py`` and
``tests/test_verify_window.py`` run again on the port."""

import asyncio
import importlib
import random

import pytest

import narwhal_tpu.messages as jmessages
import narwhal_tpu.primary.messages as jpm
import narwhal_tpu_torch.messages as tmessages
import narwhal_tpu_torch.primary.messages as tpm
from narwhal_tpu.crypto import KeyPair as JKeyPair
from narwhal_tpu.crypto import Signature as JSignature
from narwhal_tpu.crypto import backend as jbackend
from narwhal_tpu_torch.config import Committee as TCommittee
from narwhal_tpu_torch.crypto import backend as tbackend

from tests.common import committee, keys, make_header, make_vote
from tests.test_torch_tasks import mirror, package_state

MIRRORED_CORE = mirror(globals(), "test_core")
MIRRORED_PROPOSER = mirror(globals(), "test_proposer")
# The port's batched backend is spelled "cuda" (the reference's "jax" and
# "tpu"), and a verifier that cannot be built or loaded says so.
MIRRORED_WINDOW = mirror(
    globals(), "test_verify_window",
    subs=(('match="failed to import"', 'match="failed to build or load"'),
          ('cb.set_backend("jax", strict=True)', 'cb.set_backend("cuda", strict=True)'),
          ('cb.set_backend("tpu")', 'cb.set_backend("cuda")'),
          ('"NARWHAL_CRYPTO_BACKEND", "jax"', '"NARWHAL_CRYPTO_BACKEND", "cuda"')),
)


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED_CORE) == 22
    assert len(MIRRORED_PROPOSER) == 13
    assert len(MIRRORED_WINDOW) == 11


PACKAGES = ("narwhal_tpu", "narwhal_tpu_torch")


def _mod(pkg: str, path: str):
    return importlib.import_module(f"{pkg}.{path}")


@pytest.fixture
def wire_committees():
    jc = committee()
    tc = TCommittee.from_json(jc.to_json())
    with package_state():
        jmessages.set_wire_committee(jc)
        tmessages.set_wire_committee(tc)
        yield {"narwhal_tpu": jc, "narwhal_tpu_torch": tc}


# -- Proposer -------------------------------------------------------------------


async def _propose(pkg, c, kp_bytes, rounds):
    Proposer = _mod(pkg, "primary.proposer").Proposer
    crypto = _mod(pkg, "crypto")
    kp = crypto.KeyPair.generate(kp_bytes)
    rx_workers, tx_core = asyncio.Queue(), asyncio.Queue()
    service = crypto.SignatureService(kp)
    # Sealed by size alone (two digests), never by the delay.
    p = Proposer(kp.name, c, service, 64, 60_000, None, rx_workers, tx_core)
    task = asyncio.ensure_future(p.run())
    out = []
    try:
        for r, (parents, digests) in enumerate(rounds, 1):
            if r > 1:
                p.deliver_parents([crypto.Digest(d) for d in parents], r - 1)
            for d, worker in digests:
                await rx_workers.put((crypto.Digest(d), worker))
            header = await asyncio.wait_for(tx_core.get(), 10)
            out.append(_mod(pkg, "primary.messages").encode_primary_message(header))
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        service.close()
    return out


def test_proposers_mint_byte_identical_headers(wire_committees):
    rng = random.Random(3)
    rounds = [([rng.randbytes(32) for _ in range(3)],
               [(rng.randbytes(32), rng.randrange(2)) for _ in range(2)])
              for _ in range(6)]
    seed = bytes([9]) * 32
    jax, port = (asyncio.run(_propose(pkg, wire_committees[pkg], seed, rounds))
                 for pkg in PACKAGES)
    assert port == jax and len(jax) == 6
    headers = [tpm.decode_primary_message(b)[1] for b in port]
    assert [h.round for h in headers] == [1, 2, 3, 4, 5, 6]
    assert {bytes(p) for p in headers[3].parents} == set(rounds[3][0])


# -- aggregators ----------------------------------------------------------------


def test_aggregators_give_byte_identical_certificates(wire_committees):
    jc = wire_committees["narwhal_tpu"]
    kps = keys()
    out = []
    for pkg in PACKAGES:
        agg = _mod(pkg, "primary.aggregators")
        pm = _mod(pkg, "primary.messages")
        c = wire_committees[pkg]
        certs, parents = [], []
        votes_agg = {}
        cert_agg = agg.CertificatesAggregator()
        for author in kps:
            jh = make_header(author, c=jc)
            h = pm.decode_primary_message(jpm.encode_primary_message(jh))[1]
            va = votes_agg.setdefault(author.name, agg.VotesAggregator())
            for voter in reversed(kps):
                v = pm.decode_primary_message(
                    jpm.encode_primary_message(make_vote(jh, voter)))[1]
                cert = va.append(v, c, h)
                if cert is not None:
                    certs.append(pm.encode_primary_message(cert))
                    p = cert_agg.append(cert, c)
                    if p is not None:
                        parents.append(sorted(bytes(d) for d in p))
            with pytest.raises(_mod(pkg, "primary.errors").AuthorityReuse):
                va.append(v, c, h)
        out.append((certs, parents))
    assert out[1] == out[0]
    certs, parents = out[1]
    assert len(certs) == 4 and len(parents) == 1 and len(parents[0]) == 3


# -- Core -----------------------------------------------------------------------


class _Wire:
    """A ReliableSender stand-in that records every frame the Core sends
    and acknowledges it at once."""

    def __init__(self):
        self.sent = []

    def send(self, address, data, msg_type="other"):
        self.sent.append((address, bytes(data), msg_type))
        fut = asyncio.get_running_loop().create_future()
        fut.set_result(b"Ack")
        return fut

    def broadcast(self, addresses, data, msg_type="other"):
        return [self.send(a, data, msg_type) for a in addresses]

    def close(self):
        pass


def _stream(c, rounds, seed):
    """Per round: our own header's wire bytes, then the round's peer
    messages as bursts of wire bytes, in a seeded order: the other three
    authors' headers (one forged in round 2), the votes on our header
    (one forged in round 3, one late in round 4), and all four
    certificates (votes of the three non-authors)."""
    rng = random.Random(seed)
    kps = keys()
    me = kps[0]
    enc = jpm.encode_primary_message
    parents = {x.digest() for x in jpm.genesis(c)}
    out = []
    for r in range(1, rounds + 1):
        headers = [make_header(kp, round_=r, parents=parents, c=c) for kp in kps]
        peer = [enc(h) for h in headers[1:]]
        votes = [make_vote(headers[0], kp) for kp in kps[1:]]
        if r == 2:
            forged = make_header(kps[2], round_=r, parents=parents, c=c)
            forged.signature = JSignature(bytes(64))
            peer.append(enc(forged))
        if r == 3:
            bad = make_vote(headers[0], kps[3])
            bad.signature = JSignature(bytes(reversed(bytes(bad.signature))))
            peer.append(enc(bad))
        peer += [enc(v) for v in votes]
        certs = []
        for h in headers:
            cert = jpm.Certificate(header=h, votes=[
                (v.author, v.signature) for v in
                (make_vote(h, kp) for kp in kps if kp.name != h.author)])
            certs.append(cert)
        peer += [enc(x) for x in certs]
        if r == 4:
            late = make_vote(out[-1][0][1], kps[2])  # a vote for round 3
            peer.append(enc(late))
        rng.shuffle(peer)
        cut = rng.randrange(1, len(peer))
        bursts = [peer[:cut], peer[cut:]]
        out.append(((enc(headers[0]), headers[0]), bursts))
        parents = {x.digest() for x in certs}
    return me, out


async def _drive_core(pkg, c, me_seed, stream):
    mod = lambda path: _mod(pkg, path)  # noqa: E731
    pm = mod("primary.messages")
    crypto = mod("crypto")
    me = crypto.KeyPair.generate(me_seed)
    store = mod("store").Store()
    queues = [asyncio.Queue() for _ in range(7)]
    sync = mod("primary.synchronizer").Synchronizer(me.name, c, store, queues[0], queues[1])
    core_mod = mod("primary.core")
    service = crypto.SignatureService(me)
    core = core_mod.Core(
        me.name, c, store, sync, service, core_mod.AtomicRound(), gc_depth=50,
        rx_primaries=queues[2], rx_header_waiter=queues[3],
        rx_certificate_waiter=queues[4], rx_proposer=queues[5],
        tx_consensus=asyncio.Queue(), tx_proposer=queues[6],
    )
    core.network = wire = _Wire()
    try:
        # As Core.run does: each burst, then the staged votes' release
        # and the GC sweep.
        for (own, _), bursts in stream:
            await core._handle("proposer", pm.decode_primary_message(own)[1])
            core._flush_pending()
            core._gc_sweep()
            for burst in bursts:
                await core._handle_primaries_burst(
                    [pm.decode_primary_message(b) for b in burst])
                core._flush_pending()
                core._gc_sweep()
    finally:
        service.close()
    consensus = []
    while not core.tx_consensus.empty():
        consensus.append(pm.encode_primary_message(core.tx_consensus.get_nowait()))
    parents = []
    while not queues[6].empty():
        digests, rnd = queues[6].get_nowait()
        parents.append((rnd, sorted(bytes(d) for d in digests)))
    reg = mod("metrics").registry()
    counters = {k: reg.counters[k].value for k in (
        "primary.invalid_signatures", "primary.votes_sent",
        "primary.certificates_formed", "primary.certificates_processed",
        "crypto.burst_claims.certificate")}
    return wire.sent, consensus, parents, counters, store


def test_core_sends_and_commits_the_same_bytes(wire_committees):
    jc = wire_committees["narwhal_tpu"]
    # Each burst is one call of the verify kernel's plain twin, ~1.6 s on
    # the CPU: 4 rounds of 2 bursts keep the test near 15 s.
    me, stream = _stream(jc, rounds=4, seed=0)
    seed_bytes = bytes([0]) * 32
    assert JKeyPair.generate(seed_bytes).name == me.name
    jbackend.set_backend("cpu")
    tbackend.set_backend("cuda", device="cpu")
    assert tbackend.get_backend().name == "cuda"
    results = []
    for pkg in PACKAGES:
        _mod(pkg, "metrics").registry().reset()
        results.append(asyncio.run(
            _drive_core(pkg, wire_committees[pkg], seed_bytes, stream)))
    (jsent, jcons, jpar, jcnt, jstore), (tsent, tcons, tpar, tcnt, tstore) = results
    assert tsent == jsent
    assert tcons == jcons
    assert tpar == jpar
    assert tcnt == jcnt
    assert sorted(tstore.values()) == sorted(jstore.values())
    jstore.close()
    tstore.close()
    # Every round: our header out to 3 peers, a vote to each peer author,
    # our certificate out to 3 peers; the two forged messages rejected.
    kinds = [t for _, _, t in tsent]
    assert kinds.count("header") == 12 and kinds.count("certificate") == 12
    assert kinds.count("vote") == 12
    assert tcnt["primary.invalid_signatures"] == 2
    # Consensus gets our own 4 certificates and the 16 received ones.
    assert len(tcons) == 20 and [r for r, _ in tpar] == [1, 2, 3, 4]
