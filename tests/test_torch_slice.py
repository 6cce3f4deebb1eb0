"""The port's slice as a whole against the JAX package, on the CPU: a
4-node, 12-round signed DAG through the batched verify seam and then
through Consensus(use_kernel=True), plus checkpoint blobs across the two
packages.

Certificates and the committee cross packages as bytes/JSON only.  Every
comparison is exact: masks, digest sequences and checkpoint bytes."""

import asyncio
import os

import pytest

import narwhal_tpu.messages as jmessages
import narwhal_tpu_torch.messages as tmessages
from narwhal_tpu.consensus import Consensus as JaxConsensus
from narwhal_tpu.consensus import State as JaxState
from narwhal_tpu.consensus import Tusk as JaxTusk
from narwhal_tpu.crypto.backend import CpuBackend as JaxCpuBackend
from narwhal_tpu.primary.messages import Certificate, Header, Vote, genesis
from narwhal_tpu_torch.consensus import Consensus as TorchConsensus
from narwhal_tpu_torch.config import Committee as TorchCommittee
from narwhal_tpu_torch.consensus import State as TorchState
from narwhal_tpu_torch.crypto import backend as tbackend
from narwhal_tpu_torch.primary.messages import Certificate as TorchCertificate
from narwhal_tpu_torch.primary.messages import genesis as tgenesis

from tests.common import committee, keys

ROUNDS = 12
GC_DEPTH = 50


def signed_dag(c):
    """12 fully signed rounds: every header cites the whole previous
    round; each certificate carries the votes of the 3 non-authors."""
    kps = {kp.name: kp for kp in keys()}
    names = sorted(kps)
    parents = {x.digest() for x in genesis(c)}
    out = []
    for r in range(1, ROUNDS + 1):
        certs = []
        for name in names:
            h = Header(author=name, round=r, payload={}, parents=set(parents))
            h.id = h.compute_digest()
            h.signature = kps[name].sign(h.id)
            votes = []
            for voter in names:
                if voter != name:
                    v = Vote(id=h.id, round=r, origin=name, author=voter)
                    votes.append((voter, kps[voter].sign(v.digest())))
            certs.append(Certificate(header=h, votes=votes))
        out.extend(certs)
        parents = {x.digest() for x in certs}
    return out


@pytest.fixture(scope="module")
def slice_inputs():
    jc = committee()
    tc = TorchCommittee.from_json(jc.to_json())
    saved = [(m, m._WIRE_KEYS, m._WIRE_INDEX) for m in (jmessages, tmessages)]
    jmessages.set_wire_committee(jc)
    tmessages.set_wire_committee(tc)
    certs = signed_dag(jc)
    ported = [TorchCertificate.deserialize(x.serialize()) for x in certs]
    yield jc, tc, certs, ported
    for m, ks, index in saved:
        m._WIRE_KEYS, m._WIRE_INDEX = ks, index


def test_certificates_cross_as_bytes(slice_inputs):
    _, tc, certs, ported = slice_inputs
    assert [bytes(x.digest()) for x in ported] == [bytes(x.digest()) for x in certs]
    assert [x.serialize() for x in ported] == [x.serialize() for x in certs]
    for cert in ported[:4]:
        cert.verify_structure(tc)


def test_verify_masks_equal_jax_cpu_backend(slice_inputs):
    """Every claim of the DAG (plus flipped copies of a few) in one batch:
    the port's cuda backend on device="cpu" (the kernel's plain twin) and
    the port's cpu backend give the JAX cpu backend's mask."""
    _, _, certs, ported = slice_inputs
    jclaims = [cl for x in certs for cl in x.signature_claims()]
    tclaims = [cl for x in ported for cl in x.signature_claims()]
    flips = [3, 17, 40, 100, 191]
    for claims, sig_type in ((jclaims, type(jclaims[0][2])), (tclaims, type(tclaims[0][2]))):
        for i in flips:
            m, k, s = claims[i]
            bad = bytearray(bytes(s))
            bad[i % 64] ^= 1
            claims.append((m, k, sig_type(bytes(bad))))
    want = JaxCpuBackend().verify_batch_mask(*zip(*jclaims))
    assert want.count(False) == len(flips) and len(want) == 4 * 4 * ROUNDS + len(flips)
    tbackend.set_backend("cuda", device="cpu")
    try:
        assert tbackend.get_backend().name == "cuda"
        got = tbackend.verify_batch_mask(*zip(*tclaims), site="batch_burst")
    finally:
        tbackend.set_backend("cpu")
    assert got == list(want)
    assert tbackend.verify_batch_mask(*zip(*tclaims)) == list(want)


async def _run(consensus, certs, n_out):
    runner = asyncio.ensure_future(consensus.run())
    out = []
    try:
        for cert in certs:
            await consensus.rx_primary.put(cert)
        while len(out) < n_out:
            out.append(await asyncio.wait_for(consensus.tx_output.get(), 30))
        # Let the burst's checkpoint rewrite land before stopping.
        for _ in range(1000):
            if os.path.exists(consensus.checkpoint_path):
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
    finally:
        runner.cancel()
        try:
            await runner
        except asyncio.CancelledError:
            pass
    return out


def _consensus(cls, c, **kw):
    return cls(c, GC_DEPTH, asyncio.Queue(), asyncio.Queue(), asyncio.Queue(), **kw)


def test_consensus_kernel_sequences_and_checkpoints(slice_inputs, tmp_path):
    jc, tc, certs, ported = slice_inputs
    golden = JaxTusk(jc, GC_DEPTH)
    want = [bytes(x.digest()) for cert in certs for x in golden.process_certificate(cert)]
    assert len(want) > 20

    async def both():
        jcons = _consensus(JaxConsensus, jc, use_kernel=True,
                           checkpoint_path=str(tmp_path / "jax.ckpt"))
        tcons = _consensus(TorchConsensus, tc, use_kernel=True, device="cpu",
                           checkpoint_path=str(tmp_path / "torch.ckpt"))
        jout = await _run(jcons, certs, len(want))
        tout = await _run(tcons, ported, len(want))
        return jcons, tcons, jout, tout

    jcons, tcons, jout, tout = asyncio.run(both())
    assert [bytes(x.digest()) for x in tout] == [bytes(x.digest()) for x in jout] == want
    assert tcons.tusk.python_fallbacks == 0

    # Checkpoint blobs: byte-identical, in memory and on disk.
    jblob = jcons.tusk.state.snapshot_bytes()
    tblob = tcons.tusk.state.snapshot_bytes()
    assert jblob == tblob
    assert (tmp_path / "jax.ckpt").read_bytes() == (tmp_path / "torch.ckpt").read_bytes() == jblob

    # ... and each package restores the other's.
    ts = TorchState(tgenesis(tc))
    ts.restore(jblob)
    js = JaxState(genesis(jc))
    js.restore(tblob)
    assert ts.snapshot_bytes() == js.snapshot_bytes() == jblob
    restored = _consensus(TorchConsensus, tc, use_kernel=True, device="cpu",
                          checkpoint_path=str(tmp_path / "jax.ckpt"))
    assert restored.tusk.state.last_committed_round == jcons.tusk.state.last_committed_round
    assert restored.tusk._win_base == restored.tusk.state.last_committed_round
    # A catch-up replay of committed history re-delivers nothing.
    assert all(not restored.tusk.process_certificate(x) for x in ported)
