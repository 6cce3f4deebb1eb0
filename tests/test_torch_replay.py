"""The port's audit segments and their replay (``consensus/replay.py``)
against the JAX package's, on the CPU.

- ``AuditWriter`` writes the same segment bytes in both packages for the
  same stream of inserts and commits (tolerance 0).
- A segment written by the port's ``Consensus(use_kernel=True,
  device="cpu", audit_path=…)`` gets the same verdict from the JAX
  ``replay_segments`` as from the port's, and a segment written by the
  JAX ``Consensus`` the same verdict from both; the two segments are the
  same bytes.  A forged segment fails both judges alike.
- Then the audit and replay cases of ``tests/test_faults.py`` run again on
  the port."""

import asyncio

import pytest

import narwhal_tpu.consensus as jconsensus
import narwhal_tpu.consensus.golden as jgolden
import narwhal_tpu.consensus.replay as jreplay
import narwhal_tpu.messages as jmessages
import narwhal_tpu_torch.consensus as tconsensus
import narwhal_tpu_torch.consensus.golden as tgolden
import narwhal_tpu_torch.consensus.replay as treplay
import narwhal_tpu_torch.messages as tmessages

from tests.test_torch_faults_spec import REPLAY_CASES
from tests.test_torch_golden import build, dag_plan
from tests.test_torch_tasks import mirror, package_state

MIRRORED = mirror(globals(), "test_faults", only=REPLAY_CASES)


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED) == 6


PACKAGES = {
    "jax": (jconsensus, jgolden, jreplay, jmessages),
    "torch": (tconsensus, tgolden, treplay, tmessages),
}
# (seed, n, rounds, shuffle): delivery in round order, and children up to
# two rounds ahead of their parents.
STREAMS = [(5, 4, 24, 0.0), (6, 7, 20, 2.0)]


def _stream(pkg, case):
    seed, n, rounds, shuffle = case
    plan, order = dag_plan(seed, n, rounds, shuffle)
    return build(pkg, plan, order, n)


@pytest.mark.parametrize("case", STREAMS, ids=lambda c: "seed%d-n%d" % c[:2])
def test_audit_writer_writes_the_same_bytes(tmp_path, case):
    blobs = {}
    with package_state():
        for pkg, (_, golden, replay, messages) in PACKAGES.items():
            certs, c = _stream(pkg, case)
            messages.set_wire_committee(c)
            oracle = golden.GoldenTusk(c, 50, fixed_coin=True)
            w = replay.AuditWriter(str(tmp_path / pkg / "seg0.bin"))
            w.restore_marker(b"")
            w.rule_marker("classic")
            for cert in certs:
                w.insert(cert)
                for x in oracle.process_certificate(cert):
                    w.commit(x)
                w.flush()
            w.close()
            blobs[pkg] = (tmp_path / pkg / "seg0.bin").read_bytes()
    assert blobs["torch"] == blobs["jax"]
    assert blobs["jax"].count(b"C\x20\x00\x00\x00") > 0


async def _run_consensus(cons, certs):
    """Feed ``certs`` through the Consensus runner, then stop it and close
    its audit segment; returns the committed digests."""
    for cert in certs:
        cons.rx_primary.put_nowait(cert)
    task = asyncio.ensure_future(cons.run())
    while not cons.rx_primary.empty():
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.05)  # the last drained burst, with no await inside
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    cons._audit.close()
    out = []
    while not cons.tx_output.empty():
        out.append(bytes(cons.tx_output.get_nowait().digest()))
    return out


def _segment(pkg, case, path, use_kernel):
    consensus, _, _, messages = PACKAGES[pkg]
    certs, c = _stream(pkg, case)
    messages.set_wire_committee(c)
    kwargs = {"device": "cpu"} if use_kernel else {}
    cons = consensus.Consensus(
        c, 50, asyncio.Queue(), asyncio.Queue(), asyncio.Queue(),
        fixed_coin=True, use_kernel=use_kernel, audit_path=str(path), **kwargs)
    return asyncio.run(_run_consensus(cons, certs)), c


@pytest.mark.parametrize("case", STREAMS, ids=lambda c: "seed%d-n%d" % c[:2])
def test_both_judges_agree_on_both_packages_segments(tmp_path, case):
    with package_state():
        tseq, tc = _segment("torch", case, tmp_path / "torch.bin", use_kernel=True)
        jseq, jc = _segment("jax", case, tmp_path / "jax.bin", use_kernel=False)
        verdicts = {
            (seg, judge): PACKAGES[judge][2].replay_segments(
                committee, 50, [str(tmp_path / f"{seg}.bin")], fixed_coin=True)
            for seg, committee in (("torch", tc), ("jax", jc))
            for judge in ("jax", "torch")
        }
    assert tseq == jseq and tseq
    assert (tmp_path / "torch.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    for seg in ("torch", "jax"):
        assert verdicts[(seg, "torch")] == verdicts[(seg, "jax")]
        v = verdicts[(seg, "torch")]
        assert v["ok"], v["violations"]
        assert v["recorded_commits"] == v["golden_commits"] == len(tseq)
        assert v["commit_digests"] == [d.hex() for d in tseq]


def test_both_judges_fail_a_forged_port_segment_alike(tmp_path):
    """The port's segment with two commits of one burst swapped: both
    judges find the same divergence."""
    case = STREAMS[0]
    with package_state():
        _, tc = _segment("torch", case, tmp_path / "torch.bin", use_kernel=True)
        records = treplay.read_audit(str(tmp_path / "torch.bin"))
        commits = [i for i, (tag, _) in enumerate(records) if tag == treplay.TAG_COMMIT]
        pair = next(i for i in commits if i + 1 in commits)
        records[pair], records[pair + 1] = records[pair + 1], records[pair]
        forged = tmp_path / "forged.bin"
        w = treplay.AuditWriter(str(forged))
        for tag, payload in records:
            w._record(tag, payload)
        w.close()
        verdicts = [pkg[2].replay_segments(tc, 50, [str(forged)], fixed_coin=True)
                    for pkg in PACKAGES.values()]
    assert verdicts[0] == verdicts[1]
    assert not verdicts[0]["ok"]
    assert any("diverges" in v for v in verdicts[0]["violations"])
