"""The port's network (receiver, both senders, stamped ACKs, clock-offset
estimation, the wire ledger) against the JAX package's, on the CPU.

On loopback a port ``ReliableSender`` sends to a reference ``Receiver``
and a reference ``ReliableSender`` to a port ``Receiver``, with wire v2
on and off: the delivered payload bytes must be the sent ones, every ACK
must parse in the other package, and the two runs' wire ledgers must
hold the same accounts.  Then the cases of ``tests/test_network.py``,
``tests/test_clocksync.py`` and ``tests/test_wire_ledger.py`` run again
on the port."""

import asyncio
import random

import pytest

import narwhal_tpu.messages as jmessages
import narwhal_tpu.network as jnetwork
import narwhal_tpu.network.clocksync as jclocksync
import narwhal_tpu.network.wirev2 as jwirev2
import narwhal_tpu.primary.messages as jpmessages
import narwhal_tpu_torch.messages as tmessages
import narwhal_tpu_torch.network as tnetwork
import narwhal_tpu_torch.network.clocksync as tclocksync
import narwhal_tpu_torch.network.wirev2 as twirev2
import narwhal_tpu_torch.primary.messages as tpmessages
from narwhal_tpu import metrics as jmetrics
from narwhal_tpu_torch import metrics as tmetrics
from narwhal_tpu_torch.config import Committee as TCommittee

from tests.common import committee, keys, make_certificate, make_header, make_vote
from tests.test_torch_tasks import mirror, package_state

MIRRORED_NETWORK = mirror(globals(), "test_network")
MIRRORED_CLOCKSYNC = mirror(
    globals(), "test_clocksync",
    # The harness-side joins (benchmark/metrics_check.py) run no port
    # code.
    skip=("test_corrected_join_recovers_zero_skew_ground_truth",
          "test_critical_path_legs_telescope_to_e2e",
          "test_quorum_straggler_summary_ranks_most_charged_first"),
)
MIRRORED_LEDGER = mirror(
    globals(), "test_wire_ledger",
    # Pure benchmark/metrics_check.py arithmetic over snapshot dicts.
    skip=("test_wire_crypto_summary_derived_metrics",
          "test_summary_tolerates_empty_and_disabled_snapshots"),
)

PKGS = {
    "jax": (jnetwork, jclocksync, jwirev2, jmessages, jpmessages, jmetrics),
    "torch": (tnetwork, tclocksync, twirev2, tmessages, tpmessages, tmetrics),
}


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED_NETWORK) == 11
    assert len(MIRRORED_CLOCKSYNC) == 8
    assert len(MIRRORED_LEDGER) == 6


def test_acks_cross_packages():
    for stamp, parse in ((tclocksync.stamp_ack, jclocksync.parse_ack),
                         (jclocksync.stamp_ack, tclocksync.parse_ack)):
        ack = stamp()
        assert len(ack) == 11 and ack.startswith(b"Ack")
        t = parse(ack)
        assert isinstance(t, float) and t > 0
        assert parse(b"Ack") is None and parse(b"Nak" + bytes(8)) is None
    fixed = b"Ack" + jclocksync._STAMP.pack(1234.5)
    assert tclocksync.parse_ack(fixed) == jclocksync.parse_ack(fixed) == 1234.5


@pytest.mark.parametrize("seed", [0, 7])
def test_offset_estimators_agree_on_seeded_samples(seed):
    rng = random.Random(seed)
    samples = []
    for _ in range(200):
        rtt = rng.choice([0.001, 0.002, 0.01, 0.5]) * rng.uniform(0.5, 2)
        samples.append((rng.gauss(0.04, 0.01), rtt))
    ests = [jclocksync.OffsetEstimator(), tclocksync.OffsetEstimator()]
    for offset, rtt in samples:
        folded = [e.add(offset, rtt) for e in ests]
        assert folded[0] == folded[1]
    assert [(e.offset_s, e.uncertainty_s, e.min_rtt_s, e.samples)
            for e in ests][0] == [(e.offset_s, e.uncertainty_s, e.min_rtt_s,
                                   e.samples) for e in ests][1]
    peers = {f"n{i}": {f"n{j}": rng.uniform(-300, 300) for j in range(5) if j != i}
             for i in range(5)}
    assert tclocksync.reconcile_zero_mean(peers) == jclocksync.reconcile_zero_mean(peers)


def _frames():
    """Encoded header, vote and certificate frames (their bytes are the
    same in both packages) and a frame of no known type."""
    c = committee()
    kps = keys()
    frames = []
    for r, kp in enumerate(kps, 1):
        h = make_header(kp, round_=r, c=c)
        frames.append((jpmessages.encode_primary_message(h), "header"))
        frames.append((jpmessages.encode_primary_message(make_vote(h, kps[0])), "vote"))
        frames.append((jpmessages.encode_primary_message(make_certificate(h)),
                       "certificate"))
    frames.append((b"\x07" + bytes(range(200)), "other"))
    return c, frames


class _Recorder:
    def __init__(self, clocksync):
        self.clocksync = clocksync
        self.received = []

    async def dispatch(self, writer, message):
        self.received.append(message)
        await writer.send(self.clocksync.stamp_ack())


def _wire(reg, direction):
    return {k: c.value for k, c in reg.counters.items()
            if k.startswith(f"wire.{direction}.") and c.value}


def _peers(reg, direction):
    return {t: sorted(cells.values())
            for t, cells in reg.wire.peers[direction].items()}


async def _exchange(sender_pkg, receiver_pkg, frames):
    snet = PKGS[sender_pkg][0]
    rnet, rclock, _, rmsg, rpmsg, _ = PKGS[receiver_pkg]
    handler = _Recorder(rclock)
    recv = await rnet.Receiver.spawn(
        "127.0.0.1:0", handler,
        classify=rmsg.frame_classifier(rpmsg.PRIMARY_FRAME_TYPES),
    )
    sender = snet.ReliableSender()
    try:
        addr = f"127.0.0.1:{recv.port}"
        acks = []
        for data, msg_type in frames:
            acks.append(await asyncio.wait_for(sender.send(addr, data, msg_type), 10))
    finally:
        sender.close()
        await recv.shutdown()
    return handler.received, acks


@pytest.mark.parametrize("v2", ["1", "0"])
def test_reliable_send_crosses_packages(monkeypatch, v2):
    monkeypatch.setenv("NARWHAL_WIRE_V2", v2)
    c, frames = _frames()
    runs = {}
    with package_state():
        jmessages.set_wire_committee(c)
        tmessages.set_wire_committee(TCommittee.from_json(c.to_json()))
        for w in (jwirev2, twirev2):
            w.set_enabled(None)
        try:
            for sender, receiver in (("torch", "jax"), ("jax", "torch")):
                for pkg in PKGS.values():
                    pkg[-1].registry().reset()
                received, acks = asyncio.run(_exchange(sender, receiver, frames))
                sreg = PKGS[sender][-1].registry()
                rreg = PKGS[receiver][-1].registry()
                runs[sender] = dict(
                    received=received,
                    stamps=[PKGS[sender][1].parse_ack(a) for a in acks],
                    out=_wire(sreg, "out"), inn=_wire(rreg, "in"),
                    out_peers=_peers(sreg, "out"), in_peers=_peers(rreg, "in"),
                    v2=(jwirev2.enabled(), twirev2.enabled()),
                )
        finally:
            for w in (jwirev2, twirev2):
                w.set_enabled(None)
    sent = [data for data, _ in frames]
    for run in runs.values():
        assert run["received"] == sent
        assert all(isinstance(t, float) for t in run["stamps"])
        assert run["v2"] == ((v2 == "1"),) * 2
        # What was sent is what was received, per type.
        for t in ("header", "vote", "certificate"):
            assert run["out"][f"wire.out.frames.{t}"] == 4
            assert run["inn"][f"wire.in.frames.{t}"] == 4
            assert run["out"][f"wire.out.bytes.{t}"] == run["inn"][f"wire.in.bytes.{t}"]
    a, b = runs["torch"], runs["jax"]
    assert a["out"] == b["out"] and a["inn"] == b["inn"]
    assert a["out_peers"] == b["out_peers"] and a["in_peers"] == b["in_peers"]
    raw = sum(len(d) for d, t in frames if t == "certificate")
    assert a["out"]["wire.out.raw_bytes.certificate"] == raw
    if v2 == "0":
        assert a["out"]["wire.out.bytes.certificate"] == raw


def test_simple_send_crosses_packages():
    async def go(snet, rnet, rclock):
        handler = _Recorder(rclock)
        recv = await rnet.Receiver.spawn("127.0.0.1:0", handler)
        sender = snet.SimpleSender()
        try:
            for i in range(5):
                sender.send(f"127.0.0.1:{recv.port}", bytes([i]) * 50, "other")
            for _ in range(200):
                if len(handler.received) == 5:
                    break
                await asyncio.sleep(0.01)
        finally:
            sender.close()
            await recv.shutdown()
        return handler.received

    with package_state():
        want = [bytes([i]) * 50 for i in range(5)]
        assert asyncio.run(go(tnetwork, jnetwork, jclocksync)) == want
        assert asyncio.run(go(jnetwork, tnetwork, tclocksync)) == want
