"""The port's fault planes (``faults/spec.py``, ``faults/netem.py``)
against the JAX package's, on the CPU: every scenario file under
``benchmark/scenarios/`` parses to equal dataclasses in both packages,
an invalid spec raises the same ``SpecError`` text, and two emulators
built from one seed and one set of shapes take the same per-frame delay
and drop decisions and give the same ``blocked()`` answers.  Then the
cases of ``tests/test_faults.py`` that drive these two modules and the
health rules (``metrics.HealthMonitor``) run again on the port."""

import asyncio
import dataclasses
import glob
import json
import os
import types

import pytest

from narwhal_tpu.faults import netem as jnetem
from narwhal_tpu.faults import spec as jspec
from narwhal_tpu_torch.config import Committee as TCommittee
from narwhal_tpu_torch.faults import netem as tnetem
from narwhal_tpu_torch.faults import spec as tspec

from tests.common import committee
from tests.test_torch_tasks import mirror

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = sorted(glob.glob(os.path.join(ROOT, "benchmark", "scenarios", "*.json")))

# The cases of tests/test_faults.py that other port test files mirror.
REPLAY_CASES = (
    "test_replay_segment_roundtrip_clean_stream",
    "test_replay_detects_reordered_and_forged_commits",
    "test_replay_detects_double_commit_within_segment",
    "test_audit_writer_rolls_instead_of_appending_to_old_segment",
    "test_read_audit_tolerates_torn_tail",
    "test_cross_node_prefix_accepts_lag_rejects_fork",
)
PLAN_CASES = (
    "test_equivocate_requires_unit_stake_committee",
    "test_byzantine_plan_roundtrip_and_split",
)
SOCKET_CASES = (
    "test_shaped_writer_delays_frames_in_order",
    "test_shaped_writer_loss_surfaces_as_connection_reset",
    "test_partition_cuts_established_connection",
)
BENCH_CASES = (
    "test_log_commit_fallback_counts_post_settle_lines",
    "test_log_commit_fallback_incremental_state",
)

MIRRORED = mirror(
    globals(), "test_faults",
    skip=(
        # Real sockets shaped through netem: these fail on the reference
        # itself in this sandbox, so they are not copied.
        *SOCKET_CASES,
        # The fault bench's log parsing (benchmark/fault_bench.py) runs
        # no port code.
        *BENCH_CASES,
        # Mirrored in tests/test_torch_replay.py (the audit replay) and
        # tests/test_torch_byzantine.py (the Byzantine plan).
        *REPLAY_CASES, *PLAN_CASES,
    ),
)


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED) == 15
    assert len(SCENARIOS) == 17


@pytest.mark.parametrize("path", SCENARIOS, ids=os.path.basename)
def test_every_scenario_parses_alike(path):
    for env in ({}, {"NARWHAL_FAULT_SEED": "4242"}):
        want = jspec.load_scenario(path, env=env)
        got = tspec.load_scenario(path, env=env)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.byzantine_nodes() == want.byzantine_nodes()
        assert got.honest_nodes() == want.honest_nodes()
        assert got.is_clean() == want.is_clean()
        assert (dataclasses.asdict(got.control_arm())
                == dataclasses.asdict(want.control_arm()))


INVALID = {
    "not-an-object": [1, 2],
    "no-name": {"nodes": 4},
    "unknown-field": {"name": "t", "bogus": 1},
    "nodes-range": {"name": "t", "nodes": 3},
    "bad-behavior": {"name": "t", "byzantine": [{"node": 0, "behaviors": ["fly"]}]},
    "no-behaviors": {"name": "t", "byzantine": [{"node": 0, "behaviors": []}]},
    "over-f": {"name": "t", "byzantine": [
        {"node": 0, "behaviors": ["equivocate"]},
        {"node": 1, "behaviors": ["wrong_key"]}]},
    "dup-node": {"name": "t", "nodes": 7, "byzantine": [
        {"node": 0, "behaviors": ["equivocate"]},
        {"node": 0, "behaviors": ["wrong_key"]}]},
    "crash-late": {"name": "t", "duration": 20, "crash": [{"node": 0, "at_s": 20}]},
    "big-partition": {"name": "t", "wan": {"partitions": [{"group": [0, 1], "from_s": 1}]}},
    "mixed-faults": {"name": "t", "byzantine": [{"node": 0, "behaviors": ["equivocate"]}],
                     "wan": {"partitions": [{"group": [1], "from_s": 1}]}},
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_specs_raise_the_same_error(name):
    errors = []
    for spec in (jspec, tspec):
        with pytest.raises(spec.SpecError) as info:
            spec.parse_scenario(INVALID[name], env={})
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_malformed_seed_override_raises_the_same_error():
    errors = []
    for spec in (jspec, tspec):
        with pytest.raises(spec.SpecError) as info:
            spec.parse_scenario({"name": "t"}, env={"NARWHAL_FAULT_SEED": "0x2A"})
        errors.append(str(info.value))
    assert errors[0] == errors[1]


class _NullWriter:
    def write(self, data):
        pass

    async def drain(self):
        pass

    def close(self):
        pass


def _emulator(netem, seed):
    shapes = {
        "10.0.0.1:1": netem.Shape(latency_ms=40.0, jitter_ms=15.0, loss=0.3),
        "10.0.0.2:1": netem.Shape(latency_ms=5.0),
    }
    windows = [
        netem.PartitionWindow(frozenset({"10.0.0.3:1", "10.0.0.1:1"}), 2.0, 7.5),
        netem.PartitionWindow(frozenset({"10.0.0.4:1"}), 4.0, None),
    ]
    return netem.NetEmulator(
        shapes, netem.Shape(jitter_ms=3.0, loss=0.1), windows,
        seed=seed, node="primary-2", start_ts=1000.0,
    )


async def _decisions(netem, seed, frames=120):
    """Per destination: the shaped writer's decision for each frame,
    ``None`` for an emulated loss, else the frame's delay in seconds."""
    emu = _emulator(netem, seed)
    out = {}
    for addr in ("10.0.0.1:1", "10.0.0.2:1", "10.0.0.9:1"):
        _, writer = emu.wrap(addr, None, _NullWriter())
        writer._loop = types.SimpleNamespace(time=lambda: 0.0)
        emu.partitions, windows = [], emu.partitions  # shape only, here
        got = []
        for i in range(frames):
            writer.write(bytes([i]) * 8)
            try:
                await writer.drain()
            except ConnectionResetError:
                got.append(None)
                continue
            got.append(writer._q.pop()[0])
        emu.partitions = windows
        writer.close()
        out[addr] = got
    return out


@pytest.mark.parametrize("seed", [0, 11, 2026])
def test_netem_draws_the_same_decisions(seed):
    want = asyncio.run(_decisions(jnetem, seed))
    got = asyncio.run(_decisions(tnetem, seed))
    assert got == want
    assert None in got["10.0.0.1:1"] and None not in got["10.0.0.2:1"]
    assert set(got["10.0.0.2:1"]) == {0.005}


def test_netem_blocked_answers_and_windows_match():
    emus = [_emulator(n, 5) for n in (jnetem, tnetem)]
    assert [(tuple(sorted(w.peers)), w.from_s, w.until_s) for w in emus[0].partitions] == [
        (tuple(sorted(w.peers)), w.from_s, w.until_s) for w in emus[1].partitions]
    for addr in ("10.0.0.1:1", "10.0.0.3:1", "10.0.0.4:1", "10.0.0.2:1"):
        for t in [x * 0.25 for x in range(-4, 60)]:
            assert emus[0].blocked(addr, now=1000.0 + t) == emus[1].blocked(addr, now=1000.0 + t)
        assert (emus[0].shape_for(addr) is None) == (emus[1].shape_for(addr) is None)


@pytest.mark.parametrize("name", ["wan_lossy", "wan_partition_heal",
                                  "compose_equivocate_wan_lossy"])
def test_wan_plane_resolves_and_loads_alike(tmp_path, name):
    path = os.path.join(ROOT, "benchmark", "scenarios", name + ".json")
    jscn = jspec.load_scenario(path, env={})
    tscn = tspec.load_scenario(path, env={})
    jc = committee(base_port=20500, n=jscn.nodes, workers=jscn.workers)
    tc = TCommittee.from_json(jc.to_json())
    names = sorted(jc.authorities)
    want = jnetem.resolve_wan_plane(jscn, jc, names)
    got = tnetem.resolve_wan_plane(tscn, tc, sorted(tc.authorities))
    assert got == want and want
    cfg = tmp_path / "netem.json"
    cfg.write_text(json.dumps({"seed": jscn.seed, "start_ts": 10.0, "nodes": want}))
    for label in sorted(want):
        a = jnetem.NetEmulator.load(str(cfg), label)
        b = tnetem.NetEmulator.load(str(cfg), label)
        assert a.rules == {k: jnetem.Shape(**dataclasses.asdict(v)) for k, v in b.rules.items()}
        assert [dataclasses.astuple(w) for w in a.partitions] == [
            dataclasses.astuple(w) for w in b.partitions]
        assert a.rng.random() == b.rng.random()
    assert tnetem.NetEmulator.load(str(cfg), "nobody") is None

