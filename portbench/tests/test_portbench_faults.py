"""A whole run on the CPU (the nodes on their plain twins, the card's
check skipped), sound and with the timed path broken underneath: the
judge passes the sound run's exact checks and fails each fault, and its
control (certificates of 2f votes) fails.  A sound run with one
authority crashed from the start passes the same exact checks, on the
live nodes alone.

The cells have one chip each, so the fault of an exchange between chips
left out has no place here.  On the CPU the plain twins are slow enough
that a few certificates go uncited and their batches never commit, so
the sound run is held to every check but ``uncommitted_pct``.
"""

import copy
import os

import pytest

from portbench import run as R
from portbench.reference import wire

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXACT = ("order_mismatch", "prefix_disagree", "bad_certificates", "batch_unheld",
         "sample_mismatch", "tx_count_mismatch", "node_errors")


def _run(tmp_path, monkeypatch, fault=None, controls=()):
    return _execute(tmp_path, monkeypatch, fault, controls)[1]


def _execute(tmp_path, monkeypatch, fault=None, controls=(), faults=0, rate=320):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = copy.deepcopy(R.load_cell(ROOT, "local4-steady"))
    cell.traffic.update(warmup_s=2, drain_cap_s=6)
    cell.config["faults"] = faults
    node = PACKAGE_NODE
    if fault is not None:
        monkeypatch.setenv("PORTBENCH_FAULT", fault)
        node = "portbench.tests.faulty_node"
    run = R.Run(cell, 424242, 3.0, False, device="cpu", node_module=node, rate=rate,
                controls=controls)
    out = run.execute()
    assert os.listdir(tmp_path) == []  # the work directory is gone
    assert out.notes["killed"] == 0
    return run, out


PACKAGE_NODE = R.PACKAGE + ".node"


def test_sound_run_passes_and_its_control_fails(tmp_path, monkeypatch):
    out = _run(tmp_path, monkeypatch, controls=("quorum",))
    assert {k: out.checks[k] for k in EXACT} == dict.fromkeys(EXACT, 0)
    assert out.result["attempted"] > 0
    assert out.controls["quorum"]["bad_certificates"] > 0


@pytest.mark.parametrize("fault, fails", [
    ("stale_step", "order_mismatch"),
    ("half_batch", "batch_unheld"),
    ("altered_sample", "sample_mismatch"),
    ("stall", "uncommitted_pct"),
])
def test_a_broken_path_is_not_correct(fault, fails, tmp_path, monkeypatch):
    out = _run(tmp_path, monkeypatch, fault=fault)
    assert out.checks[fails] > R.judge_mod.LIMITS[fails]
    assert out.result["correct"] is False


def test_a_crashed_authority_stays_down_and_the_live_commit_past_its_rounds(tmp_path, monkeypatch):
    judged = {}
    real = R.judge_mod.judge

    def judge(files, control=None, diag=None):
        if control is None:
            judged["keys"] = files.keys
            judged["certs"] = [c for p in files.primary_stores
                               for c in wire.stored_certificates(p, sorted(files.keys))]
            judged["logged"] = []
            for p in files.primary_logs:
                with open(p, errors="replace") as f:
                    judged["logged"].append(R.judge_mod.logged_sequence(f.read()))
        return real(files, control=control, diag=diag)

    monkeypatch.setattr(R.judge_mod, "judge", judge)
    # 300 tx/s: 20 bursts a second of 5 transactions on each of the 3 live workers
    run, out = _execute(tmp_path, monkeypatch, faults=1, rate=300)
    [dead] = run.crashed
    live = [i for i in range(4) if i != dead]
    assert sorted(run.sup.procs) == sorted(
        ["loadgen"] + [f"{r}-{i}" for i in live for r in ("primary", "worker")])
    assert out.notes["crashed"] == [{"authority": dead, "sorted_position": 0}]
    assert {k: out.checks[k] for k in EXACT} == dict.fromkeys(EXACT, 0)
    assert out.result["attempted"] > 0

    keys = judged["keys"]
    assert len(keys) == 4  # the judge's quorum counts the whole committee
    dead_key, order = keys[dead], sorted(keys)
    certs = judged["certs"]
    assert certs
    assert all(c.author != dead_key and dead_key not in [v for v, _ in c.votes]
               for c in certs)
    author = {wire.short(c.header_id): c.author for c in certs}
    assert len(judged["logged"]) == 3
    for seq in judged["logged"]:
        leaders = {r for r, h in seq if r % 2 == 0 and author.get(h) == order[r % 4]}
        dead_rounds = {r for r in range(2, max(r for r, _ in seq) + 1, 2)
                       if order[r % 4] == dead_key}
        assert leaders and not leaders & dead_rounds
        # the next leader after each dead one commits, carrying the skipped round
        assert max(leaders) > min(dead_rounds)
        assert {d + 2 for d in dead_rounds if d + 2 <= max(leaders)} <= leaders
