"""A whole run on the CPU (the nodes on their plain twins, the card's
check skipped), sound and with the timed path broken underneath: the
judge passes the sound run's exact checks and fails each fault, and its
control (certificates of 2f votes) fails.

The cells have one chip each, so the fault of an exchange between chips
left out has no place here.  On the CPU the plain twins are slow enough
that a few certificates go uncited and their batches never commit, so
the sound run is held to every check but ``uncommitted_pct``.
"""

import copy
import os

import pytest

from portbench import run as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXACT = ("order_mismatch", "prefix_disagree", "bad_certificates", "batch_unheld",
         "sample_mismatch", "tx_count_mismatch", "node_errors")


def _run(tmp_path, monkeypatch, fault=None, controls=()):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = copy.deepcopy(R.load_cell(ROOT, "local4-steady"))
    cell.traffic.update(warmup_s=2, drain_cap_s=6)
    node = PACKAGE_NODE
    if fault is not None:
        monkeypatch.setenv("PORTBENCH_FAULT", fault)
        node = "portbench.tests.faulty_node"
    out = R.Run(cell, 424242, 3.0, False, device="cpu", node_module=node, rate=320,
                controls=controls).execute()
    assert os.listdir(tmp_path) == []  # the work directory is gone
    assert out.notes["killed"] == 0
    return out


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
