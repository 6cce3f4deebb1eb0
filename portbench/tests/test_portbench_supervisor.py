"""The supervisor leaves no process of a run's tree alive, whatever the
children do and however the harness ends."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from portbench import run as R
from portbench.supervisor import _alive

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _harness(scenario, tmp_path, timeout=60):
    pid_file = str(tmp_path / "pids")
    out = subprocess.run([sys.executable, "-m", "portbench.tests.harness_child", scenario, pid_file],
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _gone(pids, within=5.0):
    end = time.monotonic() + within
    while time.monotonic() < end:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("scenario, killed", [
    ("ignores_term", 2),  # both children outlive SIGTERM
    ("forks_and_exits", 2),  # each grandchild is orphaned
    ("setsid_grandchild", 2),  # each grandchild left its session
])
def test_teardown_leaves_no_process(scenario, killed, tmp_path):
    got = _harness(scenario, tmp_path)
    assert got["left"] == []
    assert got["killed"] == killed
    assert len(got["pids"]) == (2 if scenario == "ignores_term" else 4)
    assert _gone(got["pids"])


def test_children_die_with_a_killed_harness(tmp_path):
    pid_file = tmp_path / "pids"
    proc = subprocess.Popen([sys.executable, "-m", "portbench.tests.harness_child", "sleepers",
                             str(pid_file)], cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        pids = [int(x) for x in pid_file.read_text().split()]
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        proc.send_signal(signal.SIGKILL)
        proc.wait(10)
        assert _gone(pids)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_a_taken_port_fails_the_run_before_any_node(tmp_path, monkeypatch):
    import socket

    held = socket.socket()
    held.bind(("127.0.0.1", 0))
    port = held.getsockname()[1]
    try:
        assert R.taken([port]) == [port]
        monkeypatch.setattr(R, "port_block", lambda count, rng: [port] + [0] * (count - 1))
        monkeypatch.setenv("TMPDIR", str(tmp_path))
        cell = R.load_cell(ROOT, "local4-steady")
        run = R.Run(cell, 1, 1.0, False, device="cpu")
        with pytest.raises(R.RunError, match="ports taken"):
            run.execute()
        assert run.sup.procs == {}
        assert os.listdir(tmp_path) == []
    finally:
        held.close()
