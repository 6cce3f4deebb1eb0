"""One short run of each cell on the card, started as BENCHMARK.json says: it
exits 0, its result is correct, and no process of it is left.

    python3 -m pytest portbench/tests -q -m card
"""

import json
import os
import subprocess
import sys

import pytest

from portbench.supervisor import descendants

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    WORKLOADS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card(card, workload, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", "2147483999",
         "--seconds", "5", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1300,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["kind"] == card and result["device"]["busy_s"] > 0
    assert "teardown killed 0 process(es)" in out.stderr
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    assert os.listdir(tmp_path) == []
    assert descendants(os.getpid()) == []
