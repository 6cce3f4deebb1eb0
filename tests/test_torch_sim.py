"""The port's simulator (``sim/*``) and schedule explorer
(``analysis/schedule.py``) on the CPU.

- The same scenario at the same seed in both packages, each in a
  subprocess of its own (the sim installs process globals: sim-MAC
  signing, the network seam, the wire committee): the artifacts'
  ``deterministic_blob`` must be the same bytes (tolerance 0), apart from
  ``generated_by``, which names the package that ran.  The commit
  sequences and the verdicts are compared on their own as well.
- A port sim run launches no kernel: the sim runs the plain Tusk rules
  on the host, as the reference's does.
- Then the cases of ``tests/test_sim.py`` and ``tests/test_schedule.py``
  run again on the port, with their harness helpers
  (``benchmark/race_explore.py``, ``benchmark/sim_bench.py``) as port
  copies; the race explorer's static mutation arm lints the port's
  ``consensus/tusk.py`` with the port's linter."""

import json
import os
import subprocess
import sys

import pytest

from tests.test_torch_tasks import mirror, port_benchmark

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The harness helpers the reference tests import, pointed at the port
# (the race explorer lints with the port's linter).
RACE = port_benchmark("race_explore")
SIM_BENCH = port_benchmark("sim_bench")

MIRRORED_SIM = mirror(
    globals(), "test_sim",
    subs=(("from benchmark.race_explore import", f"from {RACE} import"),
          ("from benchmark.sim_bench import", f"from {SIM_BENCH} import")),
)
MIRRORED_SCHEDULE = mirror(
    globals(), "test_schedule",
    subs=(("from benchmark.race_explore import", f"from {RACE} import"),),
)


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED_SIM) == 14
    assert len(MIRRORED_SCHEDULE) == 7


def test_race_explorer_plants_its_race_in_the_ports_tusk():
    # The static half of the explorer's mutation arm: its overlay is the
    # port's consensus/tusk.py, linted by the port's linter, and the
    # interleave-window rule flags the planted window there alone.
    import importlib

    findings = importlib.import_module(RACE).static_mutation_findings()
    assert findings and any("_committing" in f for f in findings), findings
    assert all(f.startswith("narwhal_tpu_torch/consensus/tusk.py:")
               for f in findings), findings


# -- the sim across packages --------------------------------------------------

_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from {pkg}.faults.spec import parse_scenario
from {pkg}.sim.committee import deterministic_blob, run_sim_scenario
from {pkg} import metrics
art = run_sim_scenario(parse_scenario(json.loads({spec!r}), env={{}}), {seed},
                       {workdir!r})
launches = {{k: c.value for k, c in metrics.registry().counters.items()
            if k.startswith("kernel.")}}
with open({out!r}, "wb") as f:
    f.write(deterministic_blob(art))
print(json.dumps({{"launches": launches}}))
"""

# A clean 4-node committee (test_sim.py's) and the fault suite's
# published equivocation plan.
with open(os.path.join(ROOT, "benchmark", "scenarios", "byz_equivocate.json")) as _f:
    SPECS = {
        "clean": {"name": "sim_t_clean", "nodes": 4, "workers": 1, "rate": 400,
                  "tx_size": 256, "duration": 15, "seed": 5},
        "byz_equivocate": json.load(_f),
    }
# The artifact field that names the package that ran the sim.
PACKAGE_FIELD = "generated_by"


def _sim(pkg: str, spec: dict, seed: int, tmp_path) -> tuple:
    out = tmp_path / f"{pkg}.blob"
    code = _RUN.format(root=ROOT, pkg=pkg, spec=json.dumps(spec), seed=seed,
                       workdir=str(tmp_path / pkg), out=str(out))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_bytes()), json.loads(run.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_sim_artifacts_are_the_same_bytes_in_both_packages(tmp_path, name):
    want, _ = _sim("narwhal_tpu", SPECS[name], 17, tmp_path)
    got, extra = _sim("narwhal_tpu_torch", SPECS[name], 17, tmp_path)
    assert want.pop(PACKAGE_FIELD) == "narwhal_tpu/sim"
    assert got.pop(PACKAGE_FIELD) == "narwhal_tpu_torch/sim"
    assert got["commit_sequences"] == want["commit_sequences"]
    assert got["verdicts"] == want["verdicts"]
    blob = lambda a: json.dumps(a, sort_keys=True, separators=(",", ":")).encode()
    assert blob(got) == blob(want)
    assert want["ok"] and any(want["commit_sequences"].values())
    if name == "byz_equivocate":
        assert "equivocation" in want["verdicts"]["detection"]["fired"]
    # The sim takes no device: no kernel launched in the port's run.
    assert not any(extra["launches"].values()), extra
