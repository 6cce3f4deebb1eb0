"""The harness's crash faults, without a process: which authorities a
configuration's ``faults`` crashes, what the run starts and offers load
to, and that ``faults: 0`` starts exactly what the harness always started.

``_body`` runs on a recording supervisor that starts nothing; the run
stops where it would wait for the load generator's start file.
"""

import base64
import copy
import json
import os
import sys

import pytest

from portbench import run as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = {"local4-steady": 4, "committee10-steady": 10}


class _Supervisor:
    """Records each start in order; starts nothing."""

    def __init__(self):
        self.starts = []

    def start(self, name, argv, log_path, env=None, cwd=None):
        self.starts.append((name, argv))


class _AtLoadgenStart(Exception):
    pass


def _cell(name, faults=None):
    cell = copy.deepcopy(R.load_cell(ROOT, name))
    if faults is not None:
        cell.config["faults"] = faults
    return cell


def _launch(tmp_path, monkeypatch, cell, trace=False, rate=None):
    """(run, recorded starts, the boot lines waited for, the load plan,
    committee.json) of ``_body`` on the card's path in a built checkout."""
    run = R.Run(cell, 2**31 + 77, 20.0, trace, rate=rate)
    run.sup, run.workdir, run.built = _Supervisor(), str(tmp_path), True
    waited = {}
    monkeypatch.setattr(run, "_wait_boot", lambda want: waited.update(want) or {})

    def at_start(path, owner, limit):
        raise _AtLoadgenStart

    monkeypatch.setattr(run, "_wait_file", at_start)
    with pytest.raises(_AtLoadgenStart):
        run._body()
    with open(tmp_path / "loadgen-plan.json") as f:
        plan = json.load(f)
    with open(tmp_path / "committee.json") as f:
        committee = json.load(f)["authorities"]
    return run, run.sup.starts, waited, plan, committee


def _b64(key):
    return base64.b64encode(key).decode()


def _parent_starts(wd, n, trace):
    """The processes the harness started before it knew of faults, with
    their arguments, in order (a built checkout, the card's path)."""
    node = [sys.executable, "-m", R.PACKAGE + ".node"]
    out = [("sampler", ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu,memory.used",
                        "--format=csv,noheader,nounits", "--loop-ms=200"])]
    for i in range(n):
        for role in ("primary", "worker"):
            args = ["run", "--keys", f"{wd}/key-{i}.json", "--committee", f"{wd}/committee.json",
                    "--parameters", f"{wd}/parameters.json", "--store", f"{wd}/db-{role}-{i}",
                    "--benchmark"]
            if trace:
                args += ["--metrics-path", f"{wd}/metrics-{role}-{i}.json"]
            if role == "primary":
                args += ["--crypto-backend", "cuda", "--experimental-consensus-kernel", "primary"]
            else:
                args += ["worker", "--id", "0"]
            out.append((f"{role}-{i}", node + args))
    return out + [("loadgen", [sys.executable, "-m", "portbench.loadgen",
                               f"{wd}/loadgen-plan.json"])]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_no_faults_starts_what_the_harness_always_started(name, trace, tmp_path, monkeypatch):
    cell = _cell(name)
    assert cell.config["faults"] == 0
    n, rate = CELLS[name], cell.traffic["rate_tx_s"]
    run, starts, waited, plan, committee = _launch(tmp_path, monkeypatch, cell, trace)
    assert run.crashed == [] and run.live == list(range(n))
    assert starts == _parent_starts(str(tmp_path), n, trace)
    assert waited == {**{f"primary-{i}": R.CARD_PRIMARY_BOOT for i in range(n)},
                      **{f"worker-{i}": (R.BOOTED,) for i in range(n)}}
    assert plan == dict(
        targets=[committee[_b64(k)]["workers"]["0"]["transactions"] for k in run.keys],
        rate=rate // n, bursts_per_s=20, tx_size=512, seed=2**31 + 77, warmup_s=15,
        window_s=20.0, drain_cap_s=8, start=f"{tmp_path}/loadgen-start.json",
        records=f"{tmp_path}/samples.npy")
    assert run.notes["crashed"] == []


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("faults", [0, 1, 2, 3])
def test_the_crashed_are_the_first_keys_in_sorted_order(name, faults):
    keys = R.public_keys(_cell(name).config)
    if faults > (len(keys) - 1) // 3:
        with pytest.raises(R.RunError, match="tolerates"):
            R.crashed(keys, faults)
        return
    got = R.crashed(keys, faults)
    assert sorted(keys[i] for i in got) == sorted(keys)[:faults]
    assert got == sorted(got)


def test_the_crashed_authority_of_committee10_leads_every_tenth_round(tmp_path):
    from narwhal_tpu_torch.config import Committee
    from narwhal_tpu_torch.consensus.tusk import Tusk

    cfg = _cell("committee10-steady", faults=1).config
    R.write_deployment(str(tmp_path), cfg, list(range(20000, 20050)))
    keys = R.public_keys(cfg)
    [dead] = R.crashed(keys, 1)
    tusk = Tusk(Committee.load(str(tmp_path / "committee.json")), gc_depth=50)
    leads = [r for r in range(0, 200, 2) if tusk._leader_name(r) == keys[dead]]
    assert leads == list(range(0, 200, 10))


@pytest.mark.parametrize("name, faults", [("committee10-steady", 4),
                                          ("committee10-steady", -1),
                                          ("local4-steady", 2)])
def test_more_faults_than_f_are_refused_before_any_start(name, faults, monkeypatch):
    def no_supervisor():
        raise AssertionError("a supervisor was made")

    monkeypatch.setattr(R, "Supervisor", no_supervisor)
    with pytest.raises(R.RunError, match="tolerates"):
        R.Run(_cell(name, faults), 1, 1.0, False, device="cpu").execute()


def test_the_whole_bursts_check_counts_live_workers():
    cell = _cell("committee10-steady", faults=1)
    assert R.Run(cell, 1, 1.0, False, rate=9000).per_worker == 1000
    with pytest.raises(R.RunError, match="whole bursts"):
        R.Run(cell, 1, 1.0, False)  # the steady cell's 10,000 tx/s over 9 workers
    assert R.per_worker_rate(10_000, 20, 10) == 1000
    assert R.per_worker_rate(300, 20, 3) == 100
    with pytest.raises(R.RunError, match="whole bursts"):
        R.per_worker_rate(320, 20, 3)


def test_a_crash_starts_only_the_live_and_keeps_the_whole_committee(tmp_path, monkeypatch):
    cell = _cell("committee10-steady", faults=1)
    run, starts, waited, plan, committee = _launch(tmp_path, monkeypatch, cell, rate=9000)
    [dead] = run.crashed
    assert sorted(run.keys).index(run.keys[dead]) == 0
    assert run.notes["crashed"] == [{"authority": dead, "sorted_position": 0}]
    live = [i for i in range(10) if i != dead]
    assert run.live == live and run.workers == 9
    assert [name for name, _ in starts] == (
        ["sampler"] + [f"{r}-{i}" for i in live for r in ("primary", "worker")] + ["loadgen"])
    assert set(waited) == {f"{r}-{i}" for i in live for r in ("primary", "worker")}
    assert not any(f"key-{dead}.json" in " ".join(argv) for _, argv in starts)
    # every authority stays in the committee, with its stake and addresses
    assert sorted(committee) == sorted(_b64(k) for k in run.keys)
    assert {a["stake"] for a in committee.values()} == {1}
    assert plan["rate"] == 1000
    assert plan["targets"] == [committee[_b64(run.keys[i])]["workers"]["0"]["transactions"]
                               for i in live]
    dead_ports = {int(a.rsplit(":", 1)[1])
                  for a in [*committee[_b64(run.keys[dead])]["primary"].values(),
                            *committee[_b64(run.keys[dead])]["workers"]["0"].values()]}
    assert len(dead_ports) == 5 and R.taken(sorted(dead_ports)) == []
