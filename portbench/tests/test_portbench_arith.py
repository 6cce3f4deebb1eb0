"""The benchmark's arithmetic on synthetic logs and snapshots."""

import math
import os

import pytest

from portbench import layers, measure

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stamp(t):
    import datetime

    return datetime.datetime.fromtimestamp(t).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


def _logs(tmp_path, worker_lines, primary_lines):
    w, p = tmp_path / "worker-0.log", tmp_path / "primary-0.log"
    w.write_text("".join(f"{_stamp(t)} INFO narwhal.worker {m}\n" for t, m in worker_lines))
    p.write_text("".join(f"{_stamp(t)} INFO narwhal.consensus {m}\n" for t, m in primary_lines))
    join = measure.Join([str(w)], [str(p)])
    join.update()
    return join


T = 1_800_000_000.0


def test_latency_runs_from_the_due_time_and_lost_samples_fail(tmp_path):
    join = _logs(tmp_path,
                 [(T + 0.1, "Batch AAAA contains sample tx 1"),
                  (T + 0.1, "Batch AAAA contains sample tx 2"),
                  (T + 0.1, "Batch AAAA contains 1024 B"),
                  (T + 0.3, "Batch BBBB contains sample tx 3"),
                  (T + 0.3, "Batch BBBB contains 512 B")],
                 [(T + 0.9, "Committed B4(hhhh) -> AAAA")])
    due = {1: T + 0.0, 2: T + 0.05, 3: T + 0.2, 4: T + 0.25}
    lat = measure.latencies_ms(due, join)
    assert lat[:2] == pytest.approx([900.0, 850.0], abs=1.01)  # log stamps are whole ms
    assert math.isinf(lat[2]) and math.isinf(lat[3])
    e2e = measure.end_to_end(due, join, (T, T + 1), 512)
    assert e2e["attempted"] == 4 and e2e["failed"] == 2
    assert math.isinf(e2e["latency_p95_ms"])
    # over every sample, the lost ones last: the median is the slower of
    # the two committed
    assert e2e["latency_p50_ms"] == pytest.approx(900.0, abs=1.01)
    assert join.pending(due) == 2
    assert measure.thirds_ms(due, join, (T, T + 0.3))[0] == pytest.approx(850.0, abs=1.01)


def test_committed_tps_counts_batches_first_committed_inside_the_window(tmp_path):
    join = _logs(tmp_path,
                 [(T, "Batch AAAA contains 5120 B"), (T, "Batch BBBB contains 2560 B"),
                  (T, "Batch CCCC contains 512 B")],
                 [(T + 0.5, "Committed B2(h1) -> AAAA"),
                  (T + 1.5, "Committed B2(h1) -> AAAA"),  # a later primary: not first
                  (T + 1.2, "Committed B4(h2) -> BBBB"),
                  (T + 2.5, "Committed B6(h3) -> CCCC")])
    assert measure.committed_txs(join, (T + 1, T + 2), 512) == 5
    assert measure.committed_txs(join, (T, T + 2), 512) == 15


def test_percentile_is_nearest_rank_over_every_value():
    xs = list(range(1, 101))
    assert measure.percentile(xs, 50) == 50
    assert measure.percentile(xs, 95) == 95
    assert measure.percentile(xs, 99) == 99
    assert measure.percentile([5.0], 95) == 5.0
    assert measure.percentile([1.0, math.inf], 50) == 1.0
    assert math.isinf(measure.percentile([1.0, math.inf], 95))


def test_a_lost_sample_sorts_last_in_the_all_request_median(tmp_path):
    join = _logs(tmp_path,
                 [(T + 0.1, f"Batch AAAA contains sample tx {i}") for i in range(3)]
                 + [(T + 0.1, "Batch AAAA contains 1536 B")],
                 [(T + 0.5, "Committed B4(hhhh) -> AAAA")])
    due = {i: T + 0.1 * i for i in range(6)}  # 3, 4, 5 never committed
    e2e = measure.end_to_end(due, join, (T, T + 1), 512)
    assert e2e["failed"] == 3
    assert e2e["latency_p50_ms"] == pytest.approx(500.0, abs=1.01)  # 300, 400, 500, lost x 3
    due[6] = T + 0.6  # a fourth lost: more than half
    assert math.isinf(measure.end_to_end(due, join, (T, T + 1), 512)["latency_p50_ms"])


def test_the_95th_percentile_is_over_every_sample_and_a_lost_one_is_inf(tmp_path):
    join = _logs(tmp_path,
                 [(T + 0.1, f"Batch AAAA contains sample tx {i}") for i in range(19)]
                 + [(T + 0.1, "Batch AAAA contains 9728 B")],
                 [(T + 2.0, "Committed B4(hhhh) -> AAAA")])
    due = {i: T + 0.01 * i for i in range(20)}  # sample 19 never committed
    e2e = measure.end_to_end(due, join, (T, T + 3), 512)
    assert e2e["failed"] == 1
    # rank 19 of 20: the slowest committed sample, due first
    assert e2e["latency_p95_ms"] == pytest.approx(2000.0, abs=1.01)
    assert e2e["latency_p50_ms"] == pytest.approx(1910.0, abs=1.01)
    due[20] = T + 0.2  # a second lost sample: rank 20 of 21 is lost
    assert math.isinf(measure.end_to_end(due, join, (T, T + 3), 512)["latency_p95_ms"])


def test_knee_is_the_highest_rate_below_the_first_that_falls_behind():
    rows = [(2000, 1800, [500, 510, 505]),  # 10 % lost at any load
            (2000, 1700, [500, 505, 510]),
            (4000, 3400, [520, 530, 540]),
            (4000, 3300, [520, 530, 540]),  # 83.75 % on average: keeps up
            (6000, 4500, [600, 610, 620]),  # 75 %: falls behind
            (8000, 7000, [700, 700, 700])]  # keeps up, but above a failure
    assert measure.keeps_up(rows[2:4], 0.875)
    assert not measure.keeps_up(rows[4:5], 0.875)
    assert not measure.keeps_up([(4000, 3560, [520, 530, 600])], 0.875)  # backlog grows
    assert measure.knee(rows) == 4000
    assert measure.knee([(2000, 1800, [500, 600, 700])]) is None


@pytest.mark.parametrize("cell", ["committee10-steady", "local4-steady"])
def test_a_traffic_file_holds_only_what_the_harness_reads(cell):
    import copy
    import json

    from portbench import run as R

    with open(os.path.join(HERE, "traffic", cell + ".json")) as f:
        traffic = json.load(f)
    R.check_traffic(cell, traffic)
    for change in ({"kind": "on_off"}, {"on_s": 2}, {"samples_per_burst": 2}):
        with pytest.raises(R.RunError):
            R.check_traffic(cell, dict(copy.deepcopy(traffic), **change))
    with pytest.raises(R.RunError):
        R.check_traffic(cell, {k: v for k, v in traffic.items() if k != "bursts_per_s"})


def test_disk_reckoning():
    # committee10: 10 workers store every batch, 5.12 MB a second per 1,000 tx/s
    assert measure.disk_bytes(10, 1000, 512, 1) == 5_120_000
    assert measure.disk_bytes(4, 1000, 512, 1) == 2_048_000
    assert measure.disk_bytes(10, 10_000, 512, 40) == pytest.approx(2.048e9)


def _snap(ts, counters=None, hists=None, top=None):
    return {"ts": ts, "counters": counters or {},
            "histograms": {k: {"count": c, "sum": s} for k, (c, s) in (hists or {}).items()},
            "gauges": {"profile.hz": 50.0}, "detail": {"profile.top": top or []}}


def _obs():
    obs = layers.Observations(window=(T, T + 10))
    obs.samples = [(0, k, T + k / 20, T + k / 20 + (0.001 if k % 50 else 0.050))
                   for k in range(200)]
    obs.boot_s = {"primary-0": 14.0, "primary-1": 16.5, "worker-0": 3.0}
    obs.snapshots = {
        "primary-0": (_snap(T, {"crypto.verify.ops.batch_burst": 100, "crypto.verify.ops.vote": 0},
                            {"primary.round_advance_seconds": (10, 1.2),
                             "crypto.verify.device_seconds.batch_burst": (10, 0.05),
                             "crypto.verify.kernel_seconds": (10, 0.004),
                             "consensus.cert_to_commit_seconds": (5, 2.0)}),
                      _snap(T + 10, {"crypto.verify.ops.batch_burst": 2100, "crypto.verify.ops.vote": 48},
                            {"primary.round_advance_seconds": (110, 14.2),
                             "crypto.verify.device_seconds.batch_burst": (110, 0.65),
                             "crypto.verify.kernel_seconds": (110, 0.054),
                             "consensus.cert_to_commit_seconds": (105, 82.0)})),
        "worker-0": (_snap(T, hists={"worker.quorum_latency_seconds": (0, 0.0)}),
                     _snap(T + 10, hists={"worker.quorum_latency_seconds": (100, 0.5)})),
    }
    obs.lost = {"unproposed": 0, "uncertified": 2, "uncited": 20, "cited": 10}
    obs.nvml = [(T - 1, 0.0, 1000.0)] + [(T + i * 0.2, 20.0 if i % 2 else 30.0, 2000.0)
                                         for i in range(50)] + [(T + 11, 90.0, 3000.0)]
    return obs


@pytest.mark.parametrize("metric, want", [
    ("loadgen.late_ms_p99", 50.0),
    ("node.boot_s", 16.5),
    ("worker.quorum_ms", 5.0),
    ("primary.round_ms", 130.0),
    ("verify.ms_per_burst", 6.0),
    ("consensus.cert_to_commit_ms", 800.0),
    ("kernel.verify_roofline_pct",
     100.0 * 2048 * layers.MADS_PER_VERIFY / layers.INT32_MADS_PER_S / 0.05),
    ("device.idle_pct", 75.0),
    ("primary.orphaned_pct", 15.0),
])
def test_each_reader(metric, want):
    read = layers.reader(os.path.join(HERE, "metrics"), metric)
    assert read(_obs()) == pytest.approx(want, rel=1e-6)
    assert read(layers.Observations(window=(T, T + 10))) is None


def test_roofline_operations_per_verify_are_frozen():
    assert layers.MADS_PER_VERIFY == 323_590
    assert layers.INT32_MADS_PER_S == pytest.approx(16.72704e12)
