"""The benchmark's readers of each window sample's path (``path.*``), of the
parked headers (``primary.parked_s``) and of the boot's device phases
(``node.boot_device_s``), on synthetic observations: the legs add up to
the middle band's mean total, the committing primary is the one that
committed first, an evicted or out-of-order sample is untraced, and a
program that records none of it reads as nothing."""

import copy
import json
import math
import os

import pytest

from portbench import layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(ROOT, "portbench", "metrics")
T = 1_800_000_000.0
LEGS = ("seal", "quorum", "header", "certify", "to_consensus", "cadence", "commit")
# seconds of each leg but the cadence, which grows with the sample's index
FIXED = {"seal": 0.10, "quorum": 0.005, "header": 0.15, "certify": 0.02,
         "to_consensus": 0.01, "commit": 0.003}


def read(metric, obs):
    return layers.reader(METRICS, metric)(obs)


def _leg_seconds(k):
    legs = dict(FIXED, cadence=0.5 + 0.002 * k)
    if k % 25 == 0:
        legs["cadence"] += 15.0  # a paused sample, far in the tail
    return legs


def _obs(n=200, workers=4):
    """``n`` window samples over ``workers`` authorities, a batch each;
    primary 2 commits every batch first, 5 ms before the others."""
    obs = layers.Observations(window=(T, T + 20))
    final = {f"{r}-{i}": {"gauges": {"metrics.trace_evictions": 0}, "trace": {}}
             for i in range(workers) for r in ("worker", "primary")}
    for k in range(n):
        w, burst = k % workers, 1000 + k
        due = T + 0.05 * k
        obs.samples.append((w, burst, due, due + 0.001))
        legs = _leg_seconds(k)
        t = {"due": due}
        for name, stage in zip(LEGS, ("seal", "quorum", "header", "cert", "cert_inserted",
                                      "commit_trigger", "commit")):
            t[stage] = t[list(t)[-1]] + legs[name]
        digest = f"d{k:04d}"
        final[f"worker-{w}"]["trace"][digest] = {
            "seal": t["seal"], "quorum": t["quorum"], "bytes": 500_000, "txs": 976,
            "samples": [(w << 32) | burst, 7 << 40]}
        final[f"primary-{w}"]["trace"][digest] = {
            "digest_at_primary": t["quorum"] + 0.001, "header": t["header"], "cert": t["cert"]}
        for i in range(workers):
            late = 0.0 if i == 2 else 0.005 + 0.001 * i
            e = final[f"primary-{i}"]["trace"].setdefault(digest, {})
            e.update(cert_inserted=t["cert_inserted"] + late,
                     commit_trigger=t["commit_trigger"] + late,
                     walk_done=t["commit"] - 0.001 + late, commit=t["commit"] + late)
    obs.final = final
    return obs


def _band_means(obs):
    """Each leg's mean over the samples whose total lies between the 25th
    and 75th nearest-rank percentiles, from the stamps as made."""
    rows = [_leg_seconds(k) for k in range(len(obs.samples))]
    totals = sorted(sum(r.values()) for r in rows)
    lo = totals[math.ceil(0.25 * len(totals)) - 1]
    hi = totals[math.ceil(0.75 * len(totals)) - 1]
    band = [r for r in rows if lo <= sum(r.values()) <= hi]
    return {leg: 1000.0 * sum(r[leg] for r in band) / len(band) for leg in LEGS}


@pytest.mark.parametrize("leg", LEGS)
def test_each_leg_is_its_middle_band_mean(leg):
    assert read(f"path.{leg}_ms", _obs()) == pytest.approx(_band_means(_obs())[leg], abs=2e-3)


def test_the_legs_add_up_to_the_band_mean_total_and_skip_the_tail():
    obs = _obs()
    legs = {leg: read(f"path.{leg}_ms", obs) for leg in LEGS}
    totals = sorted(1000.0 * sum(_leg_seconds(k).values()) for k in range(200))
    band = [t for t in totals if totals[49] <= t <= totals[149]]
    assert sum(legs.values()) == pytest.approx(sum(band) / len(band), abs=2e-3)
    assert sum(legs.values()) < 2000.0  # the 15 s pauses lie outside the band
    assert read("path.traced_pct", obs) == 100.0


def test_the_committing_primary_is_the_one_that_committed_first():
    obs = _obs()
    assert read("path.to_consensus_ms", obs) == pytest.approx(10.0, abs=2e-3)
    # Primary 0 now commits sample 0's batch first, 50 ms after its
    # insertion: the sample's consensus legs are read from primary 0.
    e = obs.final["primary-0"]["trace"]["d0000"]
    first = obs.final["primary-2"]["trace"]["d0000"]["commit"] - 0.001
    e.update(cert_inserted=first - 0.05, commit_trigger=first - 0.002, walk_done=first - 0.001,
             commit=first)
    from portbench.metrics import path_join

    path = path_join.paths(obs)[0]
    assert path["commit"] == first and path["cert_inserted"] == first - 0.05


def test_evicted_out_of_order_and_uncommitted_samples_are_untraced():
    obs = _obs()
    # Primary 3 evicted entries, and lacks sample 1's batch: its commit of
    # it may have been the first, so the sample is untraced.
    obs.final["primary-3"]["gauges"]["metrics.trace_evictions"] = 5
    del obs.final["primary-3"]["trace"]["d0001"]
    # Sample 2's quorum stamp lies before its seal.
    w2 = obs.final["worker-2"]["trace"]["d0002"]
    w2["quorum"] = w2["seal"] - 0.001
    # Sample 3's batch never committed anywhere.
    for i in range(4):
        obs.final[f"primary-{i}"]["trace"]["d0003"].pop("commit")
    # Sample 4's batch is not in its worker's table.
    del obs.final["worker-0"]["trace"]["d0004"]
    assert read("path.traced_pct", obs) == pytest.approx(100.0 * 196 / 200)
    # A primary that lacks a batch without evicting anything changes
    # nothing: sample 5 is read from the other primaries.
    clean = _obs()
    del clean.final["primary-3"]["trace"]["d0005"]
    assert read("path.traced_pct", clean) == 100.0


def test_under_a_hundred_traced_samples_the_legs_read_nothing():
    obs = _obs(n=120)
    for k in range(21):
        obs.final[f"worker-{k % 4}"]["trace"][f"d{k:04d}"].pop("quorum")
    assert all(read(f"path.{leg}_ms", obs) is None for leg in LEGS)
    assert read("path.traced_pct", obs) == pytest.approx(100.0 * 99 / 120)
    obs = _obs(n=120)
    for k in range(20):
        obs.final[f"worker-{k % 4}"]["trace"][f"d{k:04d}"].pop("quorum")
    assert read("path.seal_ms", obs) is not None


def test_a_program_without_sample_ids_reads_nothing():
    obs = _obs()
    for i in range(4):
        for e in obs.final[f"worker-{i}"]["trace"].values():
            del e["samples"]
    for metric in [f"path.{leg}_ms" for leg in LEGS] + ["path.traced_pct"]:
        assert read(metric, obs) is None
    assert read("path.traced_pct", layers.Observations(window=(T, T + 20))) is None


def _snap(ts, hists):
    return {"ts": ts, "counters": {}, "gauges": {},
            "histograms": {k: {"count": c, "sum": s} for k, (c, s) in hists.items()}}


def test_parked_seconds_over_the_window():
    name = "primary.header_waiter.parked_seconds"
    obs = layers.Observations(window=(T, T + 20))
    obs.snapshots = {
        "primary-0": (_snap(T, {name: (2, 1.5)}), _snap(T + 20, {name: (5, 18.25)})),
        "primary-1": (_snap(T, {name: (0, 0.0)}), _snap(T + 20, {name: (1, 0.25)})),
        "worker-0": (_snap(T, {}), _snap(T + 20, {})),
    }
    assert read("primary.parked_s", obs) == pytest.approx(17.0)
    for n in ("primary-0", "primary-1"):
        obs.snapshots[n] = (_snap(T, {name: (0, 0.0)}), _snap(T + 20, {name: (0, 0.0)}))
    assert read("primary.parked_s", obs) == 0.0
    obs.snapshots = {n: (_snap(T, {}), _snap(T + 20, {})) for n in ("primary-0", "worker-0")}
    assert read("primary.parked_s", obs) is None


def test_boot_device_seconds_is_the_largest_primary_sum():
    obs = layers.Observations(window=(T, T + 20))
    phases = dict(zip(("library", "cuda_context", "verify_warmup", "consensus_warmup",
                       "store"), (1.5, 0.75, 2.0, 0.5, 9.0)))
    gauges = {f"node.boot.{k}_seconds": v for k, v in phases.items()}
    obs.final = {"primary-0": {"gauges": gauges},
                 "primary-1": {"gauges": dict(gauges, **{"node.boot.library_seconds": 3.0})},
                 "worker-0": {"gauges": {"node.boot.library_seconds": 50.0}}}
    assert read("node.boot_device_s", obs) == pytest.approx(6.25)  # the store is not on the card
    obs.final = {"primary-0": {"gauges": {}}, "worker-0": {"gauges": {}}}
    assert read("node.boot_device_s", obs) is None


def test_every_per_layer_metric_has_a_reader_that_reads_nothing_of_an_empty_run():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    empty = layers.Observations(window=(T, T + 20))
    for m in bench["per_layer"]:
        assert read(m["name"], copy.deepcopy(empty)) is None, m["name"]
