"""Run one benchmark cell once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run:

1. checks for the card (``torch.cuda``) and the port's package, reads the
   cell's ``configs/<config>.json`` and ``traffic/<cell>.json``;
2. picks free loopback ports (a run whose ports are taken fails here,
   before any node starts) and a fresh work directory under ``TMPDIR``;
3. writes the committee's key files from the configuration's fixed salt,
   its committee and parameters: every authority, the crashed ones too,
   so every node counts all ``n`` and a quorum is 2f+1 of the whole
   stake;
4. through :class:`~portbench.supervisor.Supervisor`: the card's sampler
   (``nvidia-smi``), on the first run of a checkout only the port's
   ``node prewarm`` (builds the kernel library into
   ``build/narwhal_tpu_torch``, so that the primaries load it and do not
   race to build it), a primary (``--crypto-backend cuda
   --experimental-consensus-kernel``) and a worker for each live
   authority, each ``--benchmark`` and, traced, ``--metrics-path``; then
   the load generator once every live node has logged its boot lines,
   the rate split evenly over the live workers.  The configuration's
   ``faults`` authorities are crashed from the start (``crashed``): the
   first ``faults`` in sorted public-key order, which is Tusk's leader
   order, so a crash always takes out a leader (at ``faults`` 1 the dead
   authority leads each even round r with r mod n = 0: every tenth round
   in a committee of 10).  Their processes never start and their ports
   stay unbound, as for a machine that is down; the run's notes name
   them.  Every later step (the join, the snapshots, the judge's stores
   and logs) reads only the live nodes;
5. ``setup_s`` ends at the window's first due send; after the window the
   load goes on until every sample due in the window has committed (at
   most the traffic's ``drain_cap_s``);
6. teardown, on every path: the load generator, then the nodes on
   SIGTERM with a grace, then every descendant left is SIGKILLed and
   reaped until a walk of ``/proc`` finds none;
7. judges the run (``reference/judge.py``), removes the work directory,
   and prints the numbers compared as the last lines of stderr and the
   result as the last line of stdout.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import base64  # noqa: E402
import glob  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import layers, measure  # noqa: E402
from .reference import ed25519  # noqa: E402
from .reference import judge as judge_mod  # noqa: E402
from .supervisor import Interrupted, Supervisor, descendants, signals_raise  # noqa: E402

PACKAGE = "narwhal_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "narwhal_tpu", "benchmark")
BOOTED = "successfully booted"
CARD_PRIMARY_BOOT = ("Verify backend cuda ready", "Consensus kernel ready", BOOTED)
CPU_PRIMARY_BOOT = ("Consensus kernel ready", BOOTED)
DEADLINE_S = 330.0  # a run's own limit, inside the 360 s a run is allowed
BUILD_DEADLINE_S = 1140.0  # the first run of a checkout builds the kernels
PREWARM_S = 900.0
BOOT_S = 120.0
NODE_GRACE_S = 30.0
LOADGEN_GRACE_S = 15.0
SAMPLER_MS = 200
# A traffic file's kinds and keys (``check_traffic``).
TRAFFIC_KINDS = ("open_loop",)
TRAFFIC_KEYS = {"kind", "rate_tx_s", "bursts_per_s", "warmup_s", "drain_cap_s"}


class RunError(Exception):
    """The run cannot give a result."""


@dataclass
class Cell:
    root: str
    name: str
    config: dict
    traffic: dict
    per_layer: List[str]
    end_to_end: List[dict]
    units: Dict[str, str]
    chips: int = 1


def load_cell(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, config["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(here, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    check_traffic(w["traffic"], traffic)
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(root, workload, cfg, traffic, per_layer, e2e, units, w["chips"])


def check_traffic(name: str, traffic: dict) -> None:
    """Refuses a mix of another kind than the generator runs, or with keys
    it does not read, rather than run it as the steady mix."""
    if traffic.get("kind") not in TRAFFIC_KINDS:
        raise RunError(f"traffic {name!r}: kind {traffic.get('kind')!r} is not one of "
                       f"{TRAFFIC_KINDS}")
    if set(traffic) != TRAFFIC_KEYS:
        raise RunError(f"traffic {name!r}: keys {sorted(set(traffic) ^ TRAFFIC_KEYS)} "
                       f"unknown or missing")


# ----------------------------------------------------------- the deployment


def port_block(count: int, rng: random.Random, tries: int = 64) -> List[int]:
    """``count`` consecutive loopback ports, free now, below the kernel's
    ephemeral range (so no outgoing connection takes one meanwhile)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            ephemeral = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        ephemeral = 32768
    for _ in range(tries):
        base = rng.randrange(10000, ephemeral - count)
        ports = list(range(base, base + count))
        if not taken(ports):
            return ports
    raise RunError(f"no block of {count} free ports found")


def taken(ports: List[int]) -> List[int]:
    """The ports of ``ports`` that 127.0.0.1 cannot bind now."""
    out = []
    for p in ports:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind(("127.0.0.1", p))
        except OSError:
            out.append(p)
        finally:
            s.close()
    return out


def key_seed(salt: str, i: int) -> bytes:
    return hashlib.sha256(f"portbench/{salt}/{i}".encode()).digest()


def public_keys(cfg: dict) -> List[bytes]:
    """The committee's public keys in authority order, from the
    configuration's fixed salt."""
    return [ed25519.public_key(key_seed(cfg["key_salt"], i))
            for i in range(cfg["authorities"])]


def crashed(keys: List[bytes], faults: int) -> List[int]:
    """The authorities that never boot: the first ``faults`` in sorted
    public-key order, which is Tusk's leader order (an even round r's
    leader is ``sorted(keys)[r % n]``), so a crash always takes out a
    leader.  Refuses more than f = (n - 1) // 3, which leaves no quorum."""
    f = (len(keys) - 1) // 3
    if not 0 <= faults <= f:
        raise RunError(f"faults {faults}: a committee of {len(keys)} tolerates 0 to {f}")
    return sorted(sorted(range(len(keys)), key=keys.__getitem__)[:faults])


def per_worker_rate(rate: int, bursts_per_s: int, workers: int) -> int:
    """The rate each of ``workers`` live workers is offered: ``rate``
    split evenly, in whole bursts on every one."""
    if rate % (bursts_per_s * workers):
        raise RunError(f"rate {rate} is not {bursts_per_s} whole bursts a second "
                       f"on every live worker")
    return rate // workers


def write_deployment(workdir: str, cfg: dict, ports: List[int]) -> None:
    """Key files, ``committee.json`` and ``parameters.json`` in
    ``workdir``, for every authority, crashed or not."""
    b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
    authorities = {}
    for i, pub in enumerate(public_keys(cfg)):
        with open(os.path.join(workdir, f"key-{i}.json"), "w") as f:
            json.dump({"name": b64(pub), "secret": b64(key_seed(cfg["key_salt"], i))}, f)
        a = [f"127.0.0.1:{p}" for p in ports[5 * i:5 * i + 5]]
        authorities[b64(pub)] = {
            "stake": cfg["stake"],
            "primary": {"primary_to_primary": a[0], "worker_to_primary": a[1]},
            "workers": {"0": {"transactions": a[2], "worker_to_worker": a[3],
                              "primary_to_worker": a[4]}},
        }
    with open(os.path.join(workdir, "committee.json"), "w") as f:
        json.dump({"authorities": authorities}, f, indent=1)
    with open(os.path.join(workdir, "parameters.json"), "w") as f:
        json.dump(cfg["parameters"], f, indent=1)


def child_env(root: str) -> dict:
    """The nodes' environment: the checkout on the path, every build and
    kernel cache at a fixed directory inside the checkout, no JAX."""
    env = dict(os.environ)
    build = os.path.join(root, "build")
    env.update(
        PYTHONPATH=root,
        TORCH_EXTENSIONS_DIR=os.path.join(build, "torch_extensions"),
        TRITON_CACHE_DIR=os.path.join(build, "triton"),
        CUDA_CACHE_PATH=os.path.join(build, "cuda_cache"),
        USE_FLAX="0",
        USE_JAX="0",
        PYTHONUNBUFFERED="1",
    )
    return env


# ----------------------------------------------------------------- the run


@dataclass
class Outcome:
    result: dict
    checks: Dict[str, int]
    limits: Dict[str, int]
    notes: Dict[str, object] = field(default_factory=dict)
    controls: Dict[str, Dict[str, int]] = field(default_factory=dict)


class Run:
    """One run of one cell.  ``device`` "cpu" runs the nodes' plain twins
    and skips the card (the CPU tests); ``node_module`` is the module run
    as the node CLI (the tests put a faulted wrapper there)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: Optional[str] = None, node_module: str = PACKAGE + ".node",
                 rate: Optional[int] = None, controls=()) -> None:
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.node_module, self.controls = device, node_module, controls
        self.rate = rate if rate is not None else cell.traffic["rate_tx_s"]
        self.cfg = cell.config
        self.n = self.cfg["authorities"]
        self.bursts = cell.traffic["bursts_per_s"]
        self.keys = public_keys(self.cfg)
        self.crashed = crashed(self.keys, self.cfg["faults"])
        self.live = [i for i in range(self.n) if i not in self.crashed]
        self.workers = len(self.live) * self.cfg["workers_per_authority"]
        self.per_worker = per_worker_rate(self.rate, self.bursts, self.workers)
        self.sup: Optional[Supervisor] = None
        self.workdir: Optional[str] = None
        order = sorted(self.keys)
        self.notes: Dict[str, object] = {"crashed": [
            {"authority": i, "sorted_position": order.index(self.keys[i])}
            for i in self.crashed]}

    def say(self, msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    def path(self, *parts) -> str:
        return os.path.join(self.workdir, *parts)

    def node(self, *args) -> List[str]:
        return [sys.executable, "-m", self.node_module, *args]

    def run_args(self, i: int, role) -> List[str]:
        store = f"db-primary-{i}" if role == "primary" else f"db-worker-{i}"
        args = ["run", "--keys", self.path(f"key-{i}.json"),
                "--committee", self.path("committee.json"),
                "--parameters", self.path("parameters.json"),
                "--store", self.path(store), "--benchmark"]
        if self.trace:
            args += ["--metrics-path", self.path(f"metrics-{role}-{i}.json")]
        if role == "primary":
            args += ["--crypto-backend", "cpu" if self.device == "cpu" else "cuda",
                     "--experimental-consensus-kernel"]
            if self.device == "cpu":
                args += ["--device", "cpu"]
            return self.node(*args, "primary")
        return self.node(*args, "worker", "--id", "0")

    # -- the steps --------------------------------------------------------

    def execute(self) -> Outcome:
        root = self.cell.root
        if not os.path.isfile(os.path.join(root, PACKAGE, "node", "__main__.py")):
            raise RunError(f"{PACKAGE} is not in {root}")
        self.built = bool(glob.glob(os.path.join(root, "build", PACKAGE, "*.so")))
        deadline = DEADLINE_S if (self.built or self.device == "cpu") else BUILD_DEADLINE_S
        outcome = None
        try:
            with signals_raise(deadline):
                self.sup = Supervisor()
                self.workdir = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR") or None)
                outcome = self._body()
        except Interrupted as e:
            self.say(f"interrupted by {e}")
        finally:
            self._teardown(outcome is None)
        if outcome is None:
            raise RunError("the run did not reach its end")
        return self._finish(outcome)

    def _body(self):
        sup, env = self.sup, child_env(self.cell.root)
        rng = random.Random(int.from_bytes(os.urandom(8), "little"))
        ports = port_block(5 * self.n, rng)
        busy = taken(ports)
        if busy:
            raise RunError(f"ports taken: {busy}")
        write_deployment(self.workdir, self.cfg, ports)
        if self.device != "cpu":
            sup.start("sampler", ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu,memory.used",
                                  "--format=csv,noheader,nounits", f"--loop-ms={SAMPLER_MS}"],
                      self.path("sampler.log"), env=env)
        # The first run of a checkout builds the kernel library, so that the
        # primaries load it and do not race to build it; each primary warms
        # its own shapes as it boots.
        if self.device != "cpu" and not self.built:
            prewarm = ["prewarm", "--committee", self.path("committee.json"), "--skip-verify"]
            t = time.time()
            code = sup.start("prewarm", self.node(*prewarm), self.path("prewarm.log"),
                             env=env, cwd=self.cell.root).wait(PREWARM_S)
            self.notes["prewarm_s"] = time.time() - t
            if code != 0:
                raise RunError(f"prewarm exited {code}: {self._tail('prewarm')}")
            busy = taken(ports)
            if busy:
                raise RunError(f"ports taken before the nodes started: {busy}")
        boot = CPU_PRIMARY_BOOT if self.device == "cpu" else CARD_PRIMARY_BOOT
        want = {}
        for i in self.live:
            sup.start(f"primary-{i}", self.run_args(i, "primary"),
                      self.path(f"primary-{i}.log"), env=env, cwd=self.cell.root)
            sup.start(f"worker-{i}", self.run_args(i, "worker"),
                      self.path(f"worker-{i}.log"), env=env, cwd=self.cell.root)
            want[f"primary-{i}"], want[f"worker-{i}"] = boot, (BOOTED,)
        boot_s = self._wait_boot(want)

        plan = dict(
            targets=[f"127.0.0.1:{ports[5 * i + 2]}" for i in self.live],
            rate=self.per_worker, bursts_per_s=self.bursts, tx_size=self.cfg["tx_size"],
            seed=self.seed,
            warmup_s=self.cell.traffic["warmup_s"], window_s=self.seconds,
            drain_cap_s=self.cell.traffic["drain_cap_s"],
            start=self.path("loadgen-start.json"), records=self.path("samples.npy"))
        with open(self.path("loadgen-plan.json"), "w") as f:
            json.dump(plan, f)
        sup.start("loadgen", [sys.executable, "-m", "portbench.loadgen",
                              self.path("loadgen-plan.json")],
                  self.path("loadgen.log"), env=env, cwd=self.cell.root)
        start = self._wait_file(plan["start"], "loadgen", 60.0)
        window = tuple(start["window"])
        due = {}
        for w, phase in enumerate(start["phases"]):
            k = max(0, math.ceil((window[0] - start["t0"] - phase) * self.bursts))
            while start["t0"] + phase + k / self.bursts < window[1]:
                due[(w << 32) | k] = start["t0"] + phase + k / self.bursts
                k += 1

        join = measure.Join([self.path(f"worker-{i}.log") for i in self.live],
                            [self.path(f"primary-{i}.log") for i in self.live])
        snaps0 = self._snapshots_at(window[0]) if self.trace else {}
        snaps1 = self._snapshots_at(window[1]) if self.trace else {}
        self._sleep_until(window[1], ("loadgen",))
        # The drain: the load goes on until every sample due in the window
        # has committed, at most drain_cap_s.
        cap = window[1] + self.cell.traffic["drain_cap_s"]
        while True:
            join.update()
            if join.pending(due) == 0 or time.time() >= cap:
                break
            self._sleep_until(min(cap, time.time() + 0.5), ("loadgen",))
        self.notes["drain_s"] = time.time() - window[1]
        codes = sup.stop(["loadgen"], signal.SIGTERM, LOADGEN_GRACE_S)
        self.notes["load_s"] = time.time() - start["t0"]
        if codes["loadgen"] != 0:
            raise RunError(f"load generator exited {codes['loadgen']}: {self._tail('loadgen')}")
        t = time.time()
        nodes = [f"{r}-{i}" for i in self.live for r in ("primary", "worker")]
        codes = sup.stop(nodes, signal.SIGTERM, NODE_GRACE_S)
        self.notes["node_stop_s"] = time.time() - t
        join.update()
        return dict(window=window, due=due, join=join, codes=codes, boot_s=boot_s,
                    setup_s=window[0] - T_START, snaps=(snaps0, snaps1))

    def _teardown(self, failed: bool) -> None:
        sup = self.sup
        if sup is None:
            return
        if failed:
            sup.stop([n for n in sup.procs if n == "loadgen"], signal.SIGTERM, 5.0)
            sup.stop([n for n in sup.procs if n.startswith(("primary", "worker", "prewarm"))],
                     signal.SIGTERM, 10.0)
        sup.stop([n for n in sup.procs if n == "sampler"], signal.SIGTERM, 5.0)
        killed = sup.reap_all()
        self.say(f"teardown killed {killed} process(es) still running")
        self.notes["killed"] = killed
        if failed and self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)

    # -- waiting ----------------------------------------------------------

    def _tail(self, name: str, n: int = 1500) -> str:
        try:
            with open(self.sup.logs[name], errors="replace") as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def _check_alive(self, names) -> None:
        for n in names:
            code = self.sup.procs[n].poll()
            if code is not None:
                raise RunError(f"{n} exited {code}: {self._tail(n)}")

    def _sleep_until(self, t: float, watch=()) -> None:
        nodes = [n for n in self.sup.procs if n.startswith(("primary", "worker"))]
        while True:
            left = t - time.time()
            if left <= 0:
                return
            self._check_alive(list(watch) + nodes)
            time.sleep(min(left, 0.25))

    def _wait_boot(self, want: Dict[str, tuple]) -> Dict[str, float]:
        end = time.monotonic() + BOOT_S
        boot_s: Dict[str, float] = {}
        while len(boot_s) < len(want):
            if time.monotonic() > end:
                missing = sorted(set(want) - set(boot_s))
                raise RunError(f"nodes not booted in {BOOT_S} s: {missing}")
            for name, lines in want.items():
                if name in boot_s:
                    continue
                with open(self.sup.logs[name], errors="replace") as f:
                    text = f.read()
                if all(x in text for x in lines):
                    last = max(text.index(x) for x in lines)
                    stamp = text.rfind("\n", 0, last) + 1
                    boot_s[name] = (judge_mod.log_time(text[stamp:stamp + 23])
                                    - self.sup.started[name])
            self._check_alive(want)
            time.sleep(0.1)
        return boot_s

    def _wait_file(self, path: str, owner: str, limit: float) -> dict:
        end = time.monotonic() + limit
        while not os.path.exists(path):
            if time.monotonic() > end:
                raise RunError(f"{owner} wrote no {os.path.basename(path)}")
            self._check_alive([owner])
            time.sleep(0.05)
        with open(path) as f:
            return json.load(f)

    def _read_snapshots(self) -> Dict[str, dict]:
        out = {}
        for i in self.live:
            for role in ("primary", "worker"):
                try:
                    with open(self.path(f"metrics-{role}-{i}.json")) as f:
                        out[f"{role}-{i}"] = json.load(f)
                except (OSError, ValueError):
                    pass
        return out

    def _snapshots_at(self, t: float) -> Dict[str, dict]:
        """Each node's first snapshot taken at ``t`` or later."""
        self._sleep_until(t, ("loadgen",))
        got: Dict[str, dict] = {}
        end = t + 5.0
        while len(got) < 2 * len(self.live) and time.time() < end:
            for name, snap in self._read_snapshots().items():
                if name not in got and snap.get("ts", 0) >= t:
                    got[name] = snap
            time.sleep(0.1)
        return got

    # -- the result -------------------------------------------------------

    def _finish(self, raw: dict) -> Outcome:
        cfg, join, window = self.cfg, raw["join"], raw["window"]
        try:
            e2e = measure.end_to_end(raw["due"], join, window, cfg["tx_size"])
            records = np.load(self.path("samples.npy"))
            obs = layers.Observations(window=window, boot_s=raw["boot_s"])
            obs.samples = [tuple(r) for r in records.tolist() if window[0] <= r[2] < window[1]]
            s0, s1 = raw["snaps"]
            obs.snapshots = {n: (s0[n], s1[n]) for n in s0 if n in s1}
            obs.final = self._read_snapshots()
            obs.nvml = self._nvml()
            files = judge_mod.RunFiles(
                keys=self.keys, gc_depth=cfg["parameters"]["gc_depth"],
                tx_size=cfg["tx_size"], seed=self.seed,
                primary_stores=[self.path(f"db-primary-{i}", "store.log") for i in self.live],
                primary_logs=[self.path(f"primary-{i}.log") for i in self.live],
                worker_stores=[self.path(f"db-worker-{i}", "store.log") for i in self.live],
                worker_logs=[self.path(f"worker-{i}.log") for i in self.live],
                exit_codes=raw["codes"], window=window, window_samples=sorted(raw["due"]),
                committed_txs=e2e["committed_txs"])
            self.notes["bytes_written"] = measure.tree_bytes(self.workdir)
            self.notes["bytes_reckoned"] = measure.disk_bytes(
                self.workers, self.rate, cfg["tx_size"], self.notes["load_s"])
            self.say(f"wrote {self.notes['bytes_written']} bytes in the work directory "
                     f"(batches reckoned: {self.notes['bytes_reckoned']:.0f})")
            t = time.time()
            lost: Dict[str, int] = {}
            checks = judge_mod.judge(files, diag=lost)
            self.notes["lost"] = obs.lost = lost
            controls = {c: judge_mod.judge(files, control=c) for c in self.controls}
            self.notes["judge_s"] = time.time() - t
        finally:
            shutil.rmtree(self.workdir, ignore_errors=True)
        left = descendants(os.getpid())
        if left:
            raise RunError(f"processes still below the harness: {left}")
        correct = judge_mod.verdict(checks)
        metrics = {}
        if self.trace:
            here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "metrics")
            for name in self.cell.per_layer:
                value = layers.finite(layers.reader(here, name)(obs))
                if value is not None:
                    metrics[name] = {"value": value, "unit": self.cell.units[name]}
        else:
            values = dict(e2e, setup_s=raw["setup_s"])
            for m in self.cell.end_to_end:
                v = values[m["name"]]
                if not math.isfinite(v):
                    correct = False  # a tail that holds uncommitted samples
                    continue
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {"correct": correct, "attempted": e2e["attempted"], "failed": e2e["failed"],
                  "metrics": metrics, "device": self._device(obs)}
        if self.trace:
            result["breakdown"] = breakdown(obs)
        self.notes.update(committed_tps=e2e["committed_tps"], offered=self.rate,
                          latency_p50_ms=e2e["latency_p50_ms"],
                          latency_p95_ms=e2e["latency_p95_ms"],
                          setup_s=raw["setup_s"],
                          thirds_ms=measure.thirds_ms(raw["due"], join, window),
                          lost_at_s=[round(t - window[0], 2) for sid, t in sorted(raw["due"].items())
                                     if join.commit_time(sid) is None][:40],
                          node_boot_s=max(raw["boot_s"].values()))
        return Outcome(result, checks, dict(judge_mod.LIMITS), self.notes, controls)

    def _nvml(self):
        rows = []
        try:
            with open(self.path("sampler.log")) as f:
                for line in f:
                    parts = [p.strip() for p in line.split(",")]
                    try:
                        import datetime
                        t = datetime.datetime.strptime(
                            parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                        rows.append((t, float(parts[1]), float(parts[2])))
                    except (ValueError, IndexError):
                        continue
        except OSError:
            pass
        return rows

    def _device(self, obs) -> dict:
        if self.device == "cpu":
            return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
               "memory_peak_bytes": int(max((m for _, _, m in obs.nvml), default=0)
                                        * 1024 * 1024)}
        if self.trace:
            rows = obs.window_nvml()
            span = obs.window[1] - obs.window[0]
            dev["window_s"] = span
            dev["busy_s"] = (sum(u for _, u, _ in rows) / len(rows) / 100.0 * span
                             if rows else 0.0)
        return dev


def breakdown(obs: layers.Observations) -> dict:
    """The verify kernel's time by events over the window (the only
    kernel a node times), and the primaries' busiest host frames from
    their sampling profilers (``profile.top``, seconds of samples)."""
    ops = []
    count, seconds = obs.hist("primary", "crypto.verify.kernel_seconds")
    if count:
        ops.append(["ed25519_verify", seconds])
    frames: Dict[str, float] = {}
    for name, snap in obs.final.items():
        if not name.startswith("primary"):
            continue
        hz = snap.get("gauges", {}).get("profile.hz") or 67.0
        for row in (snap.get("detail", {}).get("profile.top") or []):
            frames[row["frame"]] = frames.get(row["frame"], 0.0) + row["self"] / hz
    gaps = sorted(frames.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": ops[:10], "idle_gaps": [[k, v] for k, v in gaps]}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device is available")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} card(s), {torch.cuda.device_count()} present")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=int, default=None,
                   help="offer this many tx/s in place of the cell's rate (the knee sweep)")
    p.add_argument("--control", action="append", default=[], choices=["quorum"],
                   help="also judge the run as the named control and print its readings")
    args = p.parse_args(argv)
    root = os.getcwd()
    try:
        cell = load_cell(root, args.workload)
        check_card(cell.chips)
        run = Run(cell, args.seed, args.seconds, bool(args.trace), rate=args.rate,
                  controls=tuple(args.control))
        outcome = run.execute()
    except (RunError, OSError, ValueError, KeyError) as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"portbench: no result: modules loaded: {bad}", file=sys.stderr)
        return 1
    report(outcome)
    return 0


def report(outcome: Outcome) -> None:
    notes = {k: v for k, v in outcome.notes.items()}
    print("portbench: notes " + json.dumps(notes, default=float), file=sys.stderr)
    checks = {k: {"value": v, "limit": outcome.limits[k]} for k, v in outcome.checks.items()}
    for k, v in outcome.controls.items():
        print(f"portbench: control {k} " + json.dumps(v), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(outcome.result, checks=checks)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
