"""The port's ``utils/tasks.py``, ``crypto/service.py`` and
``metrics.InstrumentedQueue`` against the JAX package's, on the CPU.

Also the home of the helpers the port's node tests share:

- :func:`mirror` runs a reference test module against the port: its
  source with every ``narwhal_tpu`` name pointed at ``narwhal_tpu_torch``
  (``tests.common`` and ``tests.test_*`` imports at port copies made the
  same way, its fixed socket ports moved up by :data:`PORT_SHIFT`), so
  each of its cases runs again on the port under its own name;
- :func:`package_state` saves and restores each package's process
  globals, for tests that run both packages in one process.

Parity is exact everywhere: counters, signatures, bytes."""

import asyncio
import contextlib
import importlib
import importlib.abc
import importlib.util
import logging
import os
import re
import sys

import pytest

import narwhal_tpu.crypto.backend as jbackend
import narwhal_tpu.faults.netem as jnetem
import narwhal_tpu.messages as jmessages
import narwhal_tpu.network.clocksync as jclocksync
import narwhal_tpu.primary.messages as jpmessages
import narwhal_tpu.utils.tasks as jtasks
import narwhal_tpu_torch.crypto.backend as tbackend
import narwhal_tpu_torch.faults.netem as tnetem
import narwhal_tpu_torch.messages as tmessages
import narwhal_tpu_torch.network.clocksync as tclocksync
import narwhal_tpu_torch.primary.messages as tpmessages
import narwhal_tpu_torch.utils.tasks as ttasks
from narwhal_tpu import metrics as jmetrics
from narwhal_tpu.crypto import KeyPair as JKeyPair
from narwhal_tpu.crypto import SignatureService as JSignatureService
from narwhal_tpu.crypto import digest32 as jdigest32
from narwhal_tpu_torch import metrics as tmetrics
from narwhal_tpu_torch.crypto import KeyPair as TKeyPair
from narwhal_tpu_torch.crypto import SignatureService as TSignatureService
from narwhal_tpu_torch.crypto import digest32 as tdigest32

TESTS = os.path.dirname(os.path.abspath(__file__))

# Fixed ports in a mirrored module move up by this much, so the mirror and
# its reference can run at once on different workers.  No test binds a
# port in [20000, 30000) today.
PORT_SHIFT = 10_000
_FIXED_PORT = re.compile(r"(base_port=|127\.0\.0\.1:|port = )(1\d{4})\b")
_REFERENCE = re.compile(r"\bnarwhal_tpu\b")
_TEST_MODULE = re.compile(r"\btests\.(common|test_\w+)\b")


def port_source(src: str, keep=()) -> str:
    """``src`` pointed at the port: ``narwhal_tpu`` → ``narwhal_tpu_torch``
    except inside the names in ``keep``, ``tests.<m>`` → ``tests._port_<m>``,
    fixed ports shifted by :data:`PORT_SHIFT`."""
    for i, name in enumerate(keep):
        src = src.replace(name, f"\0{i}\0")
    src = _REFERENCE.sub("narwhal_tpu_torch", src)
    src = _TEST_MODULE.sub(r"tests._port_\1", src)
    src = _FIXED_PORT.sub(
        lambda m: m.group(1) + str(int(m.group(2)) + PORT_SHIFT), src
    )
    for i, name in enumerate(keep):
        src = src.replace(f"\0{i}\0", name)
    return src


# ``tests._port_bench_<m>`` is the port copy of ``benchmark/<m>.py``: a
# harness helper a reference test drives its package through (a planted
# mutation, a pipeline run), pointed at the port the same way.
BENCH = "bench_"


class _PortModules(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports ``tests._port_<m>`` as the port copy of ``tests/<m>.py``
    (``tests._port_bench_<m>``: of ``benchmark/<m>.py``), so a mirrored
    module's own ``tests.*`` imports resolve to port copies when (and
    only if) they run."""

    PREFIX = "tests._port_"

    def __init__(self) -> None:
        # Per reference module: the (subs, keep) its port copy is made with.
        self.edits: dict = {}

    def find_spec(self, fullname, path, target=None):
        if fullname.startswith(self.PREFIX):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        ref = module.__name__[len(self.PREFIX):]
        subs, keep = self.edits.get(ref, ((), ()))
        path = os.path.join(TESTS, ref + ".py")
        if ref.startswith(BENCH):  # a harness module under benchmark/
            path = os.path.join(os.path.dirname(TESTS), "benchmark",
                                ref[len(BENCH):] + ".py")
        with open(path) as f:
            src = f.read()
        for old, new in subs:
            assert old in src, f"{ref}: {old!r} is gone from the reference"
            src = src.replace(old, new)
        module.__file__ = path
        exec(compile(port_source(src, keep), path, "exec"), module.__dict__)


# One finder per process: this file is imported twice under pytest (as a
# test module and as ``tests.test_torch_tasks``), and both copies must
# register their edits with the finder that imports.
_FINDER = next((f for f in sys.meta_path if type(f).__name__ == "_PortModules"), None)
if _FINDER is None:
    _FINDER = _PortModules()
    sys.meta_path.insert(0, _FINDER)
_EDITS = _FINDER.edits


def port_benchmark(name: str, subs=()) -> str:
    """Register the port copy of ``benchmark/<name>.py`` with the (old,
    new) edits ``subs`` (each must match); returns the module name to
    import it by, for a mirror's ``subs``."""
    if subs:
        _EDITS[BENCH + name] = (tuple(subs), ())
    return _PortModules.PREFIX + BENCH + name


def mirror(namespace: dict, ref: str, skip=(), subs=(), keep=(), only=None) -> list:
    """Put every test and fixture of the reference module ``ref``, run on
    the port, into the test module ``namespace``; ``skip`` names the
    reference tests that are not mirrored (each must exist), or ``only``
    the ones that are (each must exist, as when a reference module's cases
    are split over several port test files), ``subs`` are (old, new)
    edits to the reference source (each must match) and ``keep`` names
    stay the reference's.  Returns the mirrored test names."""
    from _pytest.fixtures import getfixturemarker

    if subs or keep:
        _EDITS[ref] = (tuple(subs), tuple(keep))
    mod = importlib.import_module(_PortModules.PREFIX + ref)
    tests = [k for k in vars(mod) if k.startswith("test_")]
    if only is not None:
        missing = set(only) - set(tests)
        assert not missing, f"{ref}: no such tests {sorted(missing)}"
        skip = [k for k in tests if k not in only]
    missing = set(skip) - set(tests)
    assert not missing, f"{ref}: no such tests {sorted(missing)}"
    names = []
    for k, v in vars(mod).items():
        if k.startswith("test_") and k not in skip:
            assert k not in namespace, f"{ref}: {k} is mirrored twice"
            namespace[k] = v
            names.append(k)
        elif getfixturemarker(v) is not None and k not in namespace:
            namespace[k] = v
    return names


_PACKAGES = (
    (jmessages, jpmessages, jbackend, jnetem, jclocksync, jtasks, jmetrics),
    (tmessages, tpmessages, tbackend, tnetem, tclocksync, ttasks, tmetrics),
)


@contextlib.contextmanager
def package_state():
    """Save each package's process globals, and restore them after: the
    wire committee (``messages.set_wire_committee``), the primary codec's
    decode cache switch, the crypto backend, the installed network
    emulator, the clock-offset estimators and the metrics registry's
    values.  On the way out, every task that either package's ``spawn``
    still holds must be done."""
    saved = [
        (m._WIRE_KEYS, m._WIRE_INDEX, pm._DECODE_CACHE_ON, b._backend,
         n._EMULATOR, n._LOADED, dict(c._ESTIMATORS))
        for m, pm, b, n, c, _, _ in _PACKAGES
    ]
    try:
        yield
    finally:
        for (m, pm, b, n, c, t, reg), s in zip(_PACKAGES, saved):
            m._WIRE_KEYS, m._WIRE_INDEX = s[0], s[1]
            pm._DECODE_CACHE_ON = s[2]
            b._backend = s[3]
            n._EMULATOR, n._LOADED = s[4], s[5]
            c._ESTIMATORS.clear()
            c._ESTIMATORS.update(s[6])
            reg.registry().reset()
            left = [x for x in t._TASKS if not x.done()]
            assert not left, f"{t.__name__}: tasks left running: {left}"


# -- mirrored cases -----------------------------------------------------------

MIRRORED_TASKS = mirror(
    globals(), "test_tasks",
    # The destroyed-task trap is the conftest's, not the package's.
    skip=("test_asyncio_trap_catches_destroyed_pending_message",),
)
MIRRORED_QUEUE = mirror(globals(), "test_metrics_queue")


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED_TASKS) == 7
    assert len(MIRRORED_QUEUE) == 5


# -- parity -------------------------------------------------------------------

def _spawn_deaths(pkg_tasks, pkg_metrics):
    """Spawn one task that finishes, one that raises and one that is
    cancelled; return the alive counts seen and the metrics they left."""
    reg = pkg_metrics.registry()
    reg.reset()
    seen = []

    async def main():
        release = asyncio.Event()

        async def ok():
            await release.wait()

        async def dies():
            raise RuntimeError("stage exploded")

        async def forever():
            await asyncio.Event().wait()

        a = pkg_tasks.spawn(ok(), name="ok")
        b = pkg_tasks.spawn(dies(), name="dies")
        c = pkg_tasks.spawn(forever(), name="forever")
        seen.append(pkg_tasks.alive_count())
        await asyncio.sleep(0)
        seen.append(pkg_tasks.alive_count())
        release.set()
        c.cancel()
        await asyncio.gather(a, b, c, return_exceptions=True)
        await asyncio.sleep(0)
        seen.append(pkg_tasks.alive_count())
        seen.append(reg.gauge_fns["runtime.background_tasks"]())

    asyncio.run(main())
    events = [
        {k: v for k, v in e.items() if k != "t"}
        for e in reg.flight.events
    ]
    return seen, dict(reg.counters), events


def test_spawn_counts_and_flight_events_match(caplog):
    with caplog.at_level(logging.CRITICAL, logger="narwhal.tasks"):
        want = _spawn_deaths(jtasks, jmetrics)
        got = _spawn_deaths(ttasks, tmetrics)
    assert want[0] == got[0] == [3, 3, 0, 0]
    # Counters other tests registered stay in the registry at 0.
    assert {k: c.value for k, c in got[1].items() if c.value} == {
        k: c.value for k, c in want[1].items() if c.value
    }
    assert got[2] == want[2]
    assert [e["kind"] for e in got[2]] == ["task_death", "dump"]


@pytest.mark.parametrize("concurrent", [False, True])
def test_signature_service_signs_byte_identically(concurrent):
    seed = bytes(range(32))
    digests = [bytes([i]) * 32 for i in range(24)]

    async def sign_all(service, digest_of):
        if concurrent:
            return await asyncio.gather(*(
                service.request_signature(digest_of(d), site="vote")
                for d in digests
            ))
        return [await service.request_signature(digest_of(d), site="header")
                for d in digests]

    async def main(kp_cls, svc_cls, digest_cls):
        svc = svc_cls(kp_cls.generate(seed))
        try:
            return [bytes(s) for s in await sign_all(
                svc, lambda d: digest_cls(d))]
        finally:
            svc.close()

    from narwhal_tpu.crypto import Digest as JDigest
    from narwhal_tpu_torch.crypto import Digest as TDigest

    want = asyncio.run(main(JKeyPair, JSignatureService, JDigest))
    got = asyncio.run(main(TKeyPair, TSignatureService, TDigest))
    assert got == want
    assert len(set(got)) == len(digests)
    # The digests a header's id is made of, through each package's hash.
    assert bytes(tdigest32(b"abc")) == bytes(jdigest32(b"abc"))
    kp = TKeyPair.generate(seed)
    assert [bytes(TSignatureService(kp).sign_now(TDigest(d))) for d in digests] == want


def test_instrumented_queue_accounts_as_the_reference():
    def run(pkg_metrics):
        reg = pkg_metrics.Registry(enabled=True)
        old = pkg_metrics._REGISTRY
        pkg_metrics._REGISTRY = reg
        try:
            async def go():
                q = pkg_metrics.InstrumentedQueue(3, channel="parity")
                for i in range(3):
                    q.put_nowait(i)
                with pytest.raises(asyncio.QueueFull):
                    q.put_nowait(3)
                out = [q.get_nowait(), await q.get()]
                await q.put(9)
                return out + [q.qsize()]

            out = asyncio.run(go())
        finally:
            pkg_metrics._REGISTRY = old
        return (
            out,
            {k: c.value for k, c in reg.counters.items()},
            {k: g.value for k, g in reg.gauges.items()},
            {k: h.count for k, h in reg.histograms.items()},
        )

    assert run(tmetrics) == run(jmetrics)
