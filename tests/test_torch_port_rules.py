"""The port's own rules: it imports neither JAX nor the JAX package, its
host modules stay line-for-line copies of the reference's, its entry
points never quietly fall back to the CPU, and chip_smoke.py refuses to
run without a card or outside a checkout."""

import ast
import asyncio
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "narwhal_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "window_ab.py")


def test_no_jax_or_reference_imports_in_the_source():
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "narwhal_tpu"), (path, mod)


def test_importing_every_module_loads_neither_jax_nor_reference():
    code = f"""
import pkgutil, sys
sys.path.insert(0, {ROOT!r})
import narwhal_tpu_torch
for m in pkgutil.walk_packages(narwhal_tpu_torch.__path__, "narwhal_tpu_torch."):
    __import__(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "narwhal_tpu"))
print("BAD", bad)
print("COUNT", sum(n.startswith("narwhal_tpu_torch") for n in sys.modules))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd="/")
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    count = int(out.stdout.split("COUNT")[1].split()[0])
    assert count >= 49, out.stdout


# The host modules that cross as copies: each must equal its reference
# file line for line, apart from its import statements and the edits
# named in COPY_EDITS.
COPIES = (
    "config", "messages", "store",
    "consensus/__init__",
    "crypto/digest", "crypto/service",
    "faults/__init__", "faults/netem", "faults/spec",
    "network/__init__", "network/clocksync", "network/framing",
    "network/receiver", "network/reliable_sender", "network/simple_sender",
    "network/transport",
    "primary/__init__", "primary/aggregators", "primary/certificate_waiter",
    "primary/core", "primary/errors", "primary/garbage_collector",
    "primary/header_waiter", "primary/helper", "primary/messages",
    "primary/payload_receiver", "primary/primary", "primary/proposer",
    "primary/synchronizer",
    "utils/__init__", "utils/clock", "utils/serde", "utils/tasks",
)

# (reference text, port text): a Byzantine fault plan needs
# faults/byzantine.py, which the port does not have yet.
COPY_EDITS = {
    "primary/primary": ((
        "            from ..faults.byzantine import ByzantineCore, ByzantineProposer\n"
        "\n"
        "            proposer_cls, core_cls = ByzantineProposer, ByzantineCore\n"
        "            extra = (fault_plan,)\n"
    ), (
        "            for receiver in self.receivers:\n"
        "                await receiver.shutdown()\n"
        "            raise NotImplementedError(\n"
        "                \"Byzantine primaries need faults/byzantine.py, which the \"\n"
        "                \"port does not have yet\"\n"
        "            )\n"
    )),
}


def _without_imports(src: str) -> str:
    """``src`` without the lines of its import statements."""
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return "".join(line for i, line in enumerate(src.splitlines(True), 1)
                   if i not in drop)


@pytest.mark.parametrize("module", COPIES)
def test_copied_modules_match_their_reference(module):
    ref = open(os.path.join(ROOT, "narwhal_tpu", module + ".py")).read()
    port = open(os.path.join(PKG, module + ".py")).read()
    if module in COPY_EDITS:
        old, new = COPY_EDITS[module]
        assert ref.count(old) == 1 and port.count(new) == 1, module
        ref = ref.replace(old, new)
    assert _without_imports(port) == _without_imports(ref), module


# The modules this slice brought across: each, imported alone in a fresh
# interpreter, loads neither JAX nor the reference package.
SLICE_MODULES = (
    "metrics", "utils.env", "utils.tasks", "crypto.service", "crypto", "store",
    "network.transport", "network.clocksync", "faults.spec", "faults.netem",
    "faults", "network.receiver", "network.simple_sender",
    "network.reliable_sender", "network",
    "primary.synchronizer", "primary.aggregators", "primary.core",
    "primary.helper", "primary.garbage_collector", "primary.header_waiter",
    "primary.certificate_waiter", "primary.payload_receiver",
    "primary.proposer", "primary.primary", "primary",
)


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_alone_loads_neither_jax_nor_reference(module):
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import narwhal_tpu_torch.{module}
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "narwhal_tpu"))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd="/")
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_byzantine_fault_plan_is_refused_until_ported():
    from narwhal_tpu_torch.config import Committee, Parameters
    from narwhal_tpu_torch.crypto import KeyPair
    from narwhal_tpu_torch.primary import Primary
    from narwhal_tpu_torch.store import Store

    from tests.common import committee

    class Plan:
        def primary_behaviors(self):
            return {"equivocate"}

    c = Committee.from_json(committee(base_port=26040).to_json())
    store = Store()

    async def go():
        with pytest.raises(NotImplementedError, match="faults/byzantine.py"):
            await Primary.spawn(
                KeyPair.generate(bytes([0]) * 32), c, Parameters(), store,
                asyncio.Queue(), asyncio.Queue(), fault_plan=Plan())

    asyncio.run(go())
    store.close()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card refusals cannot be shown")


def test_entry_points_raise_without_a_card(no_card):
    from narwhal_tpu_torch.commit_step import entry
    from narwhal_tpu_torch.consensus import Consensus
    from narwhal_tpu_torch.convert import window_from_numpy
    from narwhal_tpu_torch.crypto import backend as cb
    from narwhal_tpu_torch.ops import ed25519 as E
    from narwhal_tpu_torch.ops import resolve_device
    from narwhal_tpu_torch.config import Committee
    from narwhal_tpu_torch.ops.reachability import KernelTusk

    from tests.common import committee

    c = Committee.from_json(committee().to_json())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.verify_batch_arrays([bytes(32)], [bytes(32)], [bytes(64)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelTusk(c, 50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Consensus(c, 50, asyncio.Queue(), asyncio.Queue(), asyncio.Queue(),
                  use_kernel=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        window_from_numpy([[0]], [[[0]]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    arrays = E.prepare_batch([bytes(32)], [bytes(32)], [bytes(64)], 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.verify_sharded(arrays, ["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.verify_sharded(arrays, ["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="failed to build or load"):
        cb.set_backend("cuda", strict=True)
    assert cb.get_backend().name == "cpu"
    # The explicit downgrade: strict off logs and selects cpu.
    cb.set_backend("cuda", strict=False)
    assert cb.get_backend().name == "cpu"
    # device="cpu" is the caller's own choice, and runs the plain twin.
    assert resolve_device("cpu").type == "cpu"


def test_kernel_rule_stays_classic_only():
    from narwhal_tpu_torch.consensus import Consensus
    from narwhal_tpu_torch.config import Committee

    from tests.common import committee

    c = Committee.from_json(committee().to_json())
    with pytest.raises(ValueError, match="classic walk only"):
        Consensus(c, 50, asyncio.Queue(), asyncio.Queue(), asyncio.Queue(),
                  use_kernel=True, device="cpu", commit_rule="lowdepth")


def test_chip_smoke_refuses_without_card_or_checkout(no_card, tmp_path):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=240, cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, timeout=240, cwd=str(alone))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_window_ab_refuses_without_card(no_card, tmp_path):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "window_ab.py"), ROOT],
                         capture_output=True, text=True, timeout=240, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
