"""The port's own rules: it imports neither JAX nor the JAX package, its
entry points never quietly fall back to the CPU, and chip_smoke.py refuses
to run without a card or outside a checkout."""

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
    assert count >= 25, out.stdout


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
