"""Nothing the benchmark runs loads JAX, the JAX package or its benchmark
folder, and the plain reference loads nothing of the port either.  Names
are compared by their whole top-level part: the port's name begins with
the JAX package's."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PB = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "narwhal_tpu", "benchmark"}


def _modules(sub=""):
    out = []
    for dirpath, _, files in os.walk(os.path.join(PB, sub)):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), ROOT))
    return sorted(out)


def _loaded_tops(paths):
    """Top-level names in sys.modules after loading each file in a fresh
    interpreter (by path, so reader files with dots in their names load)."""
    code = (
        "import importlib.util, json, sys\n"
        "for i, p in enumerate(sys.argv[1:]):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'portbench.' + p[len('portbench/'):-3].replace('/', '.') if '.' not in p[:-3] else f'm{i}', p)\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    sys.modules[spec.name] = m\n"
        "    spec.loader.exec_module(m)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, *paths], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_benchmark_module_loads_jax_or_the_jax_package():
    assert _loaded_tops(_modules()) & FORBIDDEN == set()


def test_the_reference_loads_nothing_of_the_port():
    tops = _loaded_tops(_modules("reference"))
    assert tops & (FORBIDDEN | {"narwhal_tpu_torch"}) == set()


def test_whole_names_are_compared(monkeypatch):
    import types

    from portbench.run import FORBIDDEN as harness_forbidden, forbidden_modules

    assert set(harness_forbidden) == FORBIDDEN
    clean = {k: v for k, v in sys.modules.items() if k.split(".")[0] not in FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(clean))
    sys.modules["narwhal_tpu_torch.ops"] = types.ModuleType("narwhal_tpu_torch.ops")
    sys.modules["benchmark_client"] = types.ModuleType("benchmark_client")
    assert forbidden_modules() == []
    sys.modules["narwhal_tpu.ops"] = types.ModuleType("narwhal_tpu.ops")
    assert forbidden_modules() == ["narwhal_tpu"]


def _benchmark_paths(tree):
    """String constants (docstrings aside) that name a path under
    ``benchmark/``, and path joins with a ``"benchmark"`` part."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            s = node.value.replace("\\", "/")
            if s.startswith("benchmark/") or "/benchmark/" in s:
                yield s
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and any(isinstance(a, ast.Constant) and a.value == "benchmark" for a in node.args)):
            yield ast.unparse(node)


def test_the_scan_finds_a_read_of_the_folder():
    tree = ast.parse('open("benchmark/logs.py")\nos.path.join(root, "benchmark", "x")\n')
    assert len(list(_benchmark_paths(tree))) == 2


# This file names the folder in order to look for it.
@pytest.mark.parametrize("path", [m for m in _modules() if not m.endswith("test_portbench_imports.py")])
def test_no_file_reads_the_jax_benchmark_folder(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    assert list(_benchmark_paths(tree)) == [], path
