"""The port's invariant linter (``narwhal_tpu_torch/analysis/{linter,
rules,interleave,__main__}.py``) on the port's tree, on the CPU.

- The cases of ``tests/test_analysis.py`` run again on the port
  (:func:`tests.test_torch_tasks.mirror`): fixture snippets injected as
  overlay modules under ``narwhal_tpu_torch/``, the live tree clean,
  seeded mutations of the port's copied modules, the pragmas, and the
  CLI.  The consumer-file mutation plants its probe in ``chip_smoke.py``,
  the port's consumer of metric names, where the reference plants it in
  ``benchmark/metrics_check.py``.
- The linter's scope is the port: it parses ``narwhal_tpu_torch/``,
  ``chip_smoke.py`` and ``window_ab.py``, reads ``README.md`` and
  ``tests/`` as text, and never opens a file of ``narwhal_tpu/`` or
  ``benchmark/``.
- The two packages' README env-var tables live in one README, each
  between its own markers."""

import os

import narwhal_tpu.utils.env as jenv
import narwhal_tpu_torch.analysis.linter as tlinter
import narwhal_tpu_torch.utils.env as tenv
from narwhal_tpu_torch.analysis import load_project, run_lint
from tests.test_torch_tasks import mirror

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIRRORED = mirror(
    globals(), "test_analysis",
    subs=(('    path = "benchmark/metrics_check.py"\n',
           '    path = "chip_smoke.py"\n'),),
)


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED) == 25


def test_scope_is_the_port_alone(monkeypatch):
    opened = []
    real_open = open

    def spy(path, *args, **kwargs):
        opened.append(os.path.relpath(path, ROOT))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(tlinter, "open", spy, raising=False)
    project = load_project(ROOT)
    assert opened and not any(
        p.startswith(("narwhal_tpu/", "benchmark/")) for p in opened), opened
    assert {"chip_smoke.py", "window_ab.py"} <= set(project.files)
    assert all(rel.startswith("narwhal_tpu_torch/")
               or rel in ("chip_smoke.py", "window_ab.py")
               for rel in project.files), sorted(project.files)
    assert all(rel == "README.md" or rel.startswith("tests/")
               for rel in project.texts), sorted(project.texts)


def test_a_finding_in_the_reference_tree_is_not_the_ports():
    # A violation planted in the reference package is out of scope (and
    # so is one in benchmark/): only the port's files are linted.
    src = "import time\n\n\nasync def stall():\n    time.sleep(1)\n"
    overlay = {"narwhal_tpu/_planted.py": src, "benchmark/_planted.py": src}
    assert run_lint(ROOT, overlay=overlay) == []
    found = run_lint(ROOT, overlay={"narwhal_tpu_torch/_planted.py": src})
    assert [f.rule for f in found] == ["no-blocking-in-async"]


def test_each_package_reads_its_own_readme_table():
    readme = open(os.path.join(ROOT, "README.md")).read()
    pairs = ((tenv.TABLE_BEGIN, tenv.TABLE_END),
             (jenv.TABLE_BEGIN, jenv.TABLE_END))
    for (begin, end), (other_begin, other_end) in (pairs, pairs[::-1]):
        assert readme.count(begin) == 1 and readme.count(end) == 1
        for mine in (begin, end):
            for theirs in (other_begin, other_end):
                assert mine not in theirs and theirs not in mine
    for env in (tenv, jenv):
        section = readme.split(env.TABLE_BEGIN, 1)[1].split(env.TABLE_END, 1)[0]
        assert section.strip() == env.render_table().strip()
    # The port's table lists exactly the port's registry.
    port_section = readme.split(tenv.TABLE_BEGIN, 1)[1].split(tenv.TABLE_END, 1)[0]
    listed = {line.split("`")[1] for line in port_section.splitlines()
              if line.startswith("| `")}
    assert listed == set(tenv.REGISTRY)


def test_cli_lints_another_root_and_refuses_a_root_without_the_port(
        tmp_path, capsys):
    from narwhal_tpu_torch.analysis.__main__ import main

    assert main(["--root", str(tmp_path)]) == 2
    assert "does not contain narwhal_tpu_torch/" in capsys.readouterr().err
    assert main(["--root", ROOT]) == 0
