"""Framework of the invariant linter: file loading, pragmas, findings.

The linter is codebase-specific by design — each rule in ``rules.py``
encodes an invariant that a past PR rediscovered the hard way (blocking
work on the primary's event loop, silently-GC'd tasks, drifting string
registries).  This module owns everything rule-agnostic:

- **Project loading.**  Python files under ``narwhal_tpu_torch/``
  and the port's harness scripts (``chip_smoke.py``, ``window_ab.py``)
  are parsed to ASTs (never the reference package or ``benchmark/``);
  ``README.md`` and ``tests/*.py`` ride along as raw text for the
  cross-registry rules (env-table drift, declared-but-unread
  detection).  An ``overlay`` maps relative paths to replacement
  sources, which is how the test suite proves each rule fires: mutate
  one file in memory, re-run, assert the finding — no tree copying.

- **Pragmas.**  ``# lint: allow-<rule>(reason)`` on any line a flagged
  node spans suppresses that rule's finding there.  The reason is
  mandatory: an empty one is itself a finding, and so is a pragma name
  no rule owns (a typo'd pragma that silently suppressed nothing would
  be worse than no pragma at all).

- **Findings.**  Plain (rule, path, line, message) records, sorted for
  stable output; the CLI renders them human-readable and as a JSON
  report for the CI artifact.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional

PRAGMA_RE = re.compile(r"#\s*lint:\s*allow-([a-z][a-z0-9-]*)\(([^)]*)\)")

# Parsed-Python scope (AST rules) and raw-text scope (registry rules).
PY_DIRS = ("narwhal_tpu_torch", "chip_smoke.py", "window_ab.py")
TEXT_GLOBS = (
    "README.md",
    "tests",
)


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return asdict(self)


class SourceFile:
    """One parsed Python source: AST plus the per-line pragma map."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self.syntax_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(text)
        except SyntaxError as e:
            self.tree = None
            self.syntax_error = e
        # line -> {pragma-name: reason}
        self.pragmas: Dict[int, Dict[str, str]] = {}
        for lineno, line in enumerate(text.splitlines(), 1):
            for m in PRAGMA_RE.finditer(line):
                self.pragmas.setdefault(lineno, {})[m.group(1)] = (
                    m.group(2).strip()
                )

    def pragma_reason(self, name: str, node: ast.AST) -> Optional[str]:
        """The reason of an ``allow-<name>`` pragma on any line the node
        spans, or on the line directly above it (own-line pragmas for
        reasons too long to share the statement's line).  None = no
        pragma; "" = pragma without a reason, which does NOT suppress."""
        first = getattr(node, "lineno", None)
        if first is None:
            return None
        last = getattr(node, "end_lineno", None) or first
        for ln in range(first - 1, last + 1):
            d = self.pragmas.get(ln)
            if d is not None and name in d:
                return d[name]
        return None

    def suppressed(self, pragma_name: str, node: ast.AST) -> bool:
        reason = self.pragma_reason(pragma_name, node)
        return reason is not None and reason != ""


class Project:
    def __init__(self, root: str):
        self.root = root
        self.files: Dict[str, SourceFile] = {}  # rel path -> parsed source
        self.texts: Dict[str, str] = {}  # rel path -> raw text (non-AST scope)

    def file(self, rel: str) -> Optional[SourceFile]:
        return self.files.get(rel)


def _iter_py(root: str, sub: str) -> Iterable[str]:
    base = os.path.join(root, sub)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, fn), root)


def load_project(
    root: str, overlay: Optional[Dict[str, str]] = None
) -> Project:
    """Parse the tree (``overlay`` entries replace on-disk content, or
    add files that don't exist on disk — keys are root-relative)."""
    overlay = dict(overlay or {})
    project = Project(root)

    def read(rel: str) -> str:
        if rel in overlay:
            return overlay.pop(rel)
        with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
            return f.read()

    for sub in PY_DIRS:
        if os.path.isfile(os.path.join(root, sub)):
            project.files[sub] = SourceFile(sub, read(sub))
            continue
        if not os.path.isdir(os.path.join(root, sub)):
            continue
        for rel in _iter_py(root, sub):
            project.files[rel] = SourceFile(rel, read(rel))

    for entry in TEXT_GLOBS:
        full = os.path.join(root, entry)
        if os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    if fn.endswith((".py", ".yml", ".yaml", ".md")):
                        project.texts[rel] = read(rel)
        elif os.path.isfile(full):
            project.texts[entry] = read(entry)

    # Overlay leftovers are new files (mutation tests injecting a module).
    for rel, text in overlay.items():
        if rel.endswith(".py") and rel.startswith(PY_DIRS):
            project.files[rel] = SourceFile(rel, text)
        else:
            project.texts[rel] = text
    return project


def pragma_findings(project: Project, known_pragmas: Iterable[str]) -> List[Finding]:
    """Framework-level checks on the pragmas themselves."""
    known = set(known_pragmas)
    out: List[Finding] = []
    for sf in project.files.values():
        for lineno, entries in sorted(sf.pragmas.items()):
            for name, reason in entries.items():
                if name not in known:
                    out.append(Finding(
                        "pragma", sf.rel, lineno,
                        f"unknown pragma allow-{name} (known: "
                        f"{', '.join(sorted(known))})",
                    ))
                elif not reason:
                    out.append(Finding(
                        "pragma", sf.rel, lineno,
                        f"pragma allow-{name} must carry a reason: "
                        f"# lint: allow-{name}(why this is safe)",
                    ))
    return out


def run_lint(
    root: str, overlay: Optional[Dict[str, str]] = None
) -> List[Finding]:
    """Load the tree and run every rule; the CLI and the test suite both
    enter here."""
    from . import rules  # late import: rules import helpers from here

    project = load_project(root, overlay)
    findings: List[Finding] = []
    for sf in project.files.values():
        if sf.syntax_error is not None:
            findings.append(Finding(
                "syntax", sf.rel, sf.syntax_error.lineno or 0,
                f"syntax error: {sf.syntax_error.msg}",
            ))
    findings.extend(pragma_findings(project, rules.PRAGMA_NAMES))
    for rule_fn in rules.ALL_RULES:
        findings.extend(rule_fn(project))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings
