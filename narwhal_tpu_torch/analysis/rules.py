"""The invariant rules.  Each encodes a bug shape a past PR paid for.

| rule | pragma | invariant |
|---|---|---|
| no-blocking-in-async | allow-blocking | no blocking call shapes inside ``async def`` under narwhal_tpu_torch/ |
| task-retention | allow-unretained-task | no bare ``create_task``/``ensure_future`` statements (use utils.tasks.spawn) |
| wire-type-coverage | allow-wire-type | every sender call labels its frame; labels ⊆ classifier maps ⊆ labels |
| metric-name-drift | allow-metric-name | every metric name a consumer references is actually emitted |
| env-var-registry | allow-env | every NARWHAL_* literal is declared; reads route through utils/env.py; no dead declarations; README table fresh |
| interleave-window | allow-interleave | no self-attr read→yield→write window on state another task root writes (interleave.py) |
| interleave-iteration | allow-interleave | no direct iteration over shared state spanning a yield point (interleave.py) |

Rules are pure functions ``Project -> Iterable[Finding]`` so the test
suite can run them against in-memory mutations.  Suppression is per-node
via ``# lint: allow-<pragma>(reason)`` on any line the node spans.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .linter import Finding, Project, SourceFile

PRAGMA_NAMES = (
    "blocking",
    "unretained-task",
    "wire-type",
    "metric-name",
    "env",
    "interleave",
)


# -- shared AST helpers -------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """'os.environ.get' for an Attribute chain rooted at a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _receiver_name(func: ast.AST) -> Optional[str]:
    """For a method call ``a.b.send(...)``: the identifier the method is
    called ON ('b'); for ``send(...)``: None."""
    if not isinstance(func, ast.Attribute):
        return None
    recv = func.value
    if isinstance(recv, ast.Attribute):
        return recv.attr
    if isinstance(recv, ast.Name):
        return recv.id
    return None


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fstring_prefix(node: ast.JoinedStr) -> str:
    """Leading literal part of an f-string (empty when it starts with a
    formatted field)."""
    prefix = []
    for part in node.values:
        s = _str_const(part)
        if s is None:
            break
        prefix.append(s)
    return "".join(prefix)


# =============================================================================
# Rule 1: no-blocking-in-async
# =============================================================================
#
# The primary runs its whole protocol on ONE event loop; any synchronous
# stall there IS round-cadence latency (the PR 4 checkpoint-fsync stall:
# one os.fsync per commit burst froze proposer+core for the disk's flush
# latency).  Flagged inside `async def` bodies (nested sync `def`s start
# a new, unchecked scope — they may be executor targets):
#   - time.sleep / os.fsync / os.fdatasync / os.system
#   - builtin open() (sync file I/O)
#   - any subprocess.* call
#   - .sign(...) / .verify(...) method calls — the pure-Python crypto
#     entry points; the deliberate on-loop sites carry pragmas with the
#     measurement that justifies them.

_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep blocks the event loop; use asyncio.sleep",
    "os.fsync": "os.fsync stalls the loop for the disk flush; run it in "
    "an executor (see consensus/tusk.py checkpoint path)",
    "os.fdatasync": "os.fdatasync stalls the loop for the disk flush; "
    "run it in an executor",
    "os.system": "os.system blocks the loop for the child's lifetime",
}
_CRYPTO_ATTRS = {"sign", "verify"}


def rule_no_blocking_in_async(project: Project) -> Iterator[Finding]:
    for sf in project.files.values():
        if not sf.rel.startswith("narwhal_tpu_torch/") or sf.tree is None:
            continue
        yield from _scan_async_blocking(sf)


def _scan_async_blocking(sf: SourceFile) -> Iterator[Finding]:
    findings: List[Finding] = []

    def check_call(call: ast.Call) -> None:
        if sf.suppressed("blocking", call):
            return
        msg = None
        dotted = _dotted(call.func)
        if dotted in _BLOCKING_DOTTED:
            msg = f"{dotted}() in async def: {_BLOCKING_DOTTED[dotted]}"
        elif dotted is not None and dotted.startswith("subprocess."):
            msg = (
                f"{dotted}() in async def blocks the loop for the "
                "child's lifetime; use asyncio.create_subprocess_* or an "
                "executor"
            )
        elif isinstance(call.func, ast.Name) and call.func.id == "open":
            msg = (
                "sync file I/O (open) in async def blocks the loop on "
                "disk latency; move it to a sync helper run in an "
                "executor"
            )
        elif (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _CRYPTO_ATTRS
        ):
            msg = (
                f".{call.func.attr}() in async def: pure-Python crypto "
                "entry point on the event loop (~ms per op on the "
                "fallback backend); batch it, cache it, or pragma it "
                "with the measurement that makes it acceptable"
            )
        if msg is not None:
            findings.append(
                Finding("no-blocking-in-async", sf.rel, call.lineno, msg)
            )

    class Walker(ast.NodeVisitor):
        def __init__(self) -> None:
            self.stack: List[bool] = []

        def _scoped(self, node: ast.AST, is_async: bool) -> None:
            self.stack.append(is_async)
            self.generic_visit(node)
            self.stack.pop()

        def visit_AsyncFunctionDef(self, node):  # noqa: N802
            self._scoped(node, True)

        def visit_FunctionDef(self, node):  # noqa: N802
            self._scoped(node, False)

        def visit_Lambda(self, node):  # noqa: N802
            self._scoped(node, False)

        def visit_Call(self, node):  # noqa: N802
            if self.stack and self.stack[-1]:
                check_call(node)
            self.generic_visit(node)

    Walker().visit(sf.tree)
    yield from findings


# =============================================================================
# Rule 2: task-retention
# =============================================================================
#
# asyncio keeps only a WEAK reference to tasks: a create_task whose
# result is dropped can be garbage-collected mid-flight, and its
# unhandled exception (if it gets that far) is invisible until loop
# teardown.  A bare `create_task(...)` expression statement is exactly
# that shape.  utils/tasks.py::spawn() is the sanctioned fire-into-
# background call (strong ref + teardown logging); retained names that
# are awaited/cancelled later (queue-get races) stay legal.

_TASK_FNS = {"create_task", "ensure_future"}


def rule_task_retention(project: Project) -> Iterator[Finding]:
    for sf in project.files.values():
        if not sf.rel.startswith("narwhal_tpu_torch/") or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not (
                isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
            ):
                continue
            func = node.value.func
            name = (
                func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name)
                else None
            )
            if name not in _TASK_FNS:
                continue
            if sf.suppressed("unretained-task", node):
                continue
            yield Finding(
                "task-retention", sf.rel, node.lineno,
                f"fire-and-forget {name}(): the loop holds only a weak "
                "reference, so the task can be GC'd mid-flight and its "
                "exception is never surfaced — use "
                "narwhal_tpu_torch.utils.tasks.spawn() or retain the handle",
            )


# =============================================================================
# Rule 3: wire-type-coverage
# =============================================================================
#
# The wire-goodput ledger (PR 7) is only as good as its labels: a sender
# call site that forgets msg_type= books frames under "other", and a tag
# absent from the frame-classifier maps books the receiver side under
# "unknown" — either silently degrades the ledger's sender_coverage ≈
# 1.0 gate.  Both directions are enforced: every `<sender|network>.send/
# broadcast/lucky_broadcast(...)` call passes a literal msg_type= that
# exists in a *_FRAME_TYPES map, and every declared frame type has at
# least one sender call site (or the map entry is dead).

_SEND_METHODS = {"send", "broadcast", "lucky_broadcast"}
_SENDER_RECEIVERS = {"sender", "network"}
_CLASSIFIER_FILES = (
    "narwhal_tpu_torch/messages.py",
    "narwhal_tpu_torch/primary/messages.py",
)


def _declared_frame_types(project: Project) -> Dict[str, Tuple[str, int]]:
    """type-name -> (file, line) from the *_FRAME_TYPES dict literals."""
    declared: Dict[str, Tuple[str, int]] = {}
    for rel in _CLASSIFIER_FILES:
        sf = project.file(rel)
        if sf is None or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Assign):
                continue
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if not any(t.endswith("_FRAME_TYPES") for t in targets):
                continue
            if isinstance(node.value, ast.Dict):
                for v in node.value.values:
                    s = _str_const(v)
                    if s is not None and s not in declared:
                        declared[s] = (rel, v.lineno)
    return declared


def rule_wire_type_coverage(project: Project) -> Iterator[Finding]:
    declared = _declared_frame_types(project)
    used: Set[str] = set()
    findings: List[Finding] = []
    for sf in project.files.values():
        if not sf.rel.startswith("narwhal_tpu_torch/") or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SEND_METHODS
                and _receiver_name(node.func) in _SENDER_RECEIVERS
            ):
                continue
            kw = next(
                (k for k in node.keywords if k.arg == "msg_type"), None
            )
            if kw is None:
                if not sf.suppressed("wire-type", node):
                    findings.append(Finding(
                        "wire-type-coverage", sf.rel, node.lineno,
                        f"sender .{node.func.attr}() without msg_type=: "
                        "the frame books into the wire ledger as "
                        "'other', regressing sender coverage",
                    ))
                continue
            tag = _str_const(kw.value)
            if tag is None:
                if not sf.suppressed("wire-type", node):
                    findings.append(Finding(
                        "wire-type-coverage", sf.rel, node.lineno,
                        "msg_type= is not a string literal — the linter "
                        "cannot reconcile it against the frame-"
                        "classifier maps",
                    ))
                continue
            used.add(tag)
            if tag not in declared and not sf.suppressed("wire-type", node):
                findings.append(Finding(
                    "wire-type-coverage", sf.rel, node.lineno,
                    f"msg_type='{tag}' has no entry in any *_FRAME_TYPES "
                    "classifier map — the receiver side will book these "
                    "frames as 'unknown'",
                ))
    for tag, (rel, lineno) in sorted(declared.items()):
        if tag not in used:
            findings.append(Finding(
                "wire-type-coverage", rel, lineno,
                f"frame type '{tag}' is declared in a classifier map but "
                "no sender call site labels frames with it",
            ))
    yield from findings


# =============================================================================
# Rule 4: metric-name-drift
# =============================================================================
#
# Metric names are a string registry spread across ~100 emit sites and
# four consumer surfaces (metrics.default_rules, benchmark/
# metrics_check.py, benchmark/trajectory.py, the README tables).  A
# consumed name nothing emits is a health rule that can never fire or a
# bench section that silently reads zero.  Checked direction: consumed ⊆
# emitted (the reverse is meaningless — most metrics are not consumed by
# rules).  Dynamic per-peer/per-site suffixes are covered by the emit
# sites' f-string prefixes; names constructed entirely at runtime are
# allowlisted with a reason.

_INSTRUMENT_FNS = {"counter", "gauge", "histogram", "gauge_fn", "detail_fn"}
_CTX_EXACT_FNS = {"counter", "gauge", "rate", "last_change_age"}
_CTX_PREFIX_FNS = {"gauges_prefixed", "rates_prefixed"}
_METRIC_ROOTS = (
    "primary", "worker", "consensus", "net", "store", "crypto", "wire",
    "metrics", "faults", "runtime", "profile", "flight", "queue",
)
_METRIC_NAME_RE = re.compile(
    r"(?:%s)(?:\.[a-z0-9_]+)+\.?" % "|".join(_METRIC_ROOTS)
)
_README_TICK_RE = re.compile(r"`([^`]+)`")

# Metric names (exact or 'prefix.') legitimately constructed at runtime,
# with the reason the static scan cannot see them.
METRIC_ALLOWLIST: Dict[str, str] = {
    "wire.": "WireLedger builds wire.<dir>.{frames,bytes}.<type> (and the "
    "retransmit_ variants) at account time from the msg_type labels that "
    "rule wire-type-coverage pins",
    "queue.": "InstrumentedQueue builds queue.<channel>.{depth,capacity,"
    "high_water,enqueued,dequeued,full,put_wait_seconds,residence_seconds} "
    "from the channel name passed at construction (channel table in "
    "README 'Queue & backpressure accounting')",
}

# The port's consumers: the health rules, and the smoke run that
# reads the nodes' snapshots.
_CONSUMER_FILES = (
    "narwhal_tpu_torch/metrics.py",
    "chip_smoke.py",
)


def _collect_metric_names(
    project: Project,
) -> Tuple[Set[str], Set[str], List[Tuple[str, str, int, bool]], List[Finding]]:
    """-> (emitted_exact, emitted_prefixes,
          consumers [(name, file, line, is_prefix)], findings)"""
    emitted: Set[str] = set()
    prefixes: Set[str] = set()
    consumers: List[Tuple[str, str, int, bool]] = []
    findings: List[Finding] = []
    for sf in project.files.values():
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            name = (
                func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name)
                else None
            )
            recv = _receiver_name(func)
            arg0 = node.args[0]
            if recv == "ctx" and name in _CTX_EXACT_FNS | _CTX_PREFIX_FNS:
                s = _str_const(arg0)
                if s is not None:
                    consumers.append(
                        (s, sf.rel, arg0.lineno, name in _CTX_PREFIX_FNS)
                    )
                continue
            if name in _INSTRUMENT_FNS:
                s = _str_const(arg0)
                if s is not None:
                    emitted.add(s)
                elif isinstance(arg0, ast.JoinedStr):
                    prefix = _fstring_prefix(arg0)
                    if prefix:
                        prefixes.add(prefix)
                elif (
                    sf.rel != "narwhal_tpu_torch/metrics.py"
                    and not sf.suppressed("metric-name", node)
                ):
                    # metrics.py itself forwards names through the
                    # registry plumbing; everywhere else a non-literal
                    # name is invisible to drift checking.
                    findings.append(Finding(
                        "metric-name-drift", sf.rel, node.lineno,
                        f"{name}() with a non-literal metric name — "
                        "unresolvable for drift checking; use a string "
                        "literal (or an f-string with a literal prefix)",
                    ))
    # Literal references in the bench consumer files.
    for rel in _CONSUMER_FILES:
        sf = project.file(rel)
        if sf is None or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            s = _str_const(node)
            if s is None or not _METRIC_NAME_RE.fullmatch(s):
                continue
            consumers.append((s, rel, node.lineno, s.endswith(".")))
    # README tables: backtick-quoted names (a trailing `.<placeholder>`
    # marks a dynamic-suffix family -> prefix consumer).
    readme = project.texts.get("README.md")
    if readme is not None:
        for lineno, line in enumerate(readme.splitlines(), 1):
            for tick in _README_TICK_RE.findall(line):
                is_prefix = False
                if tick.endswith(">") and "<" in tick:
                    tick = tick[: tick.rindex("<")]
                    is_prefix = True
                if _METRIC_NAME_RE.fullmatch(tick):
                    consumers.append(
                        (tick, "README.md", lineno,
                         is_prefix or tick.endswith(".")),
                    )
    return emitted, prefixes, consumers, findings


def rule_metric_name_drift(project: Project) -> Iterator[Finding]:
    emitted, prefixes, consumers, findings = _collect_metric_names(project)

    def allowlisted(name: str) -> bool:
        return any(
            name == entry or name.startswith(entry)
            for entry in METRIC_ALLOWLIST
        )

    def exact_ok(name: str) -> bool:
        return (
            name in emitted
            or any(name.startswith(p) for p in prefixes)
            or allowlisted(name)
        )

    def prefix_ok(name: str) -> bool:
        return (
            any(e.startswith(name) for e in emitted)
            or any(p.startswith(name) or name.startswith(p) for p in prefixes)
            or allowlisted(name)
        )

    seen: Set[Tuple[str, str, int]] = set()
    for name, rel, lineno, is_prefix in consumers:
        key = (name, rel, lineno)
        if key in seen:
            continue
        seen.add(key)
        ok = prefix_ok(name) if is_prefix else exact_ok(name)
        if ok:
            continue
        sf = project.file(rel)
        if sf is not None:
            probe = ast.Expr(value=ast.Constant(value=name))
            probe.lineno = probe.end_lineno = lineno  # type: ignore[attr-defined]
            if sf.suppressed("metric-name", probe):
                continue
        kind = "prefix" if is_prefix else "name"
        findings.append(Finding(
            "metric-name-drift", rel, lineno,
            f"metric {kind} '{name}' is consumed here but no emit site "
            "registers it — the consumer silently reads nothing",
        ))
    yield from sorted(findings, key=lambda f: (f.path, f.line))


# =============================================================================
# Rule 5: env-var-registry
# =============================================================================
#
# 35+ NARWHAL_* knobs accreted across PRs 4-8, each hand-parsed at its
# read site and hand-documented (or not).  The registry in
# narwhal_tpu/utils/env.py is now the single source of truth: every
# NARWHAL_* string literal in the tree must be declared there, direct
# os.environ reads outside that module must route through its typed
# accessors, a declared knob nothing references is dead weight, and the
# README table is generated from the registry (drift in either direction
# fails here).

_ENV_NAME_RE = re.compile(r"NARWHAL_[A-Z0-9_]+")
_ENV_MODULE = "narwhal_tpu_torch/utils/env.py"
_DIRECT_READ_FNS = {"os.environ.get", "os.getenv"}


def _declared_env(project: Project) -> Dict[str, int]:
    sf = project.file(_ENV_MODULE)
    declared: Dict[str, int] = {}
    if sf is None or sf.tree is None:
        return declared
    for node in ast.walk(sf.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "EnvVar"
            and node.args
        ):
            s = _str_const(node.args[0])
            if s is not None:
                declared[s] = node.lineno
    return declared


def rule_env_var_registry(project: Project) -> Iterator[Finding]:
    declared = _declared_env(project)
    findings: List[Finding] = []
    referenced: Set[str] = set()
    for sf in project.files.values():
        if sf.tree is None or sf.rel == _ENV_MODULE:
            continue
        for node in ast.walk(sf.tree):
            s = _str_const(node)
            if s is not None and _ENV_NAME_RE.fullmatch(s):
                referenced.add(s)
                if s not in declared and not sf.suppressed("env", node):
                    findings.append(Finding(
                        "env-var-registry", sf.rel, node.lineno,
                        f"{s} is not declared in the "
                        "narwhal_tpu_torch/utils/env.py registry (name, type, "
                        "default, doc) — undeclared knobs are invisible "
                        "to the README table and rot unreviewed",
                    ))
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                arg = _str_const(node.args[0]) if node.args else None
                if (
                    dotted in _DIRECT_READ_FNS
                    and arg is not None
                    and _ENV_NAME_RE.fullmatch(arg)
                    and not sf.suppressed("env", node)
                ):
                    findings.append(Finding(
                        "env-var-registry", sf.rel, node.lineno,
                        f"direct {dotted}({arg!r}) — route NARWHAL_* "
                        "reads through the typed accessors in "
                        "narwhal_tpu_torch.utils.env (env_flag/env_int/"
                        "env_float/env_str) so parsing and defaults "
                        "stay declared once",
                    ))
            if isinstance(node, ast.Subscript) and _dotted(
                node.value
            ) == "os.environ":
                arg = _str_const(node.slice)
                if (
                    arg is not None
                    and _ENV_NAME_RE.fullmatch(arg)
                    and not sf.suppressed("env", node)
                ):
                    findings.append(Finding(
                        "env-var-registry", sf.rel, node.lineno,
                        f"direct os.environ[{arg!r}] — route NARWHAL_* "
                        "reads through narwhal_tpu_torch.utils.env accessors",
                    ))
    # Dead declarations: nothing in the parsed scope NOR the raw-text
    # scope (tests, Makefile, CI workflows, bench scripts) mentions them.
    for name, lineno in sorted(declared.items()):
        if name in referenced:
            continue
        if any(name in text for text in project.texts.values()):
            continue
        findings.append(Finding(
            "env-var-registry", _ENV_MODULE, lineno,
            f"{name} is declared in the registry but nothing reads it "
            "(searched narwhal_tpu_torch/, chip_smoke.py, window_ab.py, "
            "README.md, tests/) — delete the declaration or the dead knob",
        ))
    findings.extend(_env_table_drift(project))
    yield from findings


def _env_table_drift(project: Project) -> List[Finding]:
    """README 'Environment variables' table must equal the generated one.

    The registry is evaluated from the LINTED tree's utils/env.py (not
    the running package) so ``--root <other-checkout>`` and overlay
    mutations check the tree they claim to — env.py is stdlib-only by
    contract, which is what makes executing it here safe."""
    readme = project.texts.get("README.md")
    sf = project.file(_ENV_MODULE)
    if readme is None or sf is None:
        return []
    import sys
    import types

    mod_name = "_narwhal_lint_env"
    env_mod = types.ModuleType(mod_name)
    # Registered during exec: the dataclass machinery resolves
    # annotations through sys.modules[cls.__module__] (unguarded
    # .__dict__ access on 3.10).
    sys.modules[mod_name] = env_mod
    try:
        exec(compile(sf.text, _ENV_MODULE, "exec"), env_mod.__dict__)
        begin, end = env_mod.TABLE_BEGIN, env_mod.TABLE_END
    except Exception as e:
        return [Finding(
            "env-var-registry", _ENV_MODULE, 1,
            f"could not evaluate the env registry for the README table "
            f"check: {e!r}",
        )]
    finally:
        sys.modules.pop(mod_name, None)
    if begin not in readme or end not in readme:
        return [Finding(
            "env-var-registry", "README.md", 1,
            "README has no generated env-var table markers "
            f"({begin!r} … {end!r}); insert the output of "
            "`python -m narwhal_tpu_torch.analysis --env-table`",
        )]
    section = readme.split(begin, 1)[1].split(end, 1)[0].strip()
    expected = env_mod.render_table().strip()
    if section != expected:
        line = readme[: readme.index(begin)].count("\n") + 1
        return [Finding(
            "env-var-registry", "README.md", line,
            "README env-var table drifted from the registry — "
            "regenerate with `python -m narwhal_tpu_torch.analysis "
            "--env-table` and paste between the markers",
        )]
    return []


from .interleave import (  # noqa: E402  (bottom import: shares helpers)
    rule_interleave_iteration,
    rule_interleave_window,
)

ALL_RULES = (
    rule_no_blocking_in_async,
    rule_task_retention,
    rule_wire_type_coverage,
    rule_metric_name_drift,
    rule_env_var_registry,
    rule_interleave_window,
    rule_interleave_iteration,
)
