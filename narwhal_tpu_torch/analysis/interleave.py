"""Await-interleaving race rules — the interprocedural half of narwhal-lint.

The whole protocol's safety rests on cooperative-scheduling atomicity:
there is not a single ``asyncio.Lock`` in the tree, so the only thing
protecting ``Core.current_header``, the waiters' pending maps, the
Proposer's digest buffer or the Store's deferred buffer is that no task
yields between reading shared state and writing it back.  The PR 9 rules
are single-statement; the bug class PRs 4-8 kept rediscovering
dynamically (checkpoint-fsync stall, duplicate-flood re-verify,
deferred-flush ordering) is *interleavings* — which need a whole-program
yield analysis.  This module builds one:

1. **Units.**  Every function/method under ``narwhal_tpu_torch/`` (nested
   ``async def``s inside methods — the sender's ``write_loop`` — are
   their own units: they run as their own tasks).

2. **May-yield map.**  A unit may yield iff it contains a *true* yield
   point: ``async for``/``async with``, awaiting an unresolvable target
   (queue/event/socket primitives), or awaiting a project method that
   itself may yield (transitive fixpoint).  Awaiting an ``async def``
   that never suspends does NOT yield — asyncio runs it to completion
   synchronously — which is what keeps the HeaderWaiter's atomic-tick
   handlers (``await self._sync_parents(...)``: no awaits inside) out of
   the findings.

3. **Task roots.**  The tasks that can actually interleave: every
   spawned coroutine (``utils.tasks.spawn`` / ``create_task`` /
   ``ensure_future`` sites, resolved through ``self``/typed attributes/
   typed locals), every async ``run()`` method (the Primary/Worker/
   Consensus wiring spawns one task per protocol actor), receiver
   ``dispatch`` handlers (one task per inbound connection), asyncio
   ``Protocol`` callbacks (loop-invoked), and any bound method whose
   *reference* escapes as a callback argument (``parents_cb=
   proposer.deliver_parents``, ``run_in_executor(None,
   self._write_checkpoint, ...)``, ``Thread(target=self._watch)``).
   Root identity is (class-hierarchy group, method name), so a
   Byzantine override and its base run as ONE root — a node runs either,
   never both.  A root spawned from inside a loop, a per-connection
   dispatcher, and a protocol callback are *self-concurrent*: two
   instances of them can interleave with each other.

4. **Windows** (rule ``interleave-window``).  Per async unit, in source
   order (with transitive read/write summaries of resolved callees
   expanded at their call sites): a ``self.<attr>`` read, then a true
   yield point, then a write/mutation of the same attribute.  Flagged
   only when the attribute is also written from a *different* task root
   (or from two instances of a self-concurrent root) — the classic
   torn-invariant window.  Attributes reached through a typed attribute
   (``self.consensus_round.value``, the Store's internals via its
   methods) are keyed by the owning class, so cross-class sharing of one
   object is seen.

5. **Iteration** (rule ``interleave-iteration``).  ``for … in
   self.<attr>`` / ``.items()/.values()/.keys()`` whose loop body
   contains a true yield point, on an attribute another task root
   writes: mutation-during-iteration under a new interleaving
   (``list(self.attr)`` snapshots are exempt — they copy first).

Findings report the **yield chain** — the call path that makes the
window suspendable (``await self.synchronizer.get_parents →
Synchronizer.get_parents → await self.tx_header_waiter.put``) — so a
pragma can cite the actual window.  Suppression:
``# lint: allow-interleave(reason)`` on the read, yield, write or
``for`` line (or the line above any of them); the reason must name the
invariant that makes the window safe.

Known approximations (all toward over-reporting, never silent misses,
except as noted): straight source order approximates control flow (a
loop's back edge is not modeled, so a read that only precedes the yield
on the *next* iteration is missed — deliberate: the sleep-then-
atomic-tick pattern used by every timer here would otherwise flag);
callee write summaries are expanded flow-insensitively at the call line,
ordered before the call's own yield (the take-then-suspend shape every
consumer here uses); call targets through untyped objects are
unresolvable — their awaits count as yields, their writes are invisible.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .linter import Finding, Project, SourceFile

# Methods whose call MUTATES the receiver (dict/set/list/deque surface).
_MUTATORS = {
    "append", "appendleft", "add", "pop", "popleft", "extend",
    "extendleft", "update", "setdefault", "clear", "remove", "discard",
    "insert", "sort", "reverse",
}

# Loop-invoked asyncio.Protocol callbacks: roots, one invocation per event.
_PROTOCOL_CALLBACKS = {
    "data_received", "connection_made", "connection_lost", "eof_received",
}
# Iteration views that alias the container (no copy).
_ALIAS_VIEWS = {"items", "values", "keys"}

PRAGMA = "interleave"


# -- model ---------------------------------------------------------------------

@dataclass
class Unit:
    key: str                 # "rel::Class.method" (nested: "….<inner>")
    rel: str
    cls: Optional[str]       # defining class name (None: module function)
    name: str                # bare function name
    node: ast.AST
    is_async: bool
    # ordered items: ("r"/"w", attr_key, line)
    #              | ("y", None, line, None, label)
    #              | ("call", None, line, target_key|None, awaited, label)
    items: List[tuple] = field(default_factory=list)
    # iteration spans: (attr_key, for_line, body_end_line)
    iters: List[Tuple[Tuple[str, str], int, int]] = field(default_factory=list)
    external_yield: bool = False   # has an unresolvable yield point


@dataclass
class ClassInfo:
    name: str
    rel: str
    bases: List[str]
    methods: Dict[str, str] = field(default_factory=dict)  # name -> unit key
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> class


class Model:
    def __init__(self) -> None:
        self.units: Dict[str, Unit] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.group: Dict[str, str] = {}     # class -> hierarchy group root
        self.may_yield: Dict[str, bool] = {}
        self.reads: Dict[str, Set] = {}     # unit key -> attr-key summary
        self.writes: Dict[str, Set] = {}
        self.roots: Dict[str, Set[str]] = {}   # unit key -> root ids
        self.self_concurrent: Set[str] = set()  # root ids
        self.root_repr: Dict[str, str] = {}    # root id -> a unit key
        # attr key -> {root ids that write it}
        self.attr_writers: Dict[Tuple[str, str], Set[str]] = {}

    def root_id(self, unit: Unit) -> str:
        """Hierarchy-merged task-root identity: a Byzantine override and
        its base method are ONE root (a node runs one or the other)."""
        if unit.cls is not None:
            base = f"{self.group.get(unit.cls, unit.cls)}.{unit.name}"
            if "<" in unit.key:  # nested unit: keep its own identity
                return f"{base}.{unit.key.split('::', 1)[1]}"
            return base
        return unit.key


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _ann_name(ann: Optional[ast.AST]) -> Optional[str]:
    """Class name from a parameter annotation (Name, string constant, or
    Optional[Name])."""
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        inner = ann.value.strip().strip('"\'')
        if inner.startswith("Optional[") and inner.endswith("]"):
            inner = inner[len("Optional["):-1]
        return inner.split("[")[0].split(".")[-1] or None
    if isinstance(ann, ast.Subscript) and isinstance(ann.slice, ast.Name):
        return ann.slice.id  # Optional[X]
    return None


# -- pass 1: units, classes, attr types ---------------------------------------

def _collect(project: Project) -> Model:
    model = Model()
    for sf in project.files.values():
        if not sf.rel.startswith("narwhal_tpu_torch/") or sf.tree is None:
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                ci = ClassInfo(
                    name=node.name,
                    rel=sf.rel,
                    bases=[
                        b.id if isinstance(b, ast.Name)
                        else (b.attr if isinstance(b, ast.Attribute) else "")
                        for b in node.bases
                    ],
                )
                # First definition wins on a (rare) duplicate class name;
                # attr keys merge through the hierarchy groups anyway.
                model.classes.setdefault(node.name, ci)
                for item in node.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        key = f"{sf.rel}::{node.name}.{item.name}"
                        ci.methods.setdefault(item.name, key)
                        model.units[key] = Unit(
                            key, sf.rel, node.name, item.name, item,
                            isinstance(item, ast.AsyncFunctionDef),
                        )
                        _collect_nested(model, sf, node.name, key, item)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{sf.rel}::{node.name}"
                model.units[key] = Unit(
                    key, sf.rel, None, node.name, node,
                    isinstance(node, ast.AsyncFunctionDef),
                )
                _collect_nested(model, sf, None, key, node)
    # Hierarchy groups (union through project bases).
    parent: Dict[str, str] = {c: c for c in model.classes}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for ci in model.classes.values():
        for b in ci.bases:
            if b in parent:
                parent[find(ci.name)] = find(b)
    model.group = {c: find(c) for c in model.classes}
    # Attribute types, after all classes are known.
    for ci in model.classes.values():
        for ukey in ci.methods.values():
            fn = model.units[ukey].node
            ann_by_param = {}
            for a in list(fn.args.args) + list(fn.args.kwonlyargs):
                t = _ann_name(a.annotation)
                if t in model.classes:
                    ann_by_param[a.arg] = t
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign):
                    continue
                for tgt in stmt.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        t = None
                        v = stmt.value
                        if (
                            isinstance(v, ast.Call)
                            and isinstance(v.func, ast.Name)
                            and v.func.id in model.classes
                        ):
                            t = v.func.id
                        elif isinstance(v, ast.Name):
                            t = ann_by_param.get(v.id)
                        if t is not None:
                            ci.attr_types.setdefault(tgt.attr, t)
    return model


def _collect_nested(
    model: Model, sf: SourceFile, cls: Optional[str], parent_key: str,
    fn: ast.AST,
) -> None:
    """Nested function defs are their own units (they may run as their
    own tasks — the sender's write_loop/read_loop).  Flat keying under
    the defining method; depth beyond one level keeps the same parent."""
    for item in ast.walk(fn):
        if item is fn or not isinstance(
            item, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            continue
        key = f"{parent_key}.<{item.name}>"
        if key not in model.units:
            model.units[key] = Unit(
                key, sf.rel, cls, item.name, item,
                isinstance(item, ast.AsyncFunctionDef),
            )


# -- pass 2: per-unit events, calls, spawns, escapes --------------------------

class _Scan(ast.NodeVisitor):
    """One unit's ordered event stream + call/spawn/escape sites."""

    def __init__(self, model: Model, unit: Unit):
        self.model = model
        self.unit = unit
        self.cls = model.classes.get(unit.cls) if unit.cls else None
        self.locals: Dict[str, str] = {}  # local var -> class name
        self.spawns: List[Tuple[str, bool]] = []   # (target unit, in_loop)
        self.escapes: List[str] = []               # escaped method units
        self._loop_depth = 0
        fn = unit.node
        for a in list(fn.args.args) + list(fn.args.kwonlyargs):
            t = _ann_name(a.annotation)
            if t in model.classes:
                self.locals[a.arg] = t

    # -- resolution helpers --------------------------------------------------

    def _attr_key(self, node: ast.AST) -> Optional[Tuple[str, str]]:
        """(group, attr) for self.<attr>, or for <typed>.<attr> one level
        through a typed expression (self.consensus_round.value)."""
        if not isinstance(node, ast.Attribute):
            return None
        base = node.value
        if isinstance(base, ast.Name) and base.id == "self" and self.cls:
            return (self.model.group[self.cls.name], node.attr)
        inner = self._obj_class(base)
        if inner is not None:
            return (self.model.group[inner], node.attr)
        return None

    def _obj_class(self, node: ast.AST) -> Optional[str]:
        """Class of an object expression, when statically known."""
        if isinstance(node, ast.Name):
            if node.id == "self" and self.cls:
                return self.cls.name
            return self.locals.get(node.id)
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and self.cls
        ):
            return self._lookup_attr_type(self.cls.name, node.attr)
        return None

    def _lookup_attr_type(self, cls: str, attr: str) -> Optional[str]:
        seen: Set[str] = set()
        while cls in self.model.classes and cls not in seen:
            seen.add(cls)
            t = self.model.classes[cls].attr_types.get(attr)
            if t is not None:
                return t
            cls = next(
                (b for b in self.model.classes[cls].bases
                 if b in self.model.classes),
                None,
            )
        return None

    def _resolve_method(self, cls: Optional[str], name: str) -> Optional[str]:
        seen: Set[str] = set()
        while cls in self.model.classes and cls not in seen:
            seen.add(cls)
            key = self.model.classes[cls].methods.get(name)
            if key is not None:
                return key
            cls = next(
                (b for b in self.model.classes[cls].bases
                 if b in self.model.classes),
                None,
            )
        return None

    def _resolve_call(self, func: ast.AST) -> Optional[str]:
        """Unit key of the call target, when statically known."""
        if isinstance(func, ast.Name):
            # Nested unit of this method, or same-module function.
            for cand in (
                f"{self.unit.key}.<{func.id}>",
                f"{self.unit.rel}::{func.id}",
            ):
                if cand in self.model.units:
                    return cand
            return None
        if isinstance(func, ast.Attribute):
            owner = self._obj_class(func.value)
            if owner is not None:
                return self._resolve_method(owner, func.attr)
        return None

    # -- traversal -----------------------------------------------------------

    def run(self) -> None:
        for stmt in self.unit.node.body:
            self._visit(stmt)

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested unit: separate scope, separate task
        if isinstance(node, ast.Lambda):
            return
        method = getattr(self, f"_v_{type(node).__name__}", None)
        if method is not None:
            method(node)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _emit(self, kind: str, attr, line: int, *extra) -> None:
        self.unit.items.append((kind, attr, line, *extra))

    # assignments / mutations -------------------------------------------------

    def _v_Assign(self, node: ast.Assign) -> None:
        self._visit(node.value)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            v = node.value
            if (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Name)
                and v.func.id in self.model.classes
            ):
                # v = ClassName(...): local holds an instance.
                self.locals[node.targets[0].id] = v.func.id
            elif (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Name)
                and v.func.id in self.locals
            ):
                # v = cls_var(...) where cls_var holds a class object
                # (primary.py: `proposer = proposer_cls(...)` after
                # `proposer_cls, core_cls = Proposer, Core`).
                self.locals[node.targets[0].id] = self.locals[v.func.id]
            elif isinstance(v, ast.Name) and v.id in self.model.classes:
                # v = ClassName: local holds the class object; `v(...)`
                # then builds an instance of it (primary.py's
                # `proposer_cls, core_cls = Proposer, Core` is the tuple
                # variant below).
                self.locals[node.targets[0].id] = v.id
            elif isinstance(v, ast.Name) and v.id in self.locals:
                self.locals[node.targets[0].id] = self.locals[v.id]
        if (
            len(node.targets) == 1
            and isinstance(node.targets[0], ast.Tuple)
            and isinstance(node.value, ast.Tuple)
            and len(node.targets[0].elts) == len(node.value.elts)
        ):
            for t, v in zip(node.targets[0].elts, node.value.elts):
                if (
                    isinstance(t, ast.Name)
                    and isinstance(v, ast.Name)
                    and v.id in self.model.classes
                ):
                    self.locals[t.id] = v.id
        for tgt in node.targets:
            self._store_target(tgt)

    def _v_AugAssign(self, node: ast.AugAssign) -> None:
        self._visit(node.value)
        key = self._attr_key(node.target)
        if key is None and isinstance(node.target, ast.Subscript):
            key = self._attr_key(node.target.value)
        if key is None and isinstance(node.target, ast.Attribute):
            key = self._attr_key(node.target.value)
        if key is not None:
            self._emit("r", key, node.lineno)
            self._emit("w", key, node.lineno)

    def _store_target(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._store_target(el)
            return
        key = self._attr_key(tgt)
        if key is not None:
            self._emit("w", key, tgt.lineno)
            return
        if isinstance(tgt, ast.Subscript):
            key = self._attr_key(tgt.value)
            if key is not None:
                self._emit("w", key, tgt.lineno)
            else:
                self._visit(tgt.value)
        elif isinstance(tgt, ast.Attribute):
            # self.a.b = x on an untyped a: mutating the object held in
            # a, conservatively a write to a.
            key = self._attr_key(tgt.value)
            if key is not None:
                self._emit("w", key, tgt.lineno)

    def _v_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
            key = self._attr_key(base)
            if key is not None:
                self._emit("w", key, node.lineno)

    # reads -------------------------------------------------------------------

    def _v_Attribute(self, node: ast.Attribute) -> None:
        key = self._attr_key(node)
        if key is not None and isinstance(node.ctx, ast.Load):
            self._emit("r", key, node.lineno)
        self._visit(node.value)

    # calls / awaits ----------------------------------------------------------

    def _v_Call(self, node: ast.Call) -> None:
        self._visit(node.func)
        fname = (
            node.func.attr if isinstance(node.func, ast.Attribute)
            else node.func.id if isinstance(node.func, ast.Name) else None
        )
        # Mutator call on a tracked attribute: self.pending.pop(...)
        if isinstance(node.func, ast.Attribute) and fname in _MUTATORS:
            key = self._attr_key(node.func.value)
            if key is not None:
                self._emit("r", key, node.lineno)
                self._emit("w", key, node.lineno)
        # Spawn site?  The coroutine argument is only CREATED here — it
        # runs as its own task, so its effects must not be expanded at
        # this call site (mark it so the call item below is suppressed).
        spawned_call = None
        if fname in ("spawn", "create_task", "ensure_future") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Call):
                spawned_call = arg
                target = self._resolve_call(arg.func)
                if target is not None:
                    self.spawns.append((target, self._loop_depth > 0))
        # Escaping bound-method references in argument position.
        for a in list(node.args) + [k.value for k in node.keywords]:
            if isinstance(a, (ast.Attribute, ast.Name)):
                target = self._resolve_call(a)
                if target is not None:
                    self.escapes.append(target)
        for a in node.args:
            if a is spawned_call:
                # Evaluate only the coroutine call's own arguments (they
                # ARE evaluated at spawn time); the body runs elsewhere.
                for sub in a.args:
                    self._visit(sub)
                for sub in a.keywords:
                    self._visit(sub.value)
                continue
            self._visit(a)
        for k in node.keywords:
            self._visit(k.value)
        target = self._resolve_call(node.func)
        label = _dotted(node.func) or f"{fname or '?'}()"
        self._emit("call", None, node.lineno, target, False, label)

    def _v_Await(self, node: ast.Await) -> None:
        if isinstance(node.value, ast.Call):
            self._v_Call(node.value)
            last = self.unit.items[-1]
            if last[0] == "call":
                # Mark the call item awaited.
                self.unit.items[-1] = (
                    "call", None, last[2], last[3], True, last[5]
                )
                if last[3] is None:
                    # Unresolvable awaited target: a true yield point.
                    self.unit.external_yield = True
                    self._emit(
                        "y", None, node.lineno, None, f"await {last[5]}"
                    )
        else:
            self._visit(node.value)
            self.unit.external_yield = True
            self._emit("y", None, node.lineno, None, "await <future>")

    # control flow ------------------------------------------------------------

    def _v_For(self, node: ast.For) -> None:
        self._iter_common(node)

    def _v_AsyncFor(self, node: ast.AsyncFor) -> None:
        self.unit.external_yield = True
        self._emit("y", None, node.lineno, None, "async for")
        self._iter_common(node)

    def _iter_common(self, node) -> None:
        # Direct (aliasing) iteration over a tracked attribute?
        it = node.iter
        key = self._attr_key(it)
        if (
            key is None
            and isinstance(it, ast.Call)
            and isinstance(it.func, ast.Attribute)
            and it.func.attr in _ALIAS_VIEWS
        ):
            key = self._attr_key(it.func.value)
        if key is not None:
            end = max(
                (getattr(n, "end_lineno", None) or node.lineno)
                for n in ast.walk(node)
            )
            self.unit.iters.append((key, node.lineno, end))
        self._visit(it)
        self._store_target(node.target)
        self._loop_depth += 1
        for stmt in node.body:
            self._visit(stmt)
        self._loop_depth -= 1
        for stmt in node.orelse:
            self._visit(stmt)

    def _v_While(self, node: ast.While) -> None:
        self._visit(node.test)
        self._loop_depth += 1
        for stmt in node.body:
            self._visit(stmt)
        self._loop_depth -= 1
        for stmt in node.orelse:
            self._visit(stmt)

    def _v_AsyncWith(self, node: ast.AsyncWith) -> None:
        self.unit.external_yield = True
        self._emit("y", None, node.lineno, None, "async with")
        for item in node.items:
            self._visit(item.context_expr)
        for stmt in node.body:
            self._visit(stmt)


# -- pass 3: fixpoints, roots, reachability -----------------------------------

def build_model(project: Project) -> Model:
    cached = getattr(project, "_interleave_model", None)
    if cached is not None:
        return cached
    model = _collect(project)
    scans: Dict[str, _Scan] = {}
    for key, unit in model.units.items():
        scan = _Scan(model, unit)
        scan.run()
        scans[key] = scan

    # May-yield fixpoint: seed with external yields, propagate through
    # awaited resolved calls.
    may = {k: u.external_yield for k, u in model.units.items()}
    changed = True
    while changed:
        changed = False
        for key, unit in model.units.items():
            if may[key]:
                continue
            for item in unit.items:
                if item[0] != "call" or not item[4]:
                    continue
                if item[3] is not None and may.get(item[3]):
                    may[key] = True
                    changed = True
                    break
    model.may_yield = may

    # Read/write summaries (transitive through resolved calls).
    reads: Dict[str, Set] = {k: set() for k in model.units}
    writes: Dict[str, Set] = {k: set() for k in model.units}
    for key, unit in model.units.items():
        for item in unit.items:
            if item[0] == "r":
                reads[key].add(item[1])
            elif item[0] == "w":
                writes[key].add(item[1])
    changed = True
    while changed:
        changed = False
        for key, unit in model.units.items():
            for item in unit.items:
                if item[0] != "call" or item[3] is None:
                    continue
                t = item[3]
                if not reads[t] <= reads[key]:
                    reads[key] |= reads[t]
                    changed = True
                if not writes[t] <= writes[key]:
                    writes[key] |= writes[t]
                    changed = True
    model.reads, model.writes = reads, writes

    # Task roots (hierarchy-merged ids).
    root_units: Dict[str, str] = {}  # unit key -> root id

    def add_root(ukey: str, multi: bool = False) -> None:
        unit = model.units[ukey]
        rid = model.root_id(unit)
        root_units[ukey] = rid
        model.root_repr.setdefault(rid, ukey)
        if multi:
            model.self_concurrent.add(rid)

    for key, unit in model.units.items():
        if unit.is_async and unit.cls is not None and unit.name == "run" \
                and "<" not in key:
            add_root(key)
        elif unit.is_async and unit.cls is not None \
                and unit.name == "dispatch":
            add_root(key, multi=True)  # one task per inbound connection
        elif unit.cls is not None and unit.name in _PROTOCOL_CALLBACKS:
            add_root(key, multi=True)  # loop-invoked per event
    for key, scan in scans.items():
        for target, in_loop in scan.spawns:
            add_root(target, multi=in_loop)
        for target in scan.escapes:
            add_root(target)

    # Reachability: BFS from each root through resolved calls, plus
    # sibling methods under the same root id (an override chain).
    callees: Dict[str, Set[str]] = {k: set() for k in model.units}
    for key, unit in model.units.items():
        for item in unit.items:
            if item[0] == "call" and item[3] is not None:
                callees[key].add(item[3])
    roots_of: Dict[str, Set[str]] = {k: set() for k in model.units}
    for ukey, rid in root_units.items():
        stack, seen = [ukey], {ukey}
        while stack:
            cur = stack.pop()
            roots_of[cur].add(rid)
            for nxt in callees[cur]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
    model.roots = roots_of

    # Writers per attribute (direct write events only, attributed to the
    # writing unit's roots).
    for key, unit in model.units.items():
        for item in unit.items:
            if item[0] == "w":
                model.attr_writers.setdefault(item[1], set()).update(
                    roots_of[key]
                )

    project._interleave_model = model  # type: ignore[attr-defined]
    return model


# -- yield chains --------------------------------------------------------------

def _yield_chain(model: Model, item, depth: int = 3) -> str:
    """Human-readable suspension path for one awaited-call yield point."""
    label = f"await {item[5]}"
    target = item[3]
    hops: List[str] = []
    while target is not None and depth > 0:
        t = model.units[target]
        hops.append(f"{t.cls + '.' if t.cls else ''}{t.name}")
        nxt = None
        for it in t.items:
            if it[0] == "y":
                hops.append(it[4])
                break
            if it[0] == "call" and it[4] and it[3] is not None \
                    and model.may_yield.get(it[3]):
                nxt = it
                hops.append(f"await {it[5]}")
                break
        if nxt is None:
            break
        target = nxt[3]
        depth -= 1
    return label + "".join(" → " + h for h in hops)


# -- window extraction ---------------------------------------------------------

def _expanded_events(model: Model, unit: Unit):
    """Ordered (kind, attr, line, chain) events with callee summaries
    expanded at their call sites.

    Only summary attrs of the unit's OWN class group are expanded: a
    window on another object's internals (the Store's maps, a sender's
    deques) is reported where it actually sits — inside that class's own
    methods — not duplicated into every caller, where the read and write
    lines would both point at opaque call sites."""
    own = model.group.get(unit.cls) if unit.cls else None
    out = []
    for item in unit.items:
        kind = item[0]
        if kind in ("r", "w"):
            out.append((kind, item[1], item[2], None))
        elif kind == "y":
            out.append(("y", None, item[2], item[4]))
        elif kind == "call":
            _, _, line, target, awaited, label = item
            if target is not None:
                for attr in sorted(model.reads[target]):
                    if attr[0] == own:
                        out.append(("r", attr, line, None))
                for attr in sorted(model.writes[target]):
                    if attr[0] == own:
                        out.append(("w", attr, line, None))
                if awaited and model.may_yield.get(target):
                    out.append(("y", None, line, _yield_chain(model, item)))
    return out


def _racy_roots(model: Model, unit_roots: Set[str], attr) -> Set[str]:
    """Root ids that can write ``attr`` while a task in ``unit_roots`` is
    suspended mid-window: any writer root outside the unit's own root
    set, any writer at all when the unit runs under several roots, and
    any self-concurrent writer root (two instances interleave)."""
    writers = model.attr_writers.get(attr, set())
    if len(unit_roots) > 1:
        other = set(writers)
    else:
        other = writers - unit_roots
    other |= {
        r for r in (writers & unit_roots) if r in model.self_concurrent
    }
    return other


def _suppressed(sf: SourceFile, lines) -> bool:
    for ln in lines:
        probe = ast.Expr(value=ast.Constant(value=0))
        probe.lineno = probe.end_lineno = ln  # type: ignore[attr-defined]
        if sf.suppressed(PRAGMA, probe):
            return True
    return False


def _root_names(model: Model, roots: Set[str]) -> str:
    names = []
    for r in sorted(roots):
        u = model.units[model.root_repr[r]]
        label = f"{u.cls + '.' if u.cls else ''}{u.name}"
        if r in model.self_concurrent:
            label += " (multi-instance)"
        names.append(f"{label} [{u.rel}]")
    return ", ".join(names)


def _unit_label(unit: Unit) -> str:
    return f"{unit.cls + '.' if unit.cls else ''}{unit.name}"


def rule_interleave_window(project: Project) -> Iterator[Finding]:
    model = build_model(project)
    findings: List[Finding] = []
    for key, unit in model.units.items():
        if not unit.is_async or not model.roots.get(key):
            continue
        sf = project.file(unit.rel)
        if sf is None:
            continue
        events = _expanded_events(model, unit)
        for attr in sorted({e[1] for e in events if e[0] == "r"}):
            racy = _racy_roots(model, model.roots[key], attr)
            if not racy:
                continue
            state = 0  # 0: want read, 1: want yield, 2: want write
            r_line = y_line = None
            chain = ""
            for kind, a, line, info in events:
                if state == 0 and kind == "r" and a == attr:
                    state, r_line = 1, line
                elif state == 1 and kind == "y":
                    state, y_line, chain = 2, line, info or ""
                elif state == 2 and kind == "w" and a == attr:
                    if _suppressed(sf, (r_line, y_line, line)):
                        # This window is pragma'd; keep scanning in the
                        # same state — a LATER write on the same
                        # attribute (after the same read/yield) is a new
                        # site the pragma's invariant may not cover, and
                        # silently masking it would violate the
                        # over-reporting contract.
                        continue
                    shared = (
                        ""
                        if unit.cls is not None
                        and model.group.get(unit.cls) == attr[0]
                        else f" (shared state of {attr[0]})"
                    )
                    findings.append(Finding(
                        "interleave-window", unit.rel, r_line,
                        f"{_unit_label(unit)}: self.{attr[1]}{shared} "
                        f"is read at line {r_line}, the task can "
                        f"suspend at line {y_line} ({chain}), and it "
                        f"is written at line {line} — while "
                        f"suspended, task root(s) "
                        f"{_root_names(model, racy)} can also write "
                        "it (torn-invariant window); close the "
                        "window or pragma the invariant that makes "
                        "it safe",
                    ))
                    break
    yield from sorted(findings, key=lambda f: (f.path, f.line, f.message))


def rule_interleave_iteration(project: Project) -> Iterator[Finding]:
    model = build_model(project)
    findings: List[Finding] = []
    for key, unit in model.units.items():
        if not unit.is_async or not model.roots.get(key):
            continue
        sf = project.file(unit.rel)
        if sf is None:
            continue
        events = _expanded_events(model, unit)
        for attr, start, end in unit.iters:
            y = next(
                (e for e in events if e[0] == "y" and start < e[2] <= end),
                None,
            )
            if y is None:
                continue
            racy = _racy_roots(model, model.roots[key], attr)
            if not racy or _suppressed(sf, (start, y[2])):
                continue
            findings.append(Finding(
                "interleave-iteration", unit.rel, start,
                f"{_unit_label(unit)}: iterating self.{attr[1]} directly "
                f"while the loop body can suspend at line {y[2]} "
                f"({y[3]}) — task root(s) {_root_names(model, racy)} can "
                "mutate it mid-iteration (RuntimeError or a silently "
                "skipped entry under a new interleaving); snapshot with "
                "list(...) first, or pragma the invariant that makes it "
                "safe",
            ))
    yield from sorted(findings, key=lambda f: (f.path, f.line, f.message))
