"""Rule ``event-reentrancy`` — subscription callbacks must not mutate the
engine except through the sanctioned reaction APIs.

``FlowSim._emit`` runs subscriber callbacks synchronously, *inside* the
event, after aborts have settled but mid-way through the engine's own
bookkeeping.  The repo's whole failure story depends on what those
callbacks are allowed to do: the FleetScheduler re-grants and the
ClusterRuntime re-plans INSIDE the event — but only through the
designed surface (``start``/``start_many``/``remove``, the multicast
execution's ``launch``/``cancel`` wrappers, read-only estimates).  A
callback that reaches ``_evict_failed``, a capacity mutation
(``fail_device`` / ``degrade_link`` / ...), or any solver internal
re-enters the settle loop and corrupts the event stream — the kind of
bug no unit test catches until a golden diverges three PRs later.

This rule finds every callable passed to ``*.subscribe(...)`` across the
scanned tree and walks the call graph from it (name-based, conservative:
``self.m()`` resolves within the class, ``self.attr.m()`` through
constructor assignments, other ``obj.m()`` by unique method name across
the universe, unresolvable calls are opaque).  Sanctioned APIs are
DFS-opaque — passing *through* them is the contract; reaching a
forbidden name any other way is a finding, reported at the offending
call site with the full call path from the callback.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from repro_torch.analysis.core import AnalysisContext, Finding, Rule, SourceUnit, register

__all__ = ["EventReentrancyRule"]


@dataclasses.dataclass
class _Method:
    unit: SourceUnit
    cls: str | None  # None = module-level function
    name: str
    node: ast.AST  # FunctionDef | Lambda


class _Universe:
    """Name-indexed view of every class/method/function in the tree."""

    def __init__(self, units: list[SourceUnit]):
        self.classes: dict[str, dict[str, _Method]] = {}
        self.attr_classes: dict[tuple[str, str], str] = {}  # (cls, attr) -> cls
        self.functions: dict[tuple[str, str], _Method] = {}  # (module, name)
        self.methods_by_name: dict[str, list[_Method]] = {}
        for unit in units:
            for node in ast.walk(unit.tree):
                if isinstance(node, ast.ClassDef):
                    methods = self.classes.setdefault(node.name, {})
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            m = _Method(unit, node.name, item.name, item)
                            methods[item.name] = m
                            self.methods_by_name.setdefault(item.name, []).append(m)
                    # self.X = ClassName(...) constructor assignments
                    for sub in ast.walk(node):
                        if (
                            isinstance(sub, ast.Assign)
                            and len(sub.targets) == 1
                            and isinstance(sub.targets[0], ast.Attribute)
                            and isinstance(sub.targets[0].value, ast.Name)
                            and sub.targets[0].value.id == "self"
                            and isinstance(sub.value, ast.Call)
                            and isinstance(sub.value.func, ast.Name)
                        ):
                            self.attr_classes[(node.name, sub.targets[0].attr)] = (
                                sub.value.func.id
                            )
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # module-level only (class methods handled above)
                    pass
            for stmt in unit.tree.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.functions[(unit.module, stmt.name)] = _Method(
                        unit, None, stmt.name, stmt
                    )

    def resolve_method(self, cls: str | None, name: str) -> _Method | None:
        if cls is not None and name in self.classes.get(cls, {}):
            return self.classes[cls][name]
        cands = self.methods_by_name.get(name, [])
        if len(cands) == 1:
            return cands[0]
        return None


@register
class EventReentrancyRule(Rule):
    id = "event-reentrancy"
    summary = "subscribe callbacks reach engine mutators only via sanctioned APIs"

    def check_project(self, ctx: AnalysisContext) -> Iterator[Finding]:
        uni = _Universe(ctx.units)
        for unit in ctx.units:
            for entry, entry_desc in self._entries(unit, uni, ctx):
                yield from self._walk(entry, entry_desc, uni, ctx)

    # -- entry points --------------------------------------------------------
    def _entries(self, unit: SourceUnit, uni: _Universe, ctx: AnalysisContext):
        sub = ctx.config.subscribe_method
        for node in ast.walk(unit.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == sub
                and node.args
            ):
                continue
            arg = node.args[0]
            cls = self._enclosing_class(unit, node)
            if isinstance(arg, ast.Lambda):
                yield _Method(unit, cls, "<lambda>", arg), f"{unit.module}:<lambda>"
            elif isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name):
                if arg.value.id == "self" and cls is not None:
                    m = uni.classes.get(cls, {}).get(arg.attr)
                    if m is None:
                        # instance attribute holding a callable object
                        target_cls = uni.attr_classes.get((cls, arg.attr))
                        if target_cls is not None:
                            m = uni.classes.get(target_cls, {}).get("__call__")
                    if m is not None:
                        yield m, f"{cls}.{arg.attr}"
            elif isinstance(arg, ast.Name):
                m = uni.functions.get((unit.module, arg.id))
                if m is not None:
                    yield m, f"{unit.module}.{arg.id}"

    @staticmethod
    def _enclosing_class(unit: SourceUnit, node: ast.AST) -> str | None:
        cur = node
        while cur is not None:
            cur = unit.parents.get(cur)
            if isinstance(cur, ast.ClassDef):
                return cur.name
        return None

    # -- reachability --------------------------------------------------------
    def _walk(
        self, entry: _Method, entry_desc: str, uni: _Universe, ctx: AnalysisContext
    ) -> Iterator[Finding]:
        cfg = ctx.config
        visited: set[tuple[str | None, str]] = set()
        # stack of (method, path-so-far)
        stack: list[tuple[_Method, tuple[str, ...]]] = [(entry, (entry_desc,))]
        while stack:
            method, path = stack.pop()
            key = (method.cls, method.name)
            if key in visited:
                continue
            visited.add(key)
            for call in self._own_calls(method.node):
                callee = self._callee_name(call)
                if callee is None:
                    continue
                if callee in cfg.reentrancy_sanctioned:
                    continue  # the supported in-event surface: opaque
                if callee in cfg.reentrancy_forbidden:
                    chain = " -> ".join(path + (callee,))
                    yield Finding(
                        rule=self.id,
                        path=method.unit.path,
                        line=call.lineno,
                        col=call.col_offset,
                        symbol=chain,
                        message=(
                            f"subscribe callback reaches engine mutator "
                            f"{callee!r} (path: {chain}) — react through the "
                            f"sanctioned APIs "
                            f"({', '.join(sorted(cfg.reentrancy_sanctioned))}) "
                            "or defer to the next tick"
                        ),
                    )
                    continue
                nxt = self._resolve(call, method, uni)
                if nxt is not None and (nxt.cls, nxt.name) not in visited:
                    label = f"{nxt.cls}.{nxt.name}" if nxt.cls else nxt.name
                    stack.append((nxt, path + (label,)))

    @staticmethod
    def _own_calls(scope: ast.AST):
        """Call nodes in this function, not in defs nested inside it."""
        roots = (
            [scope.body]
            if isinstance(scope, ast.Lambda)
            else list(ast.iter_child_nodes(scope))
        )
        stack = list(roots)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _callee_name(call: ast.Call) -> str | None:
        if isinstance(call.func, ast.Attribute):
            return call.func.attr
        if isinstance(call.func, ast.Name):
            return call.func.id
        return None

    def _resolve(self, call: ast.Call, caller: _Method, uni: _Universe) -> _Method | None:
        fn = call.func
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            # self.m(...)
            if isinstance(recv, ast.Name) and recv.id == "self" and caller.cls:
                m = uni.classes.get(caller.cls, {}).get(fn.attr)
                if m is not None:
                    return m
                # self.attr(...) — callable attribute set to Class(...)
                tcls = uni.attr_classes.get((caller.cls, fn.attr))
                if tcls is not None:
                    return uni.classes.get(tcls, {}).get("__call__")
            # self.attr.m(...)
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and caller.cls
            ):
                tcls = uni.attr_classes.get((caller.cls, recv.attr))
                if tcls is not None:
                    m = uni.classes.get(tcls, {}).get(fn.attr)
                    if m is not None:
                        return m
            # any other receiver: unique method name across the universe
            return uni.resolve_method(None, fn.attr)
        if isinstance(fn, ast.Name):
            # same-module function, else a class constructor
            m = uni.functions.get((caller.unit.module, fn.id))
            if m is not None:
                return m
            if fn.id in uni.classes:
                return uni.classes[fn.id].get("__init__")
        return None
