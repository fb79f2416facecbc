"""Rule ``set-iteration`` — no order-dependent iteration over sets.

Set iteration order is a function of element hashes and insertion
history; it is NOT part of the repo's replay contract.  In the net /
simulator packages an unsorted ``for x in some_set`` that feeds event
ordering, heap pushes or float accumulation changes goldens between
CPython builds and between logically-equivalent runs.  Flagged:

  * ``for``-loops and comprehension generators whose iterable is
    set-typed (set/frozenset constructors and literals, names inferred
    set-typed from annotations or assignments, unions/intersections of
    sets, ``list()/tuple()/iter()`` of a set — order passthrough);
  * iteration over dicts *built from* sets (``dict.fromkeys(s)``, dict
    comprehensions over a set) including their ``.keys()/.values()/
    .items()`` views.

Not flagged: membership tests, set-typed arguments to order-insensitive
reducers (``sorted/min/max/sum/any/all/len/set/frozenset``), and set
comprehensions (the result carries no order of its own — iterating it
later is what gets flagged).

``--fix-sorted`` attaches a ready-to-apply ``sorted(...)`` rewrite to
each finding (printed, never applied).
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import AnalysisContext, Finding, Rule, SourceUnit, register

__all__ = ["SetIterationRule"]

_SETISH = {"set", "frozenset", "Set", "FrozenSet", "AbstractSet", "MutableSet"}


def _annotation_is_set(node: ast.expr | None) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Name):
        return node.id in _SETISH
    if isinstance(node, ast.Attribute):  # typing.Set etc.
        return node.attr in _SETISH
    if isinstance(node, ast.Subscript):
        return _annotation_is_set(node.value)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):  # X | None
        return _annotation_is_set(node.left) or _annotation_is_set(node.right)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split("[")[0].strip() in _SETISH
    return False


def _target_name(node: ast.expr) -> str | None:
    """``x`` or ``self.x`` as a dotted string; None for anything fancier."""
    if isinstance(node, ast.Name):
        return node.id
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return f"self.{node.attr}"
    return None


class _Env:
    """Names inferred set-typed (or dict-built-from-set) in a scope."""

    def __init__(self, cfg):
        self.names: set[str] = set()
        self.cfg = cfg

    def is_set_expr(self, node: ast.expr) -> bool:
        cfg = self.cfg
        if isinstance(node, ast.Set):
            return True
        if isinstance(node, ast.Name) or isinstance(node, ast.Attribute):
            name = _target_name(node)
            if name is not None and name in self.names:
                return True
            # dict-view of a tracked dict-from-set: self.d.keys() handled
            # in the Call branch below
            return False
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)
        ):
            return self.is_set_expr(node.left) or self.is_set_expr(node.right)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name):
                if fn.id in {"set", "frozenset"}:
                    return True
                if (
                    fn.id in cfg.order_passthrough_calls
                    and len(node.args) == 1
                    and self.is_set_expr(node.args[0])
                ):
                    return True
                return False
            if isinstance(fn, ast.Attribute):
                # dict.fromkeys(S) keeps S's arbitrary order
                if (
                    fn.attr == "fromkeys"
                    and node.args
                    and self.is_set_expr(node.args[0])
                ):
                    return True
                # d.keys()/.values()/.items() of a dict built from a set
                if fn.attr in {"keys", "values", "items"} and not node.args:
                    return self.is_set_expr(fn.value)
                # s.union(...)/intersection/difference/copy of a set
                if fn.attr in {
                    "union",
                    "intersection",
                    "difference",
                    "symmetric_difference",
                    "copy",
                }:
                    return self.is_set_expr(fn.value)
            return False
        return False

    def absorb(self, stmt: ast.stmt) -> None:
        """Record set-typed names from one statement."""
        if isinstance(stmt, ast.AnnAssign):
            name = _target_name(stmt.target)
            if name is not None and (
                _annotation_is_set(stmt.annotation)
                or (stmt.value is not None and self.is_set_expr(stmt.value))
            ):
                self.names.add(name)
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            name = _target_name(stmt.targets[0])
            if name is not None and self.is_set_expr(stmt.value):
                self.names.add(name)
        elif isinstance(stmt, ast.AugAssign) and isinstance(
            stmt.op, (ast.BitOr, ast.BitAnd)
        ):
            name = _target_name(stmt.target)
            if name is not None and self.is_set_expr(stmt.value):
                self.names.add(name)


def _collect_env(fn: ast.AST, cfg, seed: set[str] | None = None) -> _Env:
    """Set-typed names visible inside ``fn`` (params + every assignment
    anywhere in the body, two passes for forward references)."""
    env = _Env(cfg)
    if seed:
        env.names |= seed
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        args = fn.args
        for a in [
            *args.posonlyargs,
            *args.args,
            *args.kwonlyargs,
            *([args.vararg] if args.vararg else []),
            *([args.kwarg] if args.kwarg else []),
        ]:
            if _annotation_is_set(a.annotation):
                env.names.add(a.arg)
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.stmt):
                env.absorb(node)
    return env


def _scope_walk(scope: ast.AST):
    """Walk a scope's own statements: a Module yields only module-level
    nodes (defs and classes have their own env passes); a function yields
    its whole body except nested ClassDef interiors (their methods are
    dispatched with the class env instead)."""
    if isinstance(scope, ast.Module):
        skip = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        stack = [s for s in scope.body if not isinstance(s, skip)]
    else:
        stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(scope, ast.Module) and isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(child, ast.ClassDef):
                continue  # nested class methods get their own pass
            stack.append(child)


def _class_self_sets(cls: ast.ClassDef, cfg) -> set[str]:
    """``self.X`` names any method assigns a set to (class-wide view)."""
    env = _Env(cfg)
    for _ in range(2):
        for node in ast.walk(cls):
            if isinstance(node, ast.stmt):
                env.absorb(node)
    return {n for n in env.names if n.startswith("self.")}


@register
class SetIterationRule(Rule):
    id = "set-iteration"
    summary = "iteration over sets / set-built dicts must go through sorted()"

    def check_file(self, unit: SourceUnit, ctx: AnalysisContext) -> Iterator[Finding]:
        cfg = ctx.config
        if not cfg.in_scope(unit.module, cfg.iteration_scopes):
            return
        # module scope: module-level statements only
        yield from self._check_scope(unit, ctx, unit.tree, seed=None)
        # every method gets its class's self.X set-env; top-level functions
        # stand alone; functions nested in functions ride the outer walk
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.ClassDef):
                self_sets = _class_self_sets(node, cfg)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        yield from self._check_scope(unit, ctx, item, seed=self_sets)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if isinstance(unit.parents.get(node), ast.Module):
                    yield from self._check_scope(unit, ctx, node, seed=None)

    # -- scope check ---------------------------------------------------------
    def _check_scope(
        self, unit: SourceUnit, ctx: AnalysisContext, scope: ast.AST, seed
    ) -> Iterator[Finding]:
        env = _collect_env(scope, ctx.config, seed)
        for node in _scope_walk(scope):
            if isinstance(node, ast.For):
                if env.is_set_expr(node.iter):
                    yield self._finding(unit, ctx, node.iter)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
                if self._inside_order_insensitive(unit, ctx, node):
                    continue
                for gen in node.generators:
                    if env.is_set_expr(gen.iter):
                        yield self._finding(unit, ctx, gen.iter)
            elif isinstance(node, ast.Call):
                # order-sensitive reducers consuming a set directly:
                # sum(float_set) accumulates in hash order
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id in ctx.config.order_sensitive_reducers
                    and len(node.args) >= 1
                    and env.is_set_expr(node.args[0])
                ):
                    yield self._finding(unit, ctx, node.args[0])

    def _inside_order_insensitive(
        self, unit: SourceUnit, ctx: AnalysisContext, comp: ast.AST
    ) -> bool:
        parent = unit.parents.get(comp)
        return (
            isinstance(parent, ast.Call)
            and isinstance(parent.func, ast.Name)
            and parent.func.id in ctx.config.order_insensitive_calls
            and len(parent.args) == 1
            and parent.args[0] is comp
        )

    def _finding(self, unit: SourceUnit, ctx: AnalysisContext, iter_node: ast.expr) -> Finding:
        seg = ast.get_source_segment(unit.text, iter_node) or "<expr>"
        suggestion = None
        if ctx.fix_sorted and iter_node.lineno == getattr(iter_node, "end_lineno", -1):
            line = unit.line_text(iter_node.lineno)
            patched = (
                line[: iter_node.col_offset]
                + f"sorted({seg})"
                + line[iter_node.end_col_offset :]
            )
            suggestion = (
                f"--- {unit.path}:{iter_node.lineno}\n- {line.strip()}\n+ {patched.strip()}"
            )
        return Finding(
            rule=self.id,
            path=unit.path,
            line=iter_node.lineno,
            col=iter_node.col_offset,
            symbol=seg,
            message=(
                f"iteration over set-ordered {seg!r} — wrap in sorted(...) "
                "(set order is hash/insertion dependent and breaks replay)"
            ),
            suggestion=suggestion,
        )
