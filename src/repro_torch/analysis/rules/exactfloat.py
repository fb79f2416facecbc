"""Rule ``exact-float`` — no bare ``==``/``!=`` between floats in repro_torch.net.

Flow completion in the data plane is an epsilon discipline: the live
engine and ``estimate_transfer_time`` share ``flow_done_eps`` so the
incremental and full solvers settle the same flow at the same instant.
A bare float equality anywhere else in ``repro_torch.net`` is either a logic
bug waiting for an FMA-rounding difference, or a deliberate sentinel
compare — in which case it carries ``# simcheck: exact-float`` (the
shorthand pragma) and a reader knows it was deliberate.

Float-typedness is inferred heuristically, no type checker required:
float literals, ``float(...)`` / ``math.inf`` / ``math.nan``, true
division results, names and ``self.X`` attributes annotated ``float``
(function params, locals, dataclass fields of classes in the same file),
and calls to same-file functions annotated ``-> float``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import AnalysisContext, Finding, Rule, SourceUnit, register

__all__ = ["ExactFloatRule"]


def _annotation_is_float(node: ast.expr | None) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Name):
        return node.id == "float"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.strip() == "float"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _annotation_is_float(node.left) or _annotation_is_float(node.right)
    return False


class _FloatEnv:
    """Names/attributes/functions inferred float-typed within one file."""

    def __init__(self, unit: SourceUnit):
        self.float_attrs: set[str] = set()  # dataclass/class fields
        self.float_funcs: set[str] = set()  # same-file defs returning float
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name
                    ):
                        if _annotation_is_float(item.annotation):
                            self.float_attrs.add(item.target.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _annotation_is_float(node.returns):
                    self.float_funcs.add(node.name)

    def scope_names(self, fn: ast.AST) -> set[str]:
        """Float-annotated params and locals of one function."""
        names: set[str] = set()
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = fn.args
            for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
                if _annotation_is_float(a.annotation):
                    names.add(a.arg)
        for node in ast.walk(fn):
            if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                if _annotation_is_float(node.annotation):
                    names.add(node.target.id)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                if isinstance(node.targets[0], ast.Name) and self._value_is_float(
                    node.value, set()
                ):
                    names.add(node.targets[0].id)
        return names

    def _value_is_float(self, node: ast.expr, local_names: set[str]) -> bool:
        """Expression is float-typed (conservative heuristic)."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, float)
        if isinstance(node, ast.Name):
            return node.id in local_names
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "math":
                return node.attr in {"inf", "nan", "pi", "e", "tau"}
            return node.attr in self.float_attrs
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name):
                return fn.id == "float" or fn.id in self.float_funcs
            if isinstance(fn, ast.Attribute):
                return fn.attr in self.float_funcs
            return False
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Div):
                return True  # true division is float-valued
            return self._value_is_float(node.left, local_names) or self._value_is_float(
                node.right, local_names
            )
        if isinstance(node, ast.UnaryOp):
            return self._value_is_float(node.operand, local_names)
        if isinstance(node, ast.IfExp):
            return self._value_is_float(node.body, local_names) or self._value_is_float(
                node.orelse, local_names
            )
        return False


@register
class ExactFloatRule(Rule):
    id = "exact-float"
    summary = "float ==/!= must use flow_done_eps helpers or carry a pragma"

    def check_file(self, unit: SourceUnit, ctx: AnalysisContext) -> Iterator[Finding]:
        cfg = ctx.config
        if not cfg.in_scope(unit.module, cfg.float_eq_scopes):
            return
        env = _FloatEnv(unit)
        # comparisons live inside some enclosing scope; find that scope's
        # float-annotated names once per function
        scopes: list[tuple[ast.AST, set[str]]] = [(unit.tree, set())]
        for node in ast.walk(unit.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append((node, env.scope_names(node)))
        for scope, names in scopes:
            for node in self._own_compares(scope):
                for op, left, right in self._eq_pairs(node):
                    if env._value_is_float(left, names) or env._value_is_float(
                        right, names
                    ):
                        sym = ast.get_source_segment(unit.text, node) or "<cmp>"
                        yield Finding(
                            rule=self.id,
                            path=unit.path,
                            line=node.lineno,
                            col=node.col_offset,
                            symbol=sym.split("\n")[0][:80],
                            message=(
                                f"exact float {op} in {sym.split(chr(10))[0][:60]!r} — "
                                f"compare through {'/'.join(cfg.float_eq_helpers)} "
                                "(<= eps) or mark the sentinel compare with "
                                "'# simcheck: exact-float'"
                            ),
                        )
                        break  # one finding per comparison chain

    @staticmethod
    def _own_compares(scope: ast.AST):
        """Compare nodes belonging to this scope (not nested functions)."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Compare):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _eq_pairs(cmp: ast.Compare):
        operands = [cmp.left, *cmp.comparators]
        for i, op in enumerate(cmp.ops):
            if isinstance(op, (ast.Eq, ast.NotEq)):
                sym = "==" if isinstance(op, ast.Eq) else "!="
                yield sym, operands[i], operands[i + 1]
