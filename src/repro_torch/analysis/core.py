"""simcheck framework core: source model, pragmas, rule registry, runner.

Everything here is stdlib-only on purpose — the checker runs before any
heavy dependency is installed (it imports neither torch nor anything it
scans), so a layering violation fails in seconds.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Callable, Iterable, Iterator, Mapping

__all__ = [
    "Finding",
    "SourceUnit",
    "AnalysisContext",
    "Rule",
    "register",
    "all_rules",
    "load_tree",
    "run_rules",
    "module_name_for",
]


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``symbol`` is a line-number-independent handle (the offending call /
    import / method chain) so baseline entries survive unrelated edits to
    the same file.
    """

    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    symbol: str = ""
    suggestion: str | None = None  # e.g. --fix-sorted patch text

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def as_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "symbol": self.symbol,
            "message": self.message,
        }
        if self.suggestion:
            d["suggestion"] = self.suggestion
        return d

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# pragmas
# ---------------------------------------------------------------------------

_PRAGMA_RE = re.compile(r"#\s*simcheck:\s*(?P<body>[^#]*)")
#: rule names are kebab-case words (or ``*``); a ``-- free text`` tail on
#: the pragma is a human-facing justification, not part of the rule list
_DISABLE_RE = re.compile(
    r"disable(?P<scope>-file)?\s*=\s*(?P<rules>(?:[\w*-]+)(?:\s*,\s*[\w*-]+)*)"
)
#: bare shorthands: ``# simcheck: exact-float`` == ``disable=exact-float``
_SHORTHAND_RULES = frozenset({"exact-float"})


def _parse_pragma(comment: str) -> tuple[frozenset[str], frozenset[str]]:
    """-> (line-disabled rules, file-disabled rules); ``*`` disables all."""
    m = _PRAGMA_RE.search(comment)
    if m is None:
        return frozenset(), frozenset()
    body = m.group("body").strip()
    line_rules: set[str] = set()
    file_rules: set[str] = set()
    matched = False
    for dm in _DISABLE_RE.finditer(body):
        matched = True
        rules = {r.strip() for r in dm.group("rules").split(",") if r.strip()}
        (file_rules if dm.group("scope") else line_rules).update(rules)
    if not matched:
        # shorthand form: the body is a bare rule name (before any "--"
        # free-text justification)
        name = body.split("--")[0].strip()
        if name in _SHORTHAND_RULES:
            line_rules.add(name)
    return frozenset(line_rules), frozenset(file_rules)


def _collect_pragmas(text: str) -> tuple[dict[int, frozenset[str]], frozenset[str]]:
    """Map line -> rules disabled on that line, plus file-wide disables.

    A standalone pragma comment (nothing but the comment on its line)
    applies to the *next* source line, so multi-line statements can carry
    a pragma without fighting formatters.
    """
    per_line: dict[int, set[str]] = {}
    file_wide: set[str] = set()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return {}, frozenset()
    lines = text.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        line_rules, file_rules = _parse_pragma(tok.string)
        file_wide |= file_rules
        if not line_rules:
            continue
        row = tok.start[0]
        src_line = lines[row - 1] if row - 1 < len(lines) else ""
        standalone = src_line.strip().startswith("#")
        target = row + 1 if standalone else row
        per_line.setdefault(target, set()).update(line_rules)
        # a pragma on the first line of a multi-line statement covers the
        # statement's header line either way
        per_line.setdefault(row, set()).update(line_rules)
    return {k: frozenset(v) for k, v in per_line.items()}, frozenset(file_wide)


# ---------------------------------------------------------------------------
# source units
# ---------------------------------------------------------------------------


def module_name_for(path: str) -> str:
    """Dotted module name for a file path.

    Rooted at the last path component named ``repro_torch`` (the port's
    import root), falling back to the bare stem for out-of-tree files
    such as test fixtures.
    """
    parts = list(os.path.normpath(path).split(os.sep))
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts.pop()
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "repro_torch":
            return ".".join(parts[i:])
    return parts[-1] if parts else ""


class SourceUnit:
    """One parsed python file plus its pragma map and import-alias table."""

    def __init__(self, path: str, text: str, module: str | None = None):
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.module = module if module is not None else module_name_for(path)
        self.tree = ast.parse(text, filename=path)
        self.line_pragmas, self.file_pragmas = _collect_pragmas(text)
        self._parents: dict[ast.AST, ast.AST] | None = None
        self._aliases: dict[str, str] | None = None

    # -- pragma queries ------------------------------------------------------
    def disabled(self, rule: str, line: int) -> bool:
        if rule in self.file_pragmas or "*" in self.file_pragmas:
            return True
        rules = self.line_pragmas.get(line, frozenset())
        return rule in rules or "*" in rules

    # -- structure helpers ---------------------------------------------------
    @property
    def parents(self) -> Mapping[ast.AST, ast.AST]:
        """Child node -> parent node map (built lazily)."""
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    @property
    def aliases(self) -> Mapping[str, str]:
        """Local name -> canonical dotted path from import statements.

        ``import numpy as np`` -> ``{"np": "numpy"}``; ``from time import
        perf_counter as pc`` -> ``{"pc": "time.perf_counter"}``.
        """
        if self._aliases is None:
            out: dict[str, str] = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        out[a.asname or a.name.split(".")[0]] = (
                            a.name if a.asname else a.name.split(".")[0]
                        )
                        if a.asname:
                            out[a.asname] = a.name
                elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                    for a in node.names:
                        if a.name == "*":
                            continue
                        out[a.asname or a.name] = f"{node.module}.{a.name}"
            self._aliases = out
        return self._aliases

    def dotted_name(self, node: ast.AST) -> str | None:
        """Canonical dotted path of a Name/Attribute chain, resolving
        import aliases (``np.random.rand`` -> ``numpy.random.rand``)."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def line_text(self, line: int) -> str:
        lines = self.text.splitlines()
        return lines[line - 1] if 0 < line <= len(lines) else ""


def load_tree(
    roots: Iterable[str], *, exclude: Iterable[str] = ("__pycache__",)
) -> list[SourceUnit]:
    """Parse every ``*.py`` under each root (or a single file root) into
    SourceUnits, sorted by path for deterministic reports."""
    excl = set(exclude)
    files: list[str] = []
    for root in roots:
        if os.path.isfile(root):
            files.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in excl)
            files.extend(
                os.path.join(dirpath, f) for f in filenames if f.endswith(".py")
            )
    units = []
    for f in sorted(files):
        with open(f, encoding="utf-8") as fh:
            units.append(SourceUnit(f, fh.read()))
    return units


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnalysisContext:
    """Everything a rule sees: the config and the full unit universe (the
    project-level rules — layering, reentrancy — need cross-file state)."""

    config: "AnalysisConfig"  # noqa: F821 - repro_torch.analysis.config
    units: list[SourceUnit]
    fix_sorted: bool = False  # iteration rule: emit rewrite suggestions

    def unit_by_module(self, module: str) -> SourceUnit | None:
        for u in self.units:
            if u.module == module:
                return u
        return None


class Rule:
    """Base class.  ``check_file`` runs per unit; ``check_project`` runs
    once over the whole universe.  Findings on pragma-disabled lines are
    filtered by ``run_rules``, not the rule."""

    id: str = ""
    summary: str = ""

    def check_file(self, unit: SourceUnit, ctx: AnalysisContext) -> Iterator[Finding]:
        return iter(())

    def check_project(self, ctx: AnalysisContext) -> Iterator[Finding]:
        return iter(())


_REGISTRY: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule to the global registry."""
    inst = rule_cls()
    if not inst.id:
        raise ValueError(f"rule {rule_cls.__name__} has no id")
    _REGISTRY[inst.id] = inst
    return rule_cls


def all_rules() -> dict[str, Rule]:
    # import for side effect: rule modules self-register
    from repro_torch.analysis import rules as _rules  # noqa: F401

    return dict(_REGISTRY)


def run_rules(
    ctx: AnalysisContext,
    *,
    only: Iterable[str] | None = None,
) -> list[Finding]:
    """Run (a filtered set of) registered rules; returns pragma-filtered
    findings sorted by (path, line, rule)."""
    rules = all_rules()
    wanted = set(only) if only is not None else None
    if wanted is not None:
        unknown = wanted - rules.keys()
        if unknown:
            raise KeyError(f"unknown rule(s): {', '.join(sorted(unknown))}")
    findings: list[Finding] = []
    units_by_path = {u.path: u for u in ctx.units}
    for rid in sorted(rules):
        if wanted is not None and rid not in wanted:
            continue
        rule = rules[rid]
        produced: list[Finding] = []
        for unit in ctx.units:
            produced.extend(rule.check_file(unit, ctx))
        produced.extend(rule.check_project(ctx))
        for f in produced:
            unit = units_by_path.get(f.path)
            if unit is not None and unit.disabled(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    return findings
