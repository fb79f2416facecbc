"""Rule ``layering`` — imports follow the declarative allowed-edges DAG.

The config (``repro_torch.analysis.config.ALLOWED_EDGES``) maps each package
prefix to the package prefixes it may import from ``repro_torch``; the most
specific source prefix wins, a module's own package is always allowed,
and ``*`` marks unconstrained entrypoint layers.  Both module-level and
function-level (lazy) imports are checked — a lazy import is still a
dependency; the pragma mechanism exists for the rare sanctioned ones
(e.g. ``repro_torch.obs.report``'s ``--sim`` CLI mode driving the simulator it
normally only observes).

The same import scan feeds ``--import-graph dot|json`` dumps so the
*actual* DAG is documentable.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import AnalysisContext, Finding, Rule, SourceUnit, register

__all__ = ["LayeringRule", "collect_imports", "import_graph", "graph_to_dot", "graph_to_json"]


def collect_imports(unit: SourceUnit) -> list[tuple[str, int, int, bool]]:
    """Repro-internal imports of one unit:
    ``(imported module, line, col, is_module_level)``."""
    out: list[tuple[str, int, int, bool]] = []
    toplevel = set(unit.tree.body)
    for node in ast.walk(unit.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "repro_torch" or a.name.startswith("repro_torch."):
                    out.append((a.name, node.lineno, node.col_offset, node in toplevel))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module == "repro_torch" or node.module.startswith("repro_torch."):
                # record per-alias targets: ``from repro_torch.core import
                # multicast`` depends on repro_torch.core.multicast, not on all
                # of repro_torch.core (symbol imports over-qualify — e.g.
                # repro_torch.core.topology.Topology — which prefix matching
                # absorbs)
                for a in node.names:
                    target = (
                        node.module if a.name == "*" else f"{node.module}.{a.name}"
                    )
                    out.append((target, node.lineno, node.col_offset, node in toplevel))
    return out


def _match_prefix(module: str, prefixes) -> str | None:
    """Longest configured prefix that covers ``module``."""
    best = None
    for p in prefixes:
        if module == p or module.startswith(p + "."):
            if best is None or len(p) > len(best):
                best = p
    return best


@register
class LayeringRule(Rule):
    id = "layering"
    summary = "imports must follow the declarative allowed-edges DAG"

    def check_file(self, unit: SourceUnit, ctx: AnalysisContext) -> Iterator[Finding]:
        edges = ctx.config.allowed_edges
        src_pkg = _match_prefix(unit.module, edges.keys())
        if src_pkg is None:
            return  # module outside any configured layer: unconstrained
        allowed = tuple(edges[src_pkg])
        if "*" in allowed:
            return
        for target, line, col, toplevel in collect_imports(unit):
            if target == src_pkg or target.startswith(src_pkg + "."):
                continue  # intra-package
            if _match_prefix(target, allowed) is not None:
                continue
            kind = "import" if toplevel else "lazy (function-level) import"
            yield Finding(
                rule=self.id,
                path=unit.path,
                line=line,
                col=col,
                symbol=f"{unit.module} -> {target}",
                message=(
                    f"{kind} of {target!r} from layer {src_pkg!r} violates "
                    f"the import DAG (allowed: "
                    f"{', '.join(allowed) if allowed else 'nothing from repro_torch'})"
                ),
            )


# ---------------------------------------------------------------------------
# import-graph dumps
# ---------------------------------------------------------------------------


def import_graph(units: list[SourceUnit]) -> dict:
    """Actual module-level import graph over the scanned units."""
    nodes = sorted({u.module for u in units})

    def collapse(target: str) -> str:
        # map symbol-level targets back onto scanned modules so the graph
        # stays module-granular (repro_torch.net.flows.Flow -> repro_torch.net.flows)
        best = None
        for n in nodes:
            if target == n or target.startswith(n + "."):
                if best is None or len(n) > len(best):
                    best = n
        return best if best is not None else target

    edges = []
    for u in sorted(units, key=lambda u: u.module):
        seen: set[tuple[str, bool]] = set()
        for target, _line, _col, toplevel in collect_imports(u):
            dst = collapse(target)
            k = (dst, toplevel)
            if k in seen or dst == u.module:
                continue
            seen.add(k)
            edges.append({"src": u.module, "dst": dst, "toplevel": toplevel})
    edges.sort(key=lambda e: (e["src"], e["dst"], not e["toplevel"]))
    return {"nodes": nodes, "edges": edges}


def graph_to_json(graph: dict) -> str:
    import json

    return json.dumps(graph, indent=2, sort_keys=True) + "\n"


def graph_to_dot(graph: dict) -> str:
    """Graphviz dump, one cluster per top-level package; dashed = lazy
    (function-level) edges."""
    def pkg(m: str) -> str:
        parts = m.split(".")
        return ".".join(parts[:2]) if len(parts) > 1 else m

    clusters: dict[str, list[str]] = {}
    for n in graph["nodes"]:
        clusters.setdefault(pkg(n), []).append(n)
    lines = ["digraph imports {", "  rankdir=LR;", "  node [shape=box, fontsize=10];"]
    for i, (p, members) in enumerate(sorted(clusters.items())):
        lines.append(f'  subgraph "cluster_{i}" {{')
        lines.append(f'    label="{p}";')
        for m in sorted(members):
            lines.append(f'    "{m}";')
        lines.append("  }")
    for e in graph["edges"]:
        style = "" if e["toplevel"] else " [style=dashed]"
        lines.append(f'  "{e["src"]}" -> "{e["dst"]}"{style};')
    lines.append("}")
    return "\n".join(lines) + "\n"
