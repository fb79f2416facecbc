"""simcheck CLI — ``python -m repro_torch.analysis.check [paths...]``.

Exit codes: 0 = clean (or every finding baselined), 1 = findings (or
stale baseline entries), 2 = usage/config error.  ``--format json`` /
``--json-out`` emit a machine-readable report (CI uploads it as an
artifact); ``--rule`` filters for local iteration; ``--fix-sorted``
attaches ready-to-apply ``sorted(...)`` patches to iteration-order
findings (printed, never applied); ``--import-graph dot|json`` dumps the
actual import graph instead of checking.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.config import default_config
from repro_torch.analysis.core import AnalysisContext, Finding, all_rules, load_tree, run_rules
from repro_torch.analysis.rules.layering import graph_to_dot, graph_to_json, import_graph

__all__ = ["main", "run_check"]


def run_check(
    paths: list[str],
    *,
    config=None,
    baseline: Baseline | None = None,
    only: list[str] | None = None,
    fix_sorted: bool = False,
) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Library entry: -> (new findings, baselined findings, stale entries)."""
    units = load_tree(paths)
    ctx = AnalysisContext(
        config=config if config is not None else default_config(),
        units=units,
        fix_sorted=fix_sorted,
    )
    findings = run_rules(ctx, only=only)
    bl = baseline if baseline is not None else Baseline.empty()
    return bl.split(findings)


def _text_report(
    new: list[Finding], old: list[Finding], stale: list[dict], out
) -> None:
    for f in new:
        print(f.format(), file=out)
        if f.suggestion:
            for line in f.suggestion.splitlines():
                print(f"    {line}", file=out)
    for f in old:
        print(f"{f.format()}  [baselined]", file=out)
    for e in stale:
        print(
            f"stale baseline entry (finding no longer fires — delete it): "
            f"{e['rule']}:{e['path']}:{e['symbol']!r}",
            file=out,
        )
    n_rules = len({f.rule for f in new})
    if new or stale:
        print(
            f"simcheck: {len(new)} finding(s) across {n_rules} rule(s), "
            f"{len(stale)} stale baseline entr(ies)",
            file=out,
        )
    else:
        extra = f" ({len(old)} baselined)" if old else ""
        print(f"simcheck: clean{extra}", file=out)


def _json_report(new, old, stale) -> dict:
    return {
        "findings": [f.as_dict() for f in new],
        "baselined": [f.as_dict() for f in old],
        "stale_baseline_entries": stale,
        "counts": {"new": len(new), "baselined": len(old), "stale": len(stale)},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.check",
        description="repo-specific static analysis: determinism, layering, "
        "set-iteration, exact-float and event-reentrancy invariants",
    )
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to scan (default: src/repro_torch)")
    ap.add_argument("--baseline", help="committed baseline JSON (grandfathered findings)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline from current findings "
                    "(justifications must then be filled in by hand)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="RULE",
                    help="run only this rule (repeatable); see --list-rules")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--fix-sorted", action="store_true",
                    help="attach sorted(...) rewrite patches to "
                    "set-iteration findings (printed, not applied)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--json-out", metavar="FILE",
                    help="also write the JSON report to FILE")
    ap.add_argument("--import-graph", choices=("dot", "json"),
                    help="dump the actual import graph and exit")
    ap.add_argument("--import-graph-out", metavar="FILE",
                    help="write the import-graph dump to FILE instead of stdout")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid:18s} {rule.summary}")
        return 0

    if args.import_graph:
        units = load_tree(args.paths)
        graph = import_graph(units)
        text = graph_to_dot(graph) if args.import_graph == "dot" else graph_to_json(graph)
        if args.import_graph_out:
            with open(args.import_graph_out, "w", encoding="utf-8") as fh:
                fh.write(text)
            print(f"wrote {args.import_graph_out}")
        else:
            sys.stdout.write(text)
        return 0

    baseline = Baseline.empty()
    if args.baseline and not args.update_baseline:
        try:
            baseline = Baseline.load(args.baseline)
        except FileNotFoundError:
            print(f"simcheck: baseline {args.baseline} not found", file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"simcheck: {e}", file=sys.stderr)
            return 2

    try:
        new, old, stale = run_check(
            args.paths,
            baseline=baseline,
            only=args.rules,
            fix_sorted=args.fix_sorted,
        )
    except KeyError as e:
        print(f"simcheck: {e.args[0]}", file=sys.stderr)
        return 2

    if args.update_baseline:
        if not args.baseline:
            print("simcheck: --update-baseline requires --baseline", file=sys.stderr)
            return 2
        Baseline.from_findings(new + old).save(args.baseline)
        print(
            f"simcheck: wrote {len(new + old)} entr(ies) to {args.baseline} — "
            "fill in every justification before committing"
        )
        return 0

    report = _json_report(new, old, stale)
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if args.format == "json":
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        _text_report(new, old, stale, sys.stdout)
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
