"""BENCH_*.json perf-record differ — the CI perf-regression gate.

The repo records its perf trajectory as ``BENCH_<name>.json`` files
(``benchmarks.common.bench_record``: flat metrics + git SHA + seed + smoke
flag).  Committed records ARE the baseline; this tool diffs a fresh run
against them metric-by-metric and exits non-zero on regressions::

    PYTHONPATH=src python -m repro_torch.obs.perfdiff OLD.json NEW.json --tolerance 0.1
    PYTHONPATH=src python -m repro_torch.obs.perfdiff benchmarks/baselines/smoke . \\
        --tolerance 0.25 --json-out perfdiff_report.json

OLD/NEW are single records or directories of them (directory mode pairs
files by name — the CI job points OLD at the committed smoke baselines and
NEW at the repo root where the fresh smoke run just wrote).

Per-metric **direction rules** (first ``fnmatch`` wins) decide what counts
as a regression:

  * ``lower_better``  — latency/GPU-time style: worse when it grows;
  * ``higher_better`` — attainment/throughput style: worse when it shrinks;
  * ``either``        — deterministic counters/bytes: any drift beyond
    tolerance is flagged (a seeded simulation should not drift silently);
  * ``info``          — wall-clock timings: machine-dependent, never gate.

Tolerances are relative (``--tolerance``, per-rule overrides possible via
:func:`diff_records`' ``rules``); ``--atol`` floors the denominator so a
baseline of exactly 0 doesn't turn any noise into an infinite delta.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from fnmatch import fnmatch

__all__ = [
    "DEFAULT_RULES",
    "rule_for",
    "MetricDiff",
    "DiffReport",
    "diff_records",
    "diff_paths",
    "main",
]

LOWER_BETTER = "lower_better"
HIGHER_BETTER = "higher_better"
EITHER = "either"
INFO = "info"

#: ``(metric-name pattern, direction)`` or ``(pattern, direction,
#: tolerance)`` — first match wins; a 3-tuple's tolerance overrides the
#: CLI-wide one for that metric.  Wall-clock timings never gate (CI
#: runners and dev machines disagree); simulated seconds/bytes/counters
#: are deterministic under a fixed seed, so any drift beyond tolerance is
#: worth failing loudly over.
DEFAULT_RULES: tuple[tuple, ...] = (
    ("*wall_s*", INFO),
    # tracing overhead IS wall-clock derived, but it's a ratio of two
    # timings taken back-to-back on the same machine, so it gates —
    # with a wide per-rule tolerance absorbing scheduler noise on top of
    # the benchmark's own min-of-repeats stabilisation
    ("*overhead_frac*", LOWER_BETTER, 2.0),
    ("*_ms*", INFO),  # plan-gen / ILP solver wall-clock
    # flow-event throughput of the net_scale benchmark is wall-clock
    # derived, so it gates only on near-total collapse (machine speed
    # varies; note a higher-better metric can never drop more than -100%,
    # so the tolerance must stay < 1.0 to gate at all); the
    # incremental-vs-full SPEEDUP is a same-machine ratio of back-to-back
    # runs, so it gates tighter — it is the metric that catches the
    # incremental engine quietly degenerating to full solves
    ("*events_per_s*", HIGHER_BETTER, 0.9),
    ("*speedup*", HIGHER_BETTER, 0.6),
    ("*attainment*", HIGHER_BETTER),
    ("*throughput*", HIGHER_BETTER),
    ("*ttft*", LOWER_BETTER),
    ("*tbt*", LOWER_BETTER),
    ("*latency*", LOWER_BETTER),
    ("*gpu_time*", LOWER_BETTER),
    ("*gpu_seconds*", LOWER_BETTER),
    ("*", EITHER),
)

_GATED = {LOWER_BETTER, HIGHER_BETTER, EITHER}


def rule_for(name: str, rules=DEFAULT_RULES) -> tuple[str, float | None]:
    """(direction, per-rule tolerance override or None) for ``name``."""
    for rule in rules:
        if fnmatch(name, rule[0]):
            return rule[1], (rule[2] if len(rule) > 2 else None)
    return EITHER, None


def direction_for(name: str, rules=DEFAULT_RULES) -> str:
    return rule_for(name, rules)[0]


@dataclasses.dataclass
class MetricDiff:
    bench: str
    name: str
    old: float | None
    new: float | None
    rel_delta: float  # (new-old)/max(|old|, atol); 0.0 for missing/added
    direction: str
    status: str  # ok | regression | improvement | info | missing | added

    def describe(self) -> str:
        if self.status == "missing":
            return f"{self.bench}:{self.name}: missing from new record"
        if self.status == "added":
            return f"{self.bench}:{self.name}: new metric (no baseline)"
        arrow = "+" if self.rel_delta >= 0 else ""
        return (
            f"{self.bench}:{self.name}: {self.old:g} -> {self.new:g} "
            f"({arrow}{self.rel_delta * 100:.1f}%, {self.direction})"
        )


@dataclasses.dataclass
class DiffReport:
    diffs: list[MetricDiff] = dataclasses.field(default_factory=list)
    warnings: list[str] = dataclasses.field(default_factory=list)

    def regressions(self) -> list[MetricDiff]:
        return [d for d in self.diffs if d.status == "regression"]

    def improvements(self) -> list[MetricDiff]:
        return [d for d in self.diffs if d.status == "improvement"]

    def missing(self) -> list[MetricDiff]:
        return [d for d in self.diffs if d.status == "missing"]

    def extend(self, other: "DiffReport") -> None:
        self.diffs.extend(other.diffs)
        self.warnings.extend(other.warnings)

    def as_dict(self) -> dict:
        return {
            "n_metrics": len(self.diffs),
            "n_regressions": len(self.regressions()),
            "n_improvements": len(self.improvements()),
            "n_missing": len(self.missing()),
            "warnings": list(self.warnings),
            "diffs": [dataclasses.asdict(d) for d in self.diffs],
        }

    def format(self, *, verbose: bool = False) -> str:
        lines = []
        for w in self.warnings:
            lines.append(f"WARNING: {w}")
        shown = [
            d for d in self.diffs
            if verbose or d.status in ("regression", "improvement", "missing")
        ]
        if shown:
            lines.append("| metric | old | new | delta | rule | status |")
            lines.append("|---|---|---|---|---|---|")
            order = {"regression": 0, "missing": 1, "improvement": 2}
            for d in sorted(shown, key=lambda d: (order.get(d.status, 3),
                                                  d.bench, d.name)):
                old = "-" if d.old is None else f"{d.old:g}"
                new = "-" if d.new is None else f"{d.new:g}"
                delta = (
                    "-" if d.old is None or d.new is None
                    else f"{d.rel_delta * 100:+.1f}%"
                )
                lines.append(
                    f"| {d.bench}:{d.name} | {old} | {new} | {delta} "
                    f"| {d.direction} | {d.status} |"
                )
        n_reg = len(self.regressions())
        lines.append(
            f"{len(self.diffs)} metric(s) compared: {n_reg} regression(s), "
            f"{len(self.improvements())} improvement(s), "
            f"{len(self.missing())} missing"
        )
        return "\n".join(lines)


def diff_records(
    old: dict,
    new: dict,
    *,
    tolerance: float = 0.1,
    atol: float = 1e-9,
    rules=DEFAULT_RULES,
) -> DiffReport:
    """Diff two ``bench_record`` dicts metric-by-metric."""
    rep = DiffReport()
    bench = old.get("bench", new.get("bench", "?"))
    if old.get("smoke") != new.get("smoke"):
        rep.warnings.append(
            f"{bench}: comparing smoke={old.get('smoke')} baseline against "
            f"smoke={new.get('smoke')} run — magnitudes are not comparable"
        )
    if old.get("schema") != new.get("schema"):
        rep.warnings.append(
            f"{bench}: record schema changed "
            f"({old.get('schema')} -> {new.get('schema')})"
        )
    om, nm = old.get("metrics", {}), new.get("metrics", {})
    for name in sorted(set(om) | set(nm)):
        if name not in nm:
            rep.diffs.append(MetricDiff(bench, name, float(om[name]), None,
                                        0.0, direction_for(name, rules),
                                        "missing"))
            continue
        if name not in om:
            rep.diffs.append(MetricDiff(bench, name, None, float(nm[name]),
                                        0.0, direction_for(name, rules),
                                        "added"))
            continue
        ov, nv = float(om[name]), float(nm[name])
        direction, rule_tol = rule_for(name, rules)
        tol = tolerance if rule_tol is None else rule_tol
        rel = (nv - ov) / max(abs(ov), atol)
        if direction == INFO:
            status = "info"
        elif direction == LOWER_BETTER:
            status = ("regression" if rel > tol
                      else "improvement" if rel < -tol else "ok")
        elif direction == HIGHER_BETTER:
            status = ("regression" if rel < -tol
                      else "improvement" if rel > tol else "ok")
        else:  # EITHER: a seeded run drifting either way is a finding
            status = "regression" if abs(rel) > tol else "ok"
        rep.diffs.append(MetricDiff(bench, name, ov, nv, rel, direction, status))
    return rep


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _records_in(path: str) -> dict[str, str]:
    """Map BENCH_*.json basename -> full path under a directory."""
    return {
        os.path.basename(p): p
        for p in glob.glob(os.path.join(path, "BENCH_*.json"))
    }


def diff_paths(
    old_path: str,
    new_path: str,
    *,
    tolerance: float = 0.1,
    atol: float = 1e-9,
    rules=DEFAULT_RULES,
) -> DiffReport:
    """Diff two records, or two directories of records paired by filename."""
    if os.path.isdir(old_path) != os.path.isdir(new_path):
        raise ValueError("OLD and NEW must both be files or both directories")
    if not os.path.isdir(old_path):
        return diff_records(_load(old_path), _load(new_path),
                            tolerance=tolerance, atol=atol, rules=rules)
    rep = DiffReport()
    olds, news = _records_in(old_path), _records_in(new_path)
    if not olds:
        rep.warnings.append(f"no BENCH_*.json records under {old_path}")
    for name in sorted(olds):
        if name not in news:
            rep.warnings.append(f"{name}: baseline has no fresh counterpart")
            continue
        rep.extend(diff_records(_load(olds[name]), _load(news[name]),
                                tolerance=tolerance, atol=atol, rules=rules))
    for name in sorted(set(news) - set(olds)):
        rep.warnings.append(f"{name}: fresh record has no committed baseline")
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.perfdiff",
        description="diff BENCH_*.json perf records; exit non-zero on "
        "regressions (per-metric direction rules, relative tolerance)",
    )
    ap.add_argument("old", help="baseline record or directory of records")
    ap.add_argument("new", help="fresh record or directory of records")
    ap.add_argument("--tolerance", type=float, default=0.1,
                    help="relative tolerance before a drift gates (default 0.1)")
    ap.add_argument("--atol", type=float, default=1e-9,
                    help="denominator floor for zero baselines")
    ap.add_argument("--json-out", default=None,
                    help="write the full diff report (JSON) here")
    ap.add_argument("--fail-on-missing", action="store_true",
                    help="also fail when a baseline metric disappeared")
    ap.add_argument("--verbose", action="store_true",
                    help="print every compared metric, not just findings")
    args = ap.parse_args(argv)

    rep = diff_paths(args.old, args.new, tolerance=args.tolerance,
                     atol=args.atol)
    print(rep.format(verbose=args.verbose))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep.as_dict(), f, indent=1, sort_keys=True)
        print(f"report -> {args.json_out}")
    failed = bool(rep.regressions()) or (
        args.fail_on_missing and rep.missing()
    )
    if failed:
        print("PERF GATE: FAIL", file=sys.stderr)
        return 1
    print("PERF GATE: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
