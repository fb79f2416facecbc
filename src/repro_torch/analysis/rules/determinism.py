"""Rule ``determinism`` — no wall-clock or unseeded global RNG in the core.

A single ``time.time()`` or ``random.random()`` inside the simulation
core breaks every golden trace, every byte-deterministic incident bundle
and the incremental-vs-full FlowSim differential oracle at once — and
does so silently, because nothing diffs against wall-clock.  Banned in
the configured scopes:

  * wall-clock reads (``time.time/perf_counter/monotonic/...``,
    ``datetime.now`` and friends);
  * the global ``random`` module (``random.Random(seed)`` is fine);
  * ``numpy.random`` module-level functions (``np.random.rand`` draws
    from hidden global state) and seedable constructors called WITHOUT a
    seed (``np.random.default_rng()`` seeds from the OS).

Planner modules that report real plan-generation cost as metadata are
allowlisted in the config with a justification.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import AnalysisContext, Finding, Rule, SourceUnit, register

__all__ = ["DeterminismRule"]


@register
class DeterminismRule(Rule):
    id = "determinism"
    summary = "no wall-clock / unseeded global RNG in simulation-core packages"

    def check_file(self, unit: SourceUnit, ctx: AnalysisContext) -> Iterator[Finding]:
        cfg = ctx.config
        if not cfg.in_scope(unit.module, cfg.determinism_scopes):
            return
        if unit.module in cfg.determinism_allowlist:
            return
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            name = unit.dotted_name(node.func)
            if name is None:
                continue
            bad = self._classify(name, node, cfg)
            if bad is not None:
                yield Finding(
                    rule=self.id,
                    path=unit.path,
                    line=node.lineno,
                    col=node.col_offset,
                    symbol=name,
                    message=bad,
                )

    @staticmethod
    def _classify(name: str, call: ast.Call, cfg) -> str | None:
        if name in cfg.wall_clock_calls:
            return (
                f"wall-clock read {name}() in simulation core — goldens and "
                "differential oracles replay on the simulation clock only"
            )
        if name in cfg.seeded_rng_constructors:
            if not call.args and not call.keywords:
                return (
                    f"{name}() without an explicit seed draws entropy from "
                    "the OS — pass a seed so runs replay bit-for-bit"
                )
            return None
        if name.startswith("random."):
            return (
                f"global-state RNG {name}() — use a seeded "
                "numpy.random.default_rng / random.Random instance instead"
            )
        if name.startswith("numpy.random."):
            return (
                f"{name}() draws from numpy's hidden global RNG — use a "
                "seeded numpy.random.default_rng(seed) generator"
            )
        return None
