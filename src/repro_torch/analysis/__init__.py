"""simcheck — repo-specific static analysis, over the port (``src/repro_torch``).

The repo's correctness story rests on invariants no off-the-shelf linter
knows about: bit-for-bit deterministic replay (goldens, byte-deterministic
incident bundles, the incremental-vs-full FlowSim oracle), a strict import
DAG, exact-float discipline around ``flow_done_eps``, and FlowSim
subscription callbacks that react to failures *inside* the event without
re-entrantly mutating the engine.  ``repro_torch.analysis`` is an AST /
import-graph checker that enforces them:

  * ``determinism``      — no wall-clock / unseeded global RNG in the
                           simulation core;
  * ``set-iteration``    — no order-dependent iteration over sets (or
                           dicts built from sets) in the event path;
  * ``layering``         — imports follow the declarative allowed-edges
                           DAG (``repro_torch.net`` never imports ``repro_torch.obs``,
                           …);
  * ``exact-float``      — ``==``/``!=`` between floats in ``repro_torch.net``
                           goes through ``flow_done_eps`` or carries an
                           explicit pragma;
  * ``event-reentrancy`` — FlowSim ``subscribe`` callbacks never reach
                           mutating engine internals except through the
                           sanctioned reaction APIs.

Run it::

    PYTHONPATH=src python -m repro_torch.analysis.check src/repro_torch \
        --baseline analysis_baseline_torch.json

It is ``repro.analysis`` pointed at the port's package graph: module names
are rooted at ``repro_torch``, the layering rule records imports of
``repro_torch``, and ``config`` holds the port's policy.

Suppress a single finding with a trailing pragma on the offending line
(``# simcheck: disable=RULE[,RULE2]``; ``# simcheck: exact-float`` is a
shorthand for the float rule), a whole file with ``# simcheck:
disable-file=RULE`` in its first comment block, or grandfather it with a
justified entry in the committed baseline.
"""

from repro_torch.analysis.core import (
    AnalysisContext,
    Finding,
    Rule,
    SourceUnit,
    all_rules,
    load_tree,
    register,
    run_rules,
)
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.config import AnalysisConfig, default_config

__all__ = [
    "AnalysisConfig",
    "AnalysisContext",
    "Baseline",
    "Finding",
    "Rule",
    "SourceUnit",
    "all_rules",
    "default_config",
    "load_tree",
    "register",
    "run_rules",
]
