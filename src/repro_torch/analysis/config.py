"""Declarative simcheck configuration for the port (``src/repro_torch``).

Everything the rules treat as policy lives here — scopes, the allowed
import edges, determinism allowlists, the sanctioned event-reaction APIs —
so a reader can audit the port's invariants in one place without reading
rule implementations.  Tests inject custom configs to drive fixtures.

It is ``repro.analysis.config``'s policy with the packages renamed, plus
the edges the port's own design adds (see ``ALLOWED_EDGES``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

__all__ = ["AnalysisConfig", "default_config", "ALLOWED_EDGES"]


# ---------------------------------------------------------------------------
# layering: the import DAG, as allowed edges
# ---------------------------------------------------------------------------
# Key = source package prefix (most specific match wins); value = target
# prefixes modules under the key may import from ``repro_torch``.  A
# module's own matched package is always allowed (intra-package imports).
# ``*`` = unconstrained (entrypoint layers).  A target may name one module
# rather than its package, and does where a package-wide edge would hide a
# cycle.
#
# The constraints the reference's history made load-bearing, kept here:
#   * repro_torch.net never imports repro_torch.obs / repro_torch.serving
#     (the tracer is duck-typed rather than add the edge);
#   * repro_torch.obs never imports repro_torch.serving or
#     repro_torch.core.simulator (the observer must not depend on the
#     observed);
#   * repro_torch.core never imports repro_torch.serving (the trace
#     generators live in repro_torch.workloads);
#   * repro_torch.workloads is the bottom: no repro_torch imports at all.
#
# The edges the port adds over the reference's table:
#   * models -> kernels.ops: the port's model calls its hand-written kernels
#     through the dispatch layer (the reference's model calls jnp oracles
#     and reaches no kernel).  Only ops, never all of kernels:
#     kernels.ref -> models.layers is the other way, so a package-wide edge
#     would let a real models <-> kernels cycle through;
#   * core and serving -> kernels.ops: the layer split (core.live_scaling)
#     runs the final norm on the rmsnorm kernel, and the engine keeps
#     ops' launch counts across its captured decode step (uncounted
#     warm-up and capture, the captured counts added per replay);
#   * models -> device: every entry point that makes tensors resolves its
#     device there (cuda by default, raising without it);
#   * kernels -> distributed: ops runs each kernel on a DTensor's local
#     blocks under the sharding rules;
#   * device is the bottom beside workloads: it imports only torch.
ALLOWED_EDGES: dict[str, tuple[str, ...]] = {
    "repro_torch.workloads": (),
    "repro_torch.distributed": (),
    "repro_torch.data": (),
    "repro_torch.analysis": (),
    "repro_torch.device": (),
    "repro_torch.models": (
        "repro_torch.distributed",
        "repro_torch.kernels.ops",
        "repro_torch.device",
    ),
    "repro_torch.configs": ("repro_torch.models", "repro_torch.distributed"),
    "repro_torch.kernels": ("repro_torch.models", "repro_torch.distributed"),
    "repro_torch.training": ("repro_torch.models", "repro_torch.distributed"),
    "repro_torch.net": ("repro_torch.core.topology", "repro_torch.core.multicast"),
    "repro_torch.obs": ("repro_torch.net", "repro_torch.workloads"),
    "repro_torch.core": (
        "repro_torch.net",
        "repro_torch.obs",
        "repro_torch.models",
        "repro_torch.configs",
        "repro_torch.workloads",
        "repro_torch.distributed",
        "repro_torch.kernels.ops",
    ),
    "repro_torch.serving": (
        "repro_torch.core",
        "repro_torch.net",
        "repro_torch.obs",
        "repro_torch.models",
        "repro_torch.configs",
        "repro_torch.workloads",
        "repro_torch.distributed",
        "repro_torch.kernels.ops",
    ),
    # entrypoints: may import anything
    "repro_torch.launch": ("*",),
}


@dataclasses.dataclass
class AnalysisConfig:
    # -- determinism ---------------------------------------------------------
    #: packages whose code must be wall-clock- and global-RNG-free
    determinism_scopes: tuple[str, ...] = (
        "repro_torch.net",
        "repro_torch.core",
        "repro_torch.obs",
        "repro_torch.serving",
    )
    #: module -> justification.  These measure REAL planning time as
    #: metadata (never simulation time), mirroring the paper's reported
    #: plan-generation costs.
    determinism_allowlist: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: {
            "repro_torch.core.multicast": "planner wall-clock gen_seconds metadata "
            "(Algorithm-11 generation cost, not simulation time)",
            "repro_torch.core.zigzag": "ILP plan-generation wall-clock ms metadata",
        }
    )
    #: call prefixes that are wall-clock reads
    wall_clock_calls: tuple[str, ...] = (
        "time.time",
        "time.time_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.process_time",
        "time.process_time_ns",
        "datetime.datetime.now",
        "datetime.datetime.utcnow",
        "datetime.datetime.today",
        "datetime.date.today",
    )
    #: np.random constructors that are fine WHEN given an explicit seed
    seeded_rng_constructors: tuple[str, ...] = (
        "numpy.random.default_rng",
        "numpy.random.Generator",
        "numpy.random.SeedSequence",
        "numpy.random.PCG64",
        "numpy.random.Philox",
        "numpy.random.MT19937",
        "random.Random",
    )

    # -- set-iteration -------------------------------------------------------
    #: packages where event ordering is fed by iteration order
    iteration_scopes: tuple[str, ...] = ("repro_torch.net", "repro_torch.core.simulator")
    #: order-insensitive consumers: a set used as the sole iterable of
    #: these calls cannot leak ordering.  ``sum`` is deliberately NOT here:
    #: float addition is non-associative, so summing a set of floats in
    #: hash order is exactly the replay hazard this rule exists to catch.
    order_insensitive_calls: frozenset[str] = frozenset(
        {"sorted", "len", "min", "max", "any", "all", "set", "frozenset"}
    )
    #: calls that preserve their argument's (arbitrary) iteration order
    order_passthrough_calls: frozenset[str] = frozenset({"list", "tuple", "iter"})
    #: reducers whose result depends on consumption order even without a
    #: visible loop (non-associative float accumulation)
    order_sensitive_reducers: frozenset[str] = frozenset({"sum"})

    # -- layering ------------------------------------------------------------
    allowed_edges: Mapping[str, Sequence[str]] = dataclasses.field(
        default_factory=lambda: dict(ALLOWED_EDGES)
    )

    # -- exact-float ---------------------------------------------------------
    float_eq_scopes: tuple[str, ...] = ("repro_torch.net",)
    #: epsilon helpers whose *call sites* establish sanctioned tolerance
    #: comparisons (==/!= touching their results is still flagged — the
    #: helpers are used with <=, never ==)
    float_eq_helpers: tuple[str, ...] = ("flow_done_eps",)

    # -- event-reentrancy ----------------------------------------------------
    #: method name registering a callback on the engine
    subscribe_method: str = "subscribe"
    #: engine internals a subscription callback must never reach: capacity
    #: mutations re-enter the full solve and re-emit events; underscore
    #: internals assume the settle loop's intermediate state
    reentrancy_forbidden: frozenset[str] = frozenset(
        {
            "_evict_failed",
            "_recompute",
            "_recompute_component",
            "_settle",
            "_set_path",
            "_cal_push",
            "_cal_pop",
            "_emit",
            "fail_link",
            "fail_device",
            "fail_leaf",
            "degrade_link",
            "recover_link",
            "recover_device",
        }
    )
    #: sanctioned reaction APIs — safe re-entry points the engine defines
    #: for use INSIDE an event.  The reachability walk treats them as
    #: opaque: calls *through* them are the supported contract.
    reentrancy_sanctioned: frozenset[str] = frozenset(
        {
            # FlowSim's in-event surface: starting/removing flows during a
            # failure event is the designed reaction path (aborts have
            # settled by emission time); estimates never mutate
            "start",
            "start_many",
            "remove",
            "estimate_transfer_time",
            # multicast execution wrappers over the same surface
            "launch",
            "cancel",
        }
    )

    # -- suffix match helpers ------------------------------------------------
    def in_scope(self, module: str, scopes: Sequence[str]) -> bool:
        return any(module == s or module.startswith(s + ".") for s in scopes)


def default_config() -> AnalysisConfig:
    return AnalysisConfig()
