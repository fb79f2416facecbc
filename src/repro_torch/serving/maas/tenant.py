"""One model's seat in the MaaS fleet (paper §1, §5.3).

A :class:`Tenant` wraps a per-model :class:`ClusterRuntime` with the state
the fleet scheduler arbitrates on: lifecycle (ACTIVE → DRAINING → ZERO →
ACTIVE again on cold start), how long the model has been idle, and the
accounting the paper's Fig. 18 comparison needs (GPU-seconds actually
occupied, cold starts, preemptions suffered).

Scale-to-zero is what makes the fleet *serverless*: a parked model holds no
accelerator at all — only its single O(1) host-DRAM copy in the shared
:class:`ParameterPool` — and rejoins in seconds via a multicast cold start.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.metrics import StatBlock
from repro_torch.serving.disagg.runtime import ClusterRuntime

ACTIVE = "active"  # has engines (possibly some draining) and may serve
DRAINING = "draining"  # fleet decided scale-to-zero; engines finishing up
ZERO = "zero"  # no engines, no devices — only the O(1) host copy remains

# SLO classes: a latency-tier tenant's pressure is weighted up in fleet
# arbitration (it wins ties for free devices and is shed LAST under
# admission control); throughput-tier tenants tolerate queueing.
LATENCY = "latency"
THROUGHPUT = "throughput"
CLASS_WEIGHTS = {LATENCY: 4.0, THROUGHPUT: 1.0}


@dataclasses.dataclass
class TenantStats(StatBlock):
    # cold starts live on runtime.stats (the runtime performs them); here is
    # only what the FLEET decides about this tenant
    scaled_to_zero: int = 0
    preempted: int = 0
    rejected: int = 0  # requests shed by fleet admission control
    gpu_seconds: float = 0.0  # device-seconds actually occupied by engines


class Tenant:
    """Per-model fleet seat: runtime + lifecycle + arbitration signals."""

    def __init__(
        self,
        name: str,
        runtime: ClusterRuntime,
        slo_class: str = LATENCY,
        class_weight: float | None = None,
    ):
        self.name = name
        self.runtime = runtime
        self.state = ACTIVE
        self.idle_since: float | None = None
        if class_weight is None and slo_class not in CLASS_WEIGHTS:
            # a typo'd tier would silently land in the lowest (sheddable)
            # class — an SLO inversion the operator never asked for
            raise ValueError(
                f"unknown slo_class {slo_class!r}; expected one of "
                f"{sorted(CLASS_WEIGHTS)} (or pass class_weight explicitly)"
            )
        self.slo_class = slo_class
        self.class_weight = (
            CLASS_WEIGHTS[slo_class] if class_weight is None else class_weight
        )
        self.stats = TenantStats()

    # -- arbitration signals -------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.runtime.router.queue)

    @property
    def busy(self) -> bool:
        return self.runtime.n_outstanding > 0

    def priority(self) -> float:
        """Fleet-arbitration priority: class weight × SLO pressure × queue
        depth — the latency tier outranks the throughput tier at equal load.

        A parked (or fully drained) tenant with waiting work outranks every
        warm tenant — cold starts are the most latency-critical grant the
        fleet makes (the request is already ageing against its TTFT SLO);
        among cold-starters the fleet tie-breaks on class weight."""
        if self.runtime.n_serving == 0 and self.queue_depth > 0:
            return float("inf")
        return self.class_weight * self.runtime.slo_pressure() * (1.0 + self.queue_depth)

    # -- lifecycle helpers ---------------------------------------------------
    def note_arrival(self) -> None:
        self.idle_since = None
        if self.state == DRAINING:
            # work arrived mid-drain: the tenant is live again (remaining
            # drains proceed; the autoscaler re-grows capacity as needed)
            self.state = ACTIVE

    def fully_drained(self) -> bool:
        return (
            self.state == DRAINING
            and self.runtime.n_engines == 0
            and self.runtime.n_outstanding == 0
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Tenant({self.name!r}, {self.state}, engines={self.runtime.n_engines}, "
            f"queue={self.queue_depth})"
        )
