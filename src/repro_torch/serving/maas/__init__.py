"""Serverless multi-model MaaS control plane (paper §1, §5.3).

N models share one GPU fleet: a :class:`FleetScheduler` arbitrates free
devices between per-model :class:`~repro_torch.serving.disagg.runtime.ClusterRuntime`s
(priority = SLO pressure × queue depth), parks idle models at *zero*
accelerators — only the single O(1) host copy in the shared
:class:`~repro_torch.core.parameter_pool.ParameterPool` survives — and cold-starts
them back in seconds by re-multicasting from that copy (or any surviving
GPU copy).  Starved hot models preempt idle ones.
"""

from repro_torch.serving.maas.fleet import FleetPolicy, FleetScheduler, FleetStats
from repro_torch.serving.maas.tenant import (
    ACTIVE,
    DRAINING,
    LATENCY,
    THROUGHPUT,
    ZERO,
    Tenant,
    TenantStats,
)

__all__ = [
    "ACTIVE",
    "DRAINING",
    "FleetPolicy",
    "FleetScheduler",
    "FleetStats",
    "LATENCY",
    "THROUGHPUT",
    "Tenant",
    "TenantStats",
    "ZERO",
]
