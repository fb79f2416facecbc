"""Observability of the port: the part of ``repro.obs`` its serving runtime
uses.

  * :mod:`repro_torch.obs.trace` — deterministic span tracer + the FlowSim
    :class:`NetEventBridge`;
  * :mod:`repro_torch.obs.metrics` — counters/gauges/histograms behind one
    :class:`MetricRegistry`, plus the :class:`StatBlock` base the serving
    stats dataclasses share;
  * :mod:`repro_torch.obs.ledger` — the device-second ledger (exclusive
    states, exact conservation through ``total()``) and per-link busy time
    by flow kind: the GPU-time accounting of the MaaS fleet;
  * :mod:`repro_torch.obs.slo` — streaming SLO monitor: P² quantiles,
    burn-rate windows, ``fleet_health()``.

The exporters, the flight recorder and the report tools are not ported yet.
Everything here is off by default: :data:`NULL_TRACER` keeps every site a
no-op, and the runtime and the fleet take ``ledger=None`` and
``slo_monitor=None`` unless their caller supplies one.
"""

from repro_torch.obs.ledger import DEVICE_STATES, DeviceTimeLedger, LinkLedger
from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    StatBlock,
)
from repro_torch.obs.slo import P2Quantile, SLOMonitor
from repro_torch.obs.trace import NULL_TRACER, NetEventBridge, NullTracer, Span, Tracer

__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "NetEventBridge",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "StatBlock",
    "DEFAULT_LATENCY_BUCKETS_S",
    "DEVICE_STATES",
    "DeviceTimeLedger",
    "LinkLedger",
    "P2Quantile",
    "SLOMonitor",
]
