"""Observability of the port: the part of ``repro.obs`` its serving runtime
uses.

  * :mod:`repro_torch.obs.trace` — deterministic span tracer + the FlowSim
    :class:`NetEventBridge`;
  * :mod:`repro_torch.obs.metrics` — counters/gauges/histograms behind one
    :class:`MetricRegistry`, plus the :class:`StatBlock` base the serving
    stats dataclasses share.

The ledgers, the SLO monitor and the exporters are not ported yet; the
runtime takes ``ledger=None`` and its caller supplies one.  Everything here
is off by default: :data:`NULL_TRACER` keeps every site a no-op.
"""

from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    StatBlock,
)
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
]
