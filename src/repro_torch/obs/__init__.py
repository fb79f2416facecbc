"""Observability of the port: the copy of ``repro.obs``.

  * :mod:`repro_torch.obs.trace` — deterministic span tracer + the FlowSim
    :class:`NetEventBridge`;
  * :mod:`repro_torch.obs.metrics` — counters/gauges/histograms behind one
    :class:`MetricRegistry`, plus the :class:`StatBlock` base the serving
    stats dataclasses share;
  * :mod:`repro_torch.obs.ledger` — the device-second ledger (exclusive
    states, exact conservation through ``total()``) and per-link busy time
    by flow kind: the GPU-time accounting of the MaaS fleet;
  * :mod:`repro_torch.obs.slo` — streaming SLO monitor: P² quantiles,
    burn-rate windows, ``fleet_health()``;
  * :mod:`repro_torch.obs.export` — Chrome trace-event JSON (Perfetto) and
    the deterministic text form the golden tests pin;
  * :mod:`repro_torch.obs.report` — TTFT attribution CLI
    (``python -m repro_torch.obs.report``);
  * :mod:`repro_torch.obs.critical_path` — scale-operation makespan
    attribution (``python -m repro_torch.obs.report --scale-ops``) with an
    exact conservation invariant (segments telescope to the span window in
    rational arithmetic);
  * :mod:`repro_torch.obs.flightrec` — anomaly-triggered flight recorder:
    always-on NetEvent ring + deterministic Perfetto-loadable incident
    bundles on SLO page / device failure;
  * :mod:`repro_torch.obs.steplog` — the serving engine's step log: one
    record a decode step, its phases on the host clock and its device time
    (:data:`STEP_LOG`, process-wide, a bounded ring).

All of it is host code (stdlib and numpy): it makes no tensor and touches no
device.  Everything here but the step log is off by default:
:data:`NULL_TRACER` keeps every site a no-op, and the runtime and the fleet
take ``ledger=None`` and ``slo_monitor=None`` unless their caller supplies
one.  The step log is always on: one tuple a step, read by an operator
(``STEP_LOG.totals()``) or a benchmark.
"""

from repro_torch.obs.critical_path import (
    SCALE_SEGMENTS,
    BottleneckHop,
    ScaleOpReport,
    analyze_scale_ops,
    format_scale_report,
    summarize_scale_ops,
)
from repro_torch.obs.export import chrome_trace, chrome_trace_doc, load_chrome, text_trace
from repro_torch.obs.flightrec import FlightRecorder
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
from repro_torch.obs.steplog import STEP_LOG, StepLog, StepRecord
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
    "chrome_trace",
    "chrome_trace_doc",
    "text_trace",
    "load_chrome",
    "SCALE_SEGMENTS",
    "BottleneckHop",
    "ScaleOpReport",
    "analyze_scale_ops",
    "summarize_scale_ops",
    "format_scale_report",
    "FlightRecorder",
    "STEP_LOG",
    "StepLog",
    "StepRecord",
]
