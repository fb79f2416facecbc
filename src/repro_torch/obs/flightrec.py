"""Anomaly-triggered flight recorder: always-on ring, dump-on-incident.

The streaming SLO monitor can *page* and the FlowSim can kill a leaf —
but until now both fired into the void: by the time anyone looks, the
interesting window (what was on the wire, which scale op was mid-flight,
what the health surface said) is gone.  A :class:`FlightRecorder` is the
production answer: it keeps a bounded, always-on ring of recent
:class:`~repro_torch.net.events.NetEvent`\\ s (a
:class:`~repro_torch.net.events.FlowEventLog` ring buffer) next to the span
tracer, and when an anomaly fires it dumps one **byte-deterministic,
Perfetto-loadable incident bundle**:

  * the last ``window_s`` seconds of spans as regular ``traceEvents``
    (load the file at https://ui.perfetto.dev — unknown top-level keys
    are ignored by the viewer);
  * an ``incident`` header: the trigger + context, the trailing event
    ring (with the ring's ``dropped`` count surfaced, and an explicit
    ``truncated`` flag when eviction is known to have eaten into the
    window), the scale-op critical-path report
    (:mod:`repro_torch.obs.critical_path`), the ``fleet_health()`` snapshot,
    and the link ledger's per-group busy split when one is attached.

Triggers:

  * ``net:device_failed`` / ``net:leaf_failed`` — FlowSim failure events
    observed through the recorder's own subscription (``attach``);
  * ``slo:page`` — the SLO monitor's fleet status escalated to ``page``
    (edge-triggered: one bundle per escalation, re-armed when the fleet
    recovers).  Polled by the host control loop (``Simulator._monitor``,
    ``FleetScheduler.tick``).

Everything is observational: the recorder subscribes like any other
FlowEventLog (subscribers never mutate the data plane), all timestamps
come from the simulation clock, and file contents are
``sort_keys``-serialized — a seeded run produces byte-identical bundles
every time, which is what lets a test pin one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from repro_torch.net import events as ev
from repro_torch.obs.critical_path import analyze_scale_ops, summarize_scale_ops
from repro_torch.obs.export import _clean, chrome_trace_doc
from repro_torch.obs.trace import NULL_TRACER

__all__ = ["FlightRecorder", "TRIGGER_KINDS"]

#: the NetEvent kinds that trigger a dump (link failures are survivable
#: re-routes; device/leaf deaths lose capacity and abort flows)
TRIGGER_KINDS = frozenset({ev.DEVICE_FAILED, ev.LEAF_FAILED})


class FlightRecorder:
    """Bounded always-on recording + deterministic incident bundles."""

    def __init__(
        self,
        tracer=None,
        *,
        window_s: float = 5.0,
        ring: int = 1024,
        slo_monitor=None,
        link_ledger=None,
        metrics=None,
        out_dir: str = "incidents",
        max_dumps: int = 8,
    ):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.window_s = float(window_s)
        self.ring = ev.FlowEventLog(maxlen=ring)
        self.slo_monitor = slo_monitor
        self.link_ledger = link_ledger
        self.metrics = metrics
        self.out_dir = out_dir
        self.max_dumps = max_dumps
        self.dumps: list[str] = []  # written bundle paths, in order
        self.skipped = 0  # triggers suppressed by the max_dumps cap
        self._last_status = "ok"
        self._warned_truncated = False

    # -- wiring --------------------------------------------------------------
    def attach(self, flowsim) -> "FlightRecorder":
        """Subscribe to a FlowSim: every NetEvent lands in the ring and
        failure events trigger a dump.  Purely observational — the golden
        flow-event stream of the run is bit-for-bit unchanged."""
        flowsim.subscribe(self._on_net_event)
        return self

    def _on_net_event(self, event: ev.NetEvent) -> None:
        self.ring(event)
        if event.kind in TRIGGER_KINDS:
            ctx: dict[str, Any] = {"kind": event.kind}
            if event.device is not None:
                ctx["device"] = event.device
            if event.leaf is not None:
                ctx["leaf"] = event.leaf
            self.trigger(f"net:{event.kind}", event.t, ctx)

    def poll(self, now: float) -> None:
        """Control-loop hook: dump when the SLO monitor's fleet status
        escalates to ``page`` (edge-triggered — re-armed on recovery)."""
        if self.slo_monitor is None:
            return
        health = self.slo_monitor.fleet_health(now)
        status = health.get("status", "ok")
        if status == "page" and self._last_status != "page":
            paging = sorted(
                name for name, t in health.get("tenants", {}).items()
                if t.get("status") == "page"
            )
            self.trigger("slo:page", now, {"tenants": paging})
        self._last_status = status

    # -- dumping -------------------------------------------------------------
    def trigger(self, trigger: str, t: float, context: dict | None = None) -> str | None:
        """Dump an incident bundle now; returns the path (None when the
        ``max_dumps`` cap suppressed it — a failure storm must not turn
        the recorder into the incident)."""
        if len(self.dumps) >= self.max_dumps:
            self.skipped += 1
            if self.metrics is not None:
                self.metrics.counter("flightrec.skipped_dumps").inc()
            return None
        path = os.path.join(
            self.out_dir,
            f"incident-{len(self.dumps):03d}-{trigger.replace(':', '-')}.json",
        )
        os.makedirs(self.out_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.render(trigger, t, context))
        self.dumps.append(path)
        if self.metrics is not None:
            self.metrics.counter("flightrec.dumps").inc()
        return path

    def render(self, trigger: str, t: float, context: dict | None = None) -> str:
        """The bundle bytes (separated from :meth:`trigger` so tests can
        pin determinism without touching the filesystem)."""
        w0 = t - self.window_s
        spans = list(self.tracer.spans)
        window = [
            s for s in spans
            if s.t0 <= t and (s.t1 is None or s.t1 >= w0)
        ]
        doc = chrome_trace_doc(window)

        truncated = self.ring.truncated_since(w0)
        if truncated and not self._warned_truncated:
            # one-time, not per-dump: a steady-state undersized ring would
            # otherwise bury the signal in its own warnings
            self._warned_truncated = True
            if self.metrics is not None:
                self.metrics.counter("flightrec.truncated_dumps").inc()

        # the op mid-flight at the incident is exactly the interesting one:
        # analyze open spans as-if closed at the trigger time, so its
        # makespan-so-far partition appears in the bundle
        closed = [
            s if s.t1 is not None else dataclasses.replace(s, t1=max(t, s.t0))
            for s in spans
        ]
        cp = analyze_scale_ops(closed, link_ledger=self.link_ledger)
        cp_summary = summarize_scale_ops(
            [r for r in cp if r.t1 >= w0 and r.t0 <= t]
        )

        doc["incident"] = {
            "schema": 1,
            "trigger": trigger,
            "t": t,
            "window_s": self.window_s,
            "seq": len(self.dumps),
            "context": _clean(context or {}),
            "ring": {
                "maxlen": self.ring.maxlen,
                "retained": len(self.ring),
                "dropped": self.ring.dropped,
                "truncated": truncated,
                "events": [e.render() for e in self.ring.since(w0)],
            },
            "critical_path": cp_summary,
            "fleet_health": (
                self.slo_monitor.fleet_health(t)
                if self.slo_monitor is not None else None
            ),
            "link_busy_by_group": (
                self.link_ledger.busy_by_group()
                if self.link_ledger is not None else None
            ),
        }
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))
