"""Span-based cross-layer tracer with deterministic IDs.

A :class:`Span` is one named, categorised interval of simulation time with
an optional causal parent — request lifecycle spans
(``request`` → ``load_wait``/``queue`` → ``prefill`` → ``kv_transfer`` →
``decode``) and scale-operation spans (``scale_op`` → ``plan`` →
``flow:multicast_hop`` → ``layer_arrival`` → ``serving``) both nest this
way.  IDs are monotone integers assigned in emission order and times come
from the caller's simulation clock, never the wall clock, so a seeded run
produces a byte-identical trace every time (the golden-trace property the
Chrome-export tests pin).

Tracing is **zero-cost when disabled**: the default collaborator everywhere
is :data:`NULL_TRACER`, whose methods are argument-ignoring no-ops that
return a shared dummy span, and instrumented call sites guard any non-
trivial attribute computation behind ``tracer.enabled``.  No subscriber is
attached to the FlowSim unless a real tracer is installed, so existing
golden flow-event traces are bit-for-bit unchanged.

:class:`NetEventBridge` adapts the FlowSim's :class:`~repro.net.events
.NetEvent` subscription stream into spans: each flow's started→completed/
aborted lifecycle becomes one ``network``-category span, and scenario
mutations (link degraded/failed, device/leaf failed) become instant
events.  ``pin(flow, parent)`` attaches a causal parent *before* the flow
starts — how a KV stream lands under its request span and a multicast hop
under its scale operation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.net import events as ev

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "NetEventBridge"]


@dataclasses.dataclass
class Span:
    """One interval of simulation time.  ``t1 is None`` = still open;
    ``t1 == t0`` = instant event."""

    sid: int
    name: str
    cat: str
    t0: float
    t1: float | None = None
    parent: int | None = None  # parent span's sid (causal link)
    track: str | None = None  # display lane (Chrome-trace thread)
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    @property
    def closed(self) -> bool:
        return self.t1 is not None


_NULL_SPAN = Span(sid=-1, name="", cat="", t0=0.0, t1=0.0)


class Tracer:
    """Collects spans; IDs are emission-ordered integers (deterministic)."""

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self._next_sid = 0

    def _parent_sid(self, parent) -> int | None:
        if isinstance(parent, Span):
            return parent.sid if parent.sid >= 0 else None
        return parent

    def begin(
        self,
        name: str,
        t: float,
        *,
        cat: str = "",
        parent: "Span | int | None" = None,
        track: str | None = None,
        **attrs: Any,
    ) -> Span:
        """Open a span at simulation time ``t``.  ``track`` defaults to the
        parent's (children render in their root's display lane)."""
        if track is None and isinstance(parent, Span) and parent.sid >= 0:
            track = parent.track
        s = Span(
            self._next_sid, name, cat, float(t),
            parent=self._parent_sid(parent), track=track, attrs=attrs,
        )
        self._next_sid += 1
        self.spans.append(s)
        return s

    def end(self, span: Span, t: float, **attrs: Any) -> None:
        """Close ``span`` at ``t`` (clamped so t1 >= t0; re-closing and the
        null span are no-ops)."""
        if span is None or span.sid < 0 or span.t1 is not None:
            return
        span.t1 = max(float(t), span.t0)
        if attrs:
            span.attrs.update(attrs)

    def span(
        self, name: str, t0: float, t1: float, **kw: Any
    ) -> Span:
        """Emit an already-closed span (for intervals known only in
        hindsight, e.g. queue wait measured when service starts)."""
        s = self.begin(name, t0, **kw)
        s.t1 = max(float(t1), s.t0)
        return s

    def instant(self, name: str, t: float, **kw: Any) -> Span:
        s = self.begin(name, t, **kw)
        s.t1 = s.t0
        return s

    # -- lifecycle -----------------------------------------------------------
    def open_spans(self) -> list[Span]:
        return [s for s in self.spans if s.t1 is None]

    def close_open(self, t: float, **attrs: Any) -> int:
        """Close every still-open span at ``t`` (end of a run: background
        flows and unfinished requests must not leave dangling spans).
        Returns how many were closed."""
        n = 0
        for s in self.spans:
            if s.t1 is None:
                self.end(s, t, **attrs)
                n += 1
        return n

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children_of(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent == span.sid]


class NullTracer:
    """The zero-cost default: every method is a no-op returning a shared
    dummy span, so instrumented code never branches on ``None``."""

    enabled = False
    spans: tuple = ()

    def begin(self, *a: Any, **kw: Any) -> Span:
        return _NULL_SPAN

    def end(self, *a: Any, **kw: Any) -> None:
        return None

    def span(self, *a: Any, **kw: Any) -> Span:
        return _NULL_SPAN

    def instant(self, *a: Any, **kw: Any) -> Span:
        return _NULL_SPAN

    def close_open(self, *a: Any, **kw: Any) -> int:
        return 0


NULL_TRACER = NullTracer()


class NetEventBridge:
    """FlowSim subscriber turning :class:`NetEvent`\\ s into spans.

    Subscribe it exactly like a :class:`FlowEventLog`::

        bridge = NetEventBridge(tracer)
        flowsim.subscribe(bridge)

    Flow lifecycle edges open/close one span per flow; scenario mutations
    become instant events.  A consumer that knows a flow's causal context
    calls ``pin(flow, parent_span)`` before starting it — optionally
    renaming/recategorising the span (the simulator pins per-request KV
    flows as ``kv_transfer``/``migration`` under the request span)."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._open: dict[int, Span] = {}  # id(flow) -> span
        self._pins: dict[int, tuple] = {}  # id(flow) -> (parent, name, cat)
        # (parent sid, chain) -> {hop idx -> first hop-span sid}: lets hop k
        # record its upstream hop's sid as an ATTR rather than a tree parent
        # (pipelined hops overlap their upstream's interval, so tree-nesting
        # them would violate the child-within-parent well-formedness that
        # the span tests pin)
        self._hops: dict[tuple, dict[int, int]] = {}

    def pin(
        self, flow, parent: Span | None, *, name: str | None = None,
        cat: str | None = None,
    ) -> None:
        self._pins[id(flow)] = (parent, name, cat)

    def pin_all(self, flows, parent: Span | None, **kw: Any) -> None:
        for f in flows:
            self.pin(f, parent, **kw)

    def __call__(self, event: ev.NetEvent) -> None:
        k = event.kind
        if k == ev.FLOW_STARTED:
            f = event.flow
            parent, name, cat = self._pins.pop(id(f), (None, None, None))
            extra: dict[str, Any] = {}
            chain = getattr(f, "chain", None)
            key = None
            if chain is not None:
                extra["chain"] = chain
                extra["hop"] = f.hop
                if f.extra_latency_s > 0.0:
                    # the store-and-forward prefix charged for upstream hops:
                    # the critical-path analyzer splits a hop's duration into
                    # latency vs bandwidth/contention with it
                    extra["lat"] = f.extra_latency_s
                psid = parent.sid if isinstance(parent, Span) else parent
                if psid is not None:  # unpinned flows have no stable scope
                    key = (psid, chain)
                    up = self._hops.get(key, {}).get(f.hop - 1)
                    if up is not None:
                        extra["upstream"] = up  # sid of the hop this one forwards
            sp = self.tracer.begin(
                name or f"flow:{f.kind.value}",
                event.t,
                cat=cat or "network",
                parent=parent,
                track=None if parent is not None else "net",
                kind=f.kind.value,
                src=f.src,
                dst=f.dst,
                size=float(f.size),
                tag=f.tag,
                **extra,
            )
            if key is not None:
                self._hops.setdefault(key, {}).setdefault(f.hop, sp.sid)
            self._open[id(f)] = sp
        elif k in (ev.FLOW_COMPLETED, ev.FLOW_ABORTED):
            sp = self._open.pop(id(event.flow), None)
            if sp is not None:
                if k == ev.FLOW_ABORTED:
                    self.tracer.end(sp, event.t, aborted=True)
                else:
                    self.tracer.end(sp, event.t)
        else:  # link/device/leaf scenario mutations
            attrs: dict[str, Any] = {}
            if event.link_key is not None:
                attrs["link"] = ":".join(str(x) for x in event.link_key)
            if event.device is not None:
                attrs["device"] = event.device
            if event.leaf is not None:
                attrs["leaf"] = event.leaf
            self.tracer.instant(k, event.t, cat="net", track="net", **attrs)
