"""Scale-operation critical-path attribution: where did the makespan go?

The TTFT report (:mod:`repro_torch.obs.report`) explains the *request* side of
the paper's headline; this module explains the *scaling* side.  λScale's
observation — and BLITZSCALE's Fig. 13/14 design pressure — is that a
scale-up's makespan is dominated by whichever multicast chain hop or
layer-stall sits on the critical path.  For every closed ``scale_op``
span this analyzer partitions the end-to-end window ``[t0, t1]`` into
causally-ordered, mutually-exclusive segments:

  * ``plan``     — Algorithm-11 plan generation (the ``plan`` instant's
                   offset from the op start; zero in the simulator, where
                   planning is modelled as instantaneous);
  * ``queue``    — grant/queue wait: the op is decided but no parameter
                   byte is moving yet (fleet arbitration latency, FlowSim
                   admission);
  * ``transfer`` — at least one of the op's pinned parameter flows
                   (multicast hop / AllGather / cold-start unicast) is in
                   flight;
  * ``stall``    — no flow is moving but downstream instances are still
                   waiting on layer propagation (the
                   ``stalled_waiting_layers`` window the DeviceTimeLedger
                   accrues device-side);
  * ``cutover``  — every flow has landed; the control-plane activation
                   window (CUDA-context pool / pre-lowered executables,
                   §A.1) until the op closes.

**Conservation is exact, not within-epsilon**: segment values are
accumulated in rational arithmetic (``fractions.Fraction`` over the span
boundaries, which represents every float exactly), and the elementary
intervals telescope, so ``sum(exact_breakdown().values()) ==
Fraction(t1) - Fraction(t0)`` holds bit-for-bit for every op — the same
conservation-by-construction idiom as the
:class:`~repro_torch.obs.ledger.DeviceTimeLedger`.  The float view
(:meth:`ScaleOpReport.breakdown`) sums in one fixed segment order, so
``sum(breakdown().values()) == attributed_s`` is also exact.

The analyzer also identifies the **bottleneck hop** — the longest pinned
parameter flow — and classifies why it was slow:

  * ``latency``    — the store-and-forward prefix (the ``lat`` attr the
                     tracer bridge stamps from ``Flow.extra_latency_s``)
                     dominates its duration: a deep chain under per-hop
                     switching delay, the thing the latency-aware planner
                     trades width against;
  * ``contention`` — its realized rate fell well below the best sibling
                     hop's rate: another flow squeezed its max-min share
                     (the competing flow-kind group is named from the
                     :class:`~repro_torch.obs.ledger.LinkLedger` when one is
                     attached);
  * ``bandwidth``  — neither: the hop ran at (or near) the best rate any
                     hop achieved — link-rate bound, the healthy case.

CLI: ``python -m repro_torch.obs.report --sim --scale-ops`` (the
``--min-makespan-attribution`` flag is the CI gate mirroring the ≥95%
TTFT-attribution gate).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

from repro_torch.obs.trace import Span

__all__ = [
    "SCALE_SEGMENTS",
    "BottleneckHop",
    "ScaleOpReport",
    "analyze_scale_ops",
    "summarize_scale_ops",
    "format_scale_report",
]

#: exclusive makespan segments; the FIXED summation order behind the
#: conservation invariant — never reorder (attributed_s and breakdown()
#: both iterate it, which is what makes their sums bit-identical)
SCALE_SEGMENTS = ("plan", "queue", "transfer", "stall", "cutover")

#: a hop whose realized rate is below this fraction of the best sibling
#: hop's rate lost its max-min share to competing traffic
_CONTENTION_RATE_FRAC = 0.7
#: a hop whose store-and-forward prefix exceeds this fraction of its
#: duration is latency-bound, not bandwidth-bound
_LATENCY_SHARE = 0.5


@dataclasses.dataclass
class BottleneckHop:
    """The longest parameter flow of one scale op + why it was slow."""

    sid: int
    tag: str
    kind: str
    src: int
    dst: int
    t0: float
    t1: float
    size: float
    chain: int | None
    hop: int | None
    upstream: int | None  # sid of the hop this one forwarded (attr link)
    latency_s: float  # store-and-forward prefix charged to this hop
    cause: str  # latency | contention | bandwidth
    competing_group: str | None = None  # from the LinkLedger, if attached

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    @property
    def rate(self) -> float:
        return self.size / self.duration if self.duration > 0 else 0.0


@dataclasses.dataclass
class ScaleOpReport:
    """One ``scale_op`` span's exact makespan partition."""

    sid: int
    t0: float
    t1: float
    phase: str
    plane: str
    n_instances: int
    n_flows: int
    segments_exact: dict[str, Fraction]  # SCALE_SEGMENTS order, exact
    bottleneck: BottleneckHop | None
    aborted: bool = False

    @property
    def makespan(self) -> float:
        return self.t1 - self.t0

    def breakdown(self) -> dict[str, float]:
        """Per-segment seconds, every segment present, SCALE_SEGMENTS
        order (the float view of the exact partition)."""
        return {s: float(self.segments_exact[s]) for s in SCALE_SEGMENTS}

    @property
    def attributed_s(self) -> float:
        """Summed in SCALE_SEGMENTS order — the same floats in the same
        order as ``sum(breakdown().values())``, so that check is exact."""
        t = 0.0
        for s in SCALE_SEGMENTS:
            t += float(self.segments_exact[s])
        return t

    @property
    def coverage(self) -> float:
        """attributed / makespan — the CI-gated fraction (≥0.95 mirrors
        the TTFT-attribution gate).  1.0 for zero-width ops."""
        if self.makespan <= 0.0:
            return 1.0
        return self.attributed_s / self.makespan

    def conserved(self) -> bool:
        """The exact invariant: segments telescope to the span window in
        rational arithmetic — bit-for-bit, every op, every seed."""
        total = Fraction(0)
        for s in SCALE_SEGMENTS:
            total += self.segments_exact[s]
        return total == Fraction(self.t1) - Fraction(self.t0)

    def as_dict(self) -> dict:
        d = {
            "sid": self.sid,
            "t0": self.t0,
            "t1": self.t1,
            "phase": self.phase,
            "plane": self.plane,
            "n_instances": self.n_instances,
            "n_flows": self.n_flows,
            "makespan_s": self.makespan,
            "segments_s": self.breakdown(),
            "attributed_s": self.attributed_s,
            "coverage": self.coverage,
            "aborted": self.aborted,
        }
        if self.bottleneck is not None:
            d["bottleneck"] = dataclasses.asdict(self.bottleneck)
        return d


def _descendants(spans: list[Span], root: Span) -> list[Span]:
    kids: dict[int, list[Span]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    out: list[Span] = []
    stack = [root.sid]
    while stack:
        sid = stack.pop()
        for c in kids.get(sid, ()):
            out.append(c)
            stack.append(c.sid)
    return out


def _is_flow(span: Span) -> bool:
    return span.name.startswith("flow:") or span.cat == "network"


def _classify(flow: Span, best_rate: float, link_ledger) -> tuple[str, str | None]:
    dur = (flow.t1 or flow.t0) - flow.t0
    lat = float(flow.attrs.get("lat", 0.0))
    if dur > 0.0 and lat / dur >= _LATENCY_SHARE:
        return "latency", None
    rate = float(flow.attrs.get("size", 0.0)) / dur if dur > 0 else 0.0
    if best_rate > 0.0 and rate < _CONTENTION_RATE_FRAC * best_rate:
        competing = None
        if link_ledger is not None:
            busy = {g: v for g, v in link_ledger.busy_by_group().items()
                    if g != "multicast"}
            if busy:
                competing = max(sorted(busy), key=lambda g: busy[g])
        return "contention", competing
    return "bandwidth", None


def _analyze_one(op: Span, spans: list[Span], link_ledger) -> ScaleOpReport:
    desc = _descendants(spans, op)
    flows = sorted(
        (s for s in desc if _is_flow(s) and s.t1 is not None),
        key=lambda s: s.sid,
    )
    plan_t = min(
        (s.t0 for s in desc if s.name == "plan"), default=op.t0
    )
    t0, t1 = op.t0, op.t1

    # elementary boundaries: every flow edge (clipped to the window) plus
    # the plan instant and, for flowless simple planes, the recorded
    # control-plane tail — elementary intervals never straddle a label edge
    cuts = {t0, t1}
    if t0 < plan_t < t1:
        cuts.add(plan_t)
    for f in flows:
        for x in (f.t0, f.t1):
            if t0 < x < t1:
                cuts.add(x)
    # the recorded control-plane activation window bounds the cutover
    # segment from the right: anything between the last flow landing and
    # that window is a *stall* (straggler instances, retired-before-active
    # engines), not cutover
    control_s = float(op.attrs.get("control_s", 0.0))
    ctl_cut = max(t0, t1 - control_s) if control_s > 0.0 else None
    if ctl_cut is not None and t0 < ctl_cut < t1:
        cuts.add(ctl_cut)
    bounds = sorted(cuts)

    first_flow = min((f.t0 for f in flows), default=t1)
    last_flow = max((f.t1 for f in flows), default=t0)

    def label(a: float, b: float) -> str:
        if flows:
            for f in flows:
                if f.t0 <= a and f.t1 >= b:
                    return "transfer"
            if b <= plan_t:
                return "plan"
            if b <= first_flow:
                return "queue"
            if a >= last_flow:
                if ctl_cut is None or a >= ctl_cut:
                    return "cutover"
                return "stall"  # flows landed, instances still not active
            return "stall"  # a gap while downstream hops are still pending
        # simple data planes (ssd / hostcache / delay): one opaque load
        # interval; the span records the control-plane tail so the cutover
        # carve-out is exact, the rest is the data-plane transfer
        if ctl_cut is not None and a >= ctl_cut:
            return "cutover"
        if b <= plan_t:
            return "plan"
        return "transfer"

    seg = {s: Fraction(0) for s in SCALE_SEGMENTS}
    for a, b in zip(bounds, bounds[1:]):
        seg[label(a, b)] += Fraction(b) - Fraction(a)

    # bottleneck: the longest parameter hop (ties -> lowest sid); prefer
    # multicast hops, fall back to whatever flow the op actually moved
    hops = [f for f in flows if f.attrs.get("kind") == "multicast_hop"] or flows
    bottleneck = None
    if hops:
        best_rate = max(
            (float(f.attrs.get("size", 0.0)) / (f.t1 - f.t0)
             for f in hops if f.t1 > f.t0),
            default=0.0,
        )
        worst = max(hops, key=lambda f: (f.t1 - f.t0, -f.sid))
        cause, competing = _classify(worst, best_rate, link_ledger)
        bottleneck = BottleneckHop(
            sid=worst.sid,
            tag=str(worst.attrs.get("tag", "")),
            kind=str(worst.attrs.get("kind", "")),
            src=int(worst.attrs.get("src", -1)),
            dst=int(worst.attrs.get("dst", -1)),
            t0=worst.t0,
            t1=worst.t1,
            size=float(worst.attrs.get("size", 0.0)),
            chain=worst.attrs.get("chain"),
            hop=worst.attrs.get("hop"),
            upstream=worst.attrs.get("upstream"),
            latency_s=float(worst.attrs.get("lat", 0.0)),
            cause=cause,
            competing_group=competing,
        )

    aborted = bool(op.attrs.get("aborted")) or any(
        s.attrs.get("aborted") for s in desc if s.cat == "load"
    )
    return ScaleOpReport(
        sid=op.sid,
        t0=t0,
        t1=t1,
        phase=str(op.attrs.get("phase", "?")),
        plane=str(op.attrs.get("plane", "?")),
        n_instances=int(op.attrs.get("n_instances", 1)),
        n_flows=len(flows),
        segments_exact=seg,
        bottleneck=bottleneck,
        aborted=aborted,
    )


def analyze_scale_ops(spans, *, link_ledger=None) -> list[ScaleOpReport]:
    """Partition every closed ``scale_op`` span's makespan.  Accepts the
    tracer's span list or one re-loaded from a Chrome export
    (:func:`repro_torch.obs.export.load_chrome`)."""
    spans = list(spans)
    return [
        _analyze_one(op, spans, link_ledger)
        for op in sorted(spans, key=lambda s: s.sid)
        if op.name == "scale_op" and op.t1 is not None
    ]


def summarize_scale_ops(reports: list[ScaleOpReport]) -> dict:
    """Aggregate view: coverage (the CI gate input), per-segment totals,
    and the bottleneck-cause census."""
    if not reports:
        return {"n_ops": 0}
    totals = {s: 0.0 for s in SCALE_SEGMENTS}
    for r in reports:
        for s, v in r.breakdown().items():
            totals[s] += v
    makespans = sorted(r.makespan for r in reports)
    causes: dict[str, int] = {}
    for r in reports:
        if r.bottleneck is not None:
            causes[r.bottleneck.cause] = causes.get(r.bottleneck.cause, 0) + 1
    worst = min(reports, key=lambda r: r.coverage)
    grand = sum(totals.values())
    return {
        "n_ops": len(reports),
        "n_aborted": sum(1 for r in reports if r.aborted),
        "min_coverage": worst.coverage,
        "worst_op_sid": worst.sid,
        "mean_coverage": sum(r.coverage for r in reports) / len(reports),
        "makespan_mean_s": sum(makespans) / len(makespans),
        "makespan_max_s": makespans[-1],
        "segment_totals_s": totals,
        "segment_shares": {
            s: (totals[s] / grand if grand > 0 else 0.0) for s in SCALE_SEGMENTS
        },
        "bottleneck_causes": {c: causes[c] for c in sorted(causes)},
        "ops": [r.as_dict() for r in reports],
    }


def format_scale_report(reports: list[ScaleOpReport],
                        summary: dict | None = None) -> str:
    """Deterministic text report (the golden test pins one)."""
    if not reports:
        return "no closed scale_op spans in trace"
    summary = summary if summary is not None else summarize_scale_ops(reports)
    lines = [
        f"scale ops analysed: {summary['n_ops']} "
        f"({summary['n_aborted']} aborted)",
        f"makespan attribution: min {summary['min_coverage'] * 100:.2f}% / "
        f"mean {summary['mean_coverage'] * 100:.2f}%",
        "",
        "| op | phase | t0 (s) | makespan (ms) | "
        + " | ".join(SCALE_SEGMENTS)
        + " | bottleneck | cause |",
        "|---|---|---|---|" + "---|" * len(SCALE_SEGMENTS) + "---|---|",
    ]
    for r in reports:
        b = r.breakdown()
        cells = " | ".join(f"{b[s] * 1e3:.3f}" for s in SCALE_SEGMENTS)
        bn = r.bottleneck
        lines.append(
            f"| {r.sid} | {r.phase} | {r.t0:.6f} | {r.makespan * 1e3:.3f} "
            f"| {cells} "
            f"| {bn.tag if bn else '-'} | {bn.cause if bn else '-'} |"
        )
    lines.append("")
    shares = summary["segment_shares"]
    dominant = max(SCALE_SEGMENTS, key=lambda s: shares[s])
    lines.append(
        "fleet-wide makespan shares: "
        + ", ".join(f"{s} {shares[s] * 100:.1f}%" for s in SCALE_SEGMENTS)
    )
    lines.append(f"scale-up makespan is dominated by: {dominant}")
    causes = summary["bottleneck_causes"]
    if causes:
        lines.append(
            "bottleneck hops: "
            + ", ".join(f"{c}={n}" for c, n in causes.items())
        )
    return "\n".join(lines)
