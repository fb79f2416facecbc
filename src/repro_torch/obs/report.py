"""Tail-latency attribution report: where does each request's TTFT go?

The paper's headline (Fig. 17: up to 94% lower tail TTFT) is a claim about
*causes* — queueing behind busy instances vs waiting for parameters to
load vs network contention.  This report answers it per request from the
span trace: every ``request`` root span's TTFT window is decomposed into
its child spans by category

  * ``queue``     — waiting behind other requests on an active instance;
  * ``load``      — waiting for the serving instance's parameters to
                    arrive (the scale-up data plane: what BLITZSCALE's
                    multicast shrinks and ServerlessLLM's SSD path bloats);
  * ``compute``   — the prefill forward pass itself;
  * ``migration`` / ``network`` — KV transfer and raw flow time (post-TTFT
                    for the first token, but reported for the full
                    request lifecycle).

and the aggregate view splits the population at the median and the p99 so
the tail's dominant cause is immediately visible — the paper's Fig-17
story, but queryable.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.report trace.json
    PYTHONPATH=src python -m repro_torch.obs.report --sim --system blitz \\
        --duration 20 --min-attribution 0.95

``--sim`` runs a seeded :class:`repro_torch.core.simulator.Simulator` with
tracing enabled (no trace file needed); ``--min-attribution`` exits
non-zero when any finished request's TTFT is less than the given fraction
attributed to named spans — the CI smoke gate.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from repro_torch.obs.export import chrome_trace, load_chrome
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "RequestAttribution",
    "attribute_requests",
    "summarize",
    "format_report",
    "run_traced_sim",
    "main",
]

#: categories that partition the TTFT window (emitted by the simulator)
TTFT_CAUSES = ("queue", "load", "compute")
#: categories reported over the request's whole lifetime
ALL_CAUSES = TTFT_CAUSES + ("migration", "network")


@dataclasses.dataclass
class RequestAttribution:
    rid: int
    arrival: float
    ttft: float
    by_cause: dict[str, float]  # seconds inside the TTFT window, per cause
    lifetime_by_cause: dict[str, float]  # over the whole request span
    attributed: float  # sum of TTFT_CAUSES inside the window
    frac: float  # attributed / ttft


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


def attribute_requests(spans: list[Span]) -> list[RequestAttribution]:
    """Per-request TTFT decomposition from a span trace.  Requests whose
    prefill never finished (no ``ttft`` attr) are skipped."""
    out: list[RequestAttribution] = []
    for root in spans:
        if root.name != "request":
            continue
        ttft = root.attrs.get("ttft")
        if ttft is None:
            continue
        ttft = float(ttft)
        w0, w1 = root.t0, root.t0 + ttft
        window: dict[str, float] = {}
        lifetime: dict[str, float] = {}
        for s in _descendants(spans, root):
            if s.cat not in ALL_CAUSES or s.t1 is None:
                continue
            lifetime[s.cat] = lifetime.get(s.cat, 0.0) + (s.t1 - s.t0)
            ov = min(s.t1, w1) - max(s.t0, w0)
            if ov > 0.0:
                window[s.cat] = window.get(s.cat, 0.0) + ov
        attributed = sum(window.get(c, 0.0) for c in TTFT_CAUSES)
        out.append(
            RequestAttribution(
                rid=root.attrs.get("rid", -1),
                arrival=root.t0,
                ttft=ttft,
                by_cause=window,
                lifetime_by_cause=lifetime,
                attributed=attributed,
                frac=min(attributed / ttft, 1.0) if ttft > 0 else 1.0,
            )
        )
    return out


def summarize(reqs: list[RequestAttribution]) -> dict:
    """Aggregate attribution: overall percentiles + per-cause breakdown of
    the median half vs the p99 tail — which cause makes the tail slow."""
    if not reqs:
        return {"n_requests": 0}
    ttfts = np.array([r.ttft for r in reqs])
    p50 = float(np.percentile(ttfts, 50))
    p99 = float(np.percentile(ttfts, 99))

    def mean_by_cause(group: list[RequestAttribution]) -> dict[str, float]:
        if not group:
            return {c: 0.0 for c in TTFT_CAUSES}
        return {
            c: float(np.mean([r.by_cause.get(c, 0.0) for r in group]))
            for c in TTFT_CAUSES
        }

    tail = [r for r in reqs if r.ttft >= p99]
    median_half = [r for r in reqs if r.ttft <= p50]
    tail_means = mean_by_cause(tail)
    tail_total = sum(tail_means.values()) or 1.0
    dominant = max(tail_means, key=lambda c: tail_means[c])
    return {
        "n_requests": len(reqs),
        "ttft_p50_s": p50,
        "ttft_p99_s": p99,
        "ttft_mean_s": float(np.mean(ttfts)),
        "min_attribution_frac": float(min(r.frac for r in reqs)),
        "mean_attribution_frac": float(np.mean([r.frac for r in reqs])),
        "median_by_cause_s": mean_by_cause(median_half),
        "tail_by_cause_s": tail_means,
        "tail_share_by_cause": {c: tail_means[c] / tail_total for c in tail_means},
        "tail_dominant_cause": dominant,
        "requests": [dataclasses.asdict(r) for r in reqs],
    }


def format_report(summary: dict) -> str:
    if not summary.get("n_requests"):
        return "no finished requests in trace"
    lines = [
        f"requests analysed: {summary['n_requests']}",
        f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms | "
        f"p99 {summary['ttft_p99_s'] * 1e3:.1f} ms | "
        f"mean {summary['ttft_mean_s'] * 1e3:.1f} ms",
        f"TTFT attributed to named spans: min "
        f"{summary['min_attribution_frac'] * 100:.1f}% / mean "
        f"{summary['mean_attribution_frac'] * 100:.1f}%",
        "",
        "| cause | median-half mean (ms) | p99-tail mean (ms) | tail share |",
        "|---|---|---|---|",
    ]
    for c in TTFT_CAUSES:
        lines.append(
            f"| {c} | {summary['median_by_cause_s'][c] * 1e3:.2f} "
            f"| {summary['tail_by_cause_s'][c] * 1e3:.2f} "
            f"| {summary['tail_share_by_cause'][c] * 100:.1f}% |"
        )
    lines.append("")
    lines.append(
        f"tail (p99) TTFT is dominated by: {summary['tail_dominant_cause']}"
    )
    return "\n".join(lines)


def run_traced_sim(
    *,
    system: str = "blitz",
    model: str = "8b",
    duration: float = 20.0,
    rate: float = 4.0,
    seed: int = 0,
    latency: bool = True,
):
    """Run a small seeded simulation with tracing enabled; returns
    ``(tracer, sim_result)``.  The entry point CI's attribution smoke and
    the golden Chrome-trace test share."""
    # lazy import: --sim is a CLI convenience that drives the simulator it
    # normally only *observes*; library code in repro_torch.obs must never depend
    # on repro_torch.core.simulator (the DAG runs the other way)
    from repro_torch.core import simulator as sim_mod  # simcheck: disable=layering -- CLI --sim entrypoint, not library code
    from repro_torch.workloads import traces

    systems = {
        "blitz": sim_mod.BLITZ,
        "blitz-nolive": sim_mod.BLITZ_NOLIVE,
        "blitz-naive": sim_mod.BLITZ_NAIVE,
        "sllm": sim_mod.SLLM,
        "allcache": sim_mod.ALLCACHE,
        "ssd": sim_mod.SSD_ONLY,
    }
    tracer = Tracer()
    s = sim_mod.Simulator(
        systems[system],
        sim_mod.profile_for(model),
        seed=seed,
        tracer=tracer,
        link_latency_s=2e-5 if latency else 0.0,
        switch_latency_s=5e-6 if latency else 0.0,
    )
    trace = traces.burstgpt(duration=duration, base_rate=rate, seed=seed + 11)
    result = s.run(trace)
    return tracer, result


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="attribute each request's TTFT to named spans "
        "(queue/load/compute) and break down tail vs median by cause",
    )
    ap.add_argument("trace", nargs="?", help="chrome-trace JSON exported by repro_torch.obs")
    ap.add_argument("--sim", action="store_true",
                    help="run a small seeded simulator instead of reading a file")
    ap.add_argument("--system", default="blitz")
    ap.add_argument("--model", default="8b")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-latency", action="store_true",
                    help="--sim: disable the per-hop latency model")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the full summary (per-request rows included) here")
    ap.add_argument("--chrome-out", default=None,
                    help="--sim: also export the Chrome trace JSON here")
    ap.add_argument("--min-attribution", type=float, default=None,
                    help="exit non-zero when any request's TTFT attribution "
                    "falls below this fraction (CI gate)")
    ap.add_argument("--scale-ops", action="store_true",
                    help="report scale-operation critical paths (makespan "
                    "partitioned into plan/queue/transfer/stall/cutover) "
                    "instead of request TTFT")
    ap.add_argument("--min-makespan-attribution", type=float, default=None,
                    help="--scale-ops: exit non-zero when any scale op's "
                    "makespan coverage falls below this fraction (CI gate, "
                    "mirrors --min-attribution)")
    args = ap.parse_args(argv)

    if args.sim:
        tracer, _ = run_traced_sim(
            system=args.system, model=args.model, duration=args.duration,
            rate=args.rate, seed=args.seed, latency=not args.no_latency,
        )
        spans = list(tracer.spans)
        if args.chrome_out:
            with open(args.chrome_out, "w") as f:
                f.write(chrome_trace(spans))
            print(f"chrome trace -> {args.chrome_out}")
    elif args.trace:
        spans = load_chrome(args.trace)
    else:
        ap.error("give a trace file or --sim")

    if args.scale_ops:
        from repro_torch.obs.critical_path import (
            analyze_scale_ops,
            format_scale_report,
            summarize_scale_ops,
        )

        reports = analyze_scale_ops(spans)
        summary = summarize_scale_ops(reports)
        print(format_scale_report(reports, summary))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(summary, f, indent=1, sort_keys=True)
            print(f"\nsummary -> {args.json_out}")
        if args.min_makespan_attribution is not None:
            if not reports:
                print("FAIL: no closed scale_op spans to attribute",
                      file=sys.stderr)
                sys.exit(1)
            bad = [r for r in reports
                   if r.coverage < args.min_makespan_attribution]
            if bad:
                worst = min(bad, key=lambda r: r.coverage)
                print(
                    f"FAIL: {len(bad)} scale op(s) below "
                    f"{args.min_makespan_attribution:.0%} makespan "
                    f"attribution (worst sid={worst.sid} at "
                    f"{worst.coverage:.1%})",
                    file=sys.stderr,
                )
                sys.exit(1)
            print(
                f"makespan attribution gate OK: all {len(reports)} "
                f"scale ops >= {args.min_makespan_attribution:.0%}"
            )
        return summary

    reqs = attribute_requests(spans)
    summary = summarize(reqs)
    print(format_report(summary))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        print(f"\nsummary -> {args.json_out}")
    if args.min_attribution is not None:
        if not reqs:
            print("FAIL: no finished requests to attribute", file=sys.stderr)
            sys.exit(1)
        low = [r for r in reqs if r.frac < args.min_attribution]
        if low:
            print(
                f"FAIL: {len(low)} request(s) below "
                f"{args.min_attribution:.0%} TTFT attribution "
                f"(worst rid={min(low, key=lambda r: r.frac).rid} at "
                f"{min(r.frac for r in low):.1%})",
                file=sys.stderr,
            )
            sys.exit(1)
        print(
            f"attribution gate OK: all {len(reqs)} requests >= "
            f"{args.min_attribution:.0%}"
        )
    return summary


if __name__ == "__main__":
    main()
