"""Trace exporters: Chrome trace-event JSON (Perfetto-viewable) + text form.

``chrome_trace`` renders a span list as the Chrome ``traceEvents`` JSON
format — load the file at https://ui.perfetto.dev (or chrome://tracing) to
see request lifecycles and scale operations on per-track lanes.  Output is
**byte-deterministic** for a deterministic span list: spans are emitted in
sid order, dict keys are sorted, track→tid assignment follows first
appearance, and every number derives from simulation state (never the wall
clock) — which is what lets the golden test pin a seeded run's export
byte-for-byte.

``text_trace`` is the compact one-line-per-span form the unit tests diff;
``load_chrome`` parses an exported JSON back into :class:`Span` objects so
``repro_torch.obs.report`` can analyse traces from disk as well as in-process.
"""

from __future__ import annotations

import json
from typing import Iterable

from repro_torch.obs.trace import Span

__all__ = ["chrome_trace", "chrome_trace_doc", "text_trace", "load_chrome"]

_US = 1e6  # chrome trace timestamps are microseconds


def _clean(v):
    """JSON-safe attr values (tuples -> lists; exotic objects -> repr-free
    str so no memory addresses can leak into a golden file)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _clean(x) for k, x in sorted(v.items())}
    return str(v)


def _tid_for(spans: Iterable[Span]) -> dict[str, int]:
    """track name -> tid, in order of first appearance (deterministic)."""
    tids: dict[str, int] = {}
    for s in spans:
        name = s.track or "main"
        if name not in tids:
            tids[name] = len(tids) + 1
    return tids


def chrome_trace_doc(spans: list[Span], *, pid: int = 1) -> dict:
    """The Chrome trace-event document as a dict — callers that need to
    attach extra top-level keys (Perfetto ignores unknown ones, which is
    what lets the flight recorder ship a single-file incident bundle that
    still loads in the trace viewer) embed alongside ``traceEvents``
    before serializing."""
    ordered = sorted(spans, key=lambda s: s.sid)
    tids = _tid_for(ordered)
    events: list[dict] = [
        {
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "name": "thread_name",
            "args": {"name": track},
        }
        for track, tid in tids.items()
    ]
    for s in ordered:
        t1 = s.t1 if s.t1 is not None else s.t0
        args = {"sid": s.sid, "parent": s.parent}
        for k, v in s.attrs.items():
            args[k] = _clean(v)
        base = {
            "name": s.name,
            "cat": s.cat or "default",
            "pid": pid,
            "tid": tids[s.track or "main"],
            "ts": s.t0 * _US,
            "args": args,
        }
        if t1 > s.t0:
            base["ph"] = "X"
            base["dur"] = (t1 - s.t0) * _US
        else:
            base["ph"] = "i"
            base["s"] = "t"
        events.append(base)
    return {"displayTimeUnit": "ms", "traceEvents": events}


def chrome_trace(spans: list[Span], *, pid: int = 1) -> str:
    """Render ``spans`` as a Chrome trace-event JSON string."""
    return json.dumps(
        chrome_trace_doc(spans, pid=pid),
        sort_keys=True,
        separators=(",", ":"),
    )


def text_trace(spans: list[Span]) -> list[str]:
    """One deterministic line per span: ``sid parent cat name t0 t1 k=v…``
    (repr floats — bit-for-bit comparable, like the flow-event golden)."""
    out = []
    for s in sorted(spans, key=lambda x: x.sid):
        parts = [
            str(s.sid),
            str(s.parent) if s.parent is not None else "-",
            s.cat or "-",
            s.name,
            repr(float(s.t0)),
            repr(float(s.t1)) if s.t1 is not None else "open",
        ]
        for k in sorted(s.attrs):
            parts.append(f"{k}={_clean(s.attrs[k])}")
        out.append(" ".join(parts))
    return out


def load_chrome(source: str) -> list[Span]:
    """Parse a ``chrome_trace`` export (JSON string or file path) back into
    spans — the report CLI's on-disk entry point."""
    text = source
    if not source.lstrip().startswith("{"):
        with open(source) as f:
            text = f.read()
    doc = json.loads(text)
    tracks: dict[int, str] = {}
    spans: list[Span] = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tracks[e["tid"]] = e["args"]["name"]
    for e in doc.get("traceEvents", []):
        ph = e.get("ph")
        if ph not in ("X", "i"):
            continue
        args = dict(e.get("args", {}))
        sid = args.pop("sid", len(spans))
        parent = args.pop("parent", None)
        t0 = e["ts"] / _US
        t1 = t0 + (e.get("dur", 0.0) / _US)
        spans.append(
            Span(
                sid=sid,
                name=e["name"],
                cat=e.get("cat", ""),
                t0=t0,
                t1=t1,
                parent=parent,
                track=tracks.get(e.get("tid")),
                attrs=args,
            )
        )
    spans.sort(key=lambda s: s.sid)
    return spans
