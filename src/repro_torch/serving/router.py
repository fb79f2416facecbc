"""Cluster-level request router: FCFS dispatch + SLO accounting.

The router is the component between the load balancer and the per-instance
engines (Fig. 6): it keeps one FCFS queue per model, dispatches to the
least-loaded *fully-loaded* instance, and — during live scaling — routes
through the cooperative (source, target) pair per the three-step transition
protocol (§5.2): a partially-loaded engine never receives requests directly;
its work arrives via the paired source's shared priority queue.

SLO accounting matches the paper's §6.2 definition: a request violates when
TTFT or any TBT exceeds 5x the workload's average.

For PD-disaggregated serving the router additionally owns the three-step
transition handoff of a migrating request (mirroring the live-scaling
protocol of §5.2, applied to prefill→decode KV migration):

  1. PREFILLED — the prefill instance emitted the first token and froze the
                 request's KV pages; the router pins the request (no engine
                 may decode it);
  2. MIGRATING — pages are in flight on the compute network; the first
                 token is already accounted, so nothing is dropped while
                 the request is in transit;
  3. RESUMED   — the decode instance spliced the pages and continues from
                 the exact migrated position.

``complete_handoff`` verifies the resume position equals the freeze
position — a migrating request must never drop or duplicate tokens.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Any

import numpy as np


class HandoffPhase(enum.Enum):
    PREFILLED = "prefilled"
    MIGRATING = "migrating"
    RESUMED = "resumed"


@dataclasses.dataclass
class Handoff:
    rid: int
    src: int  # prefill instance/device id
    dst: int  # decode instance/device id
    tokens_frozen: int  # tokens emitted when the KV pages were frozen
    phase: HandoffPhase = HandoffPhase.PREFILLED
    t_begin: float = 0.0
    t_resume: float | None = None


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival: float
    prompt_tokens: int
    max_new_tokens: int
    ttft: float | None = None
    token_times: list = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False  # shed by admission control (never served)
    rejected_at: float | None = None

    def tbts(self) -> list[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


@dataclasses.dataclass
class SLOReport:
    n: int
    mean_ttft: float
    p99_ttft: float
    mean_tbt: float
    p99_tbt: float
    attainment: float  # fraction within 5x-average SLO (paper §6.2)


class Router:
    """FCFS router over a set of engines (objects with ``submit``/``step``
    and ``can_serve_alone``)."""

    def __init__(self):
        self.queue: deque[RequestRecord] = deque()
        self.records: dict[int, RequestRecord] = {}
        self.handoffs: dict[int, Handoff] = {}
        self.dropped: list[int] = []  # rids that lost/duplicated tokens in transit
        self.rejections: list[int] = []  # rids shed by admission control
        self._rid = 0

    def submit(self, prompt_tokens: int, max_new_tokens: int, now: float) -> int:
        self._rid += 1
        rec = RequestRecord(self._rid, now, prompt_tokens, max_new_tokens)
        self.records[rec.rid] = rec
        self.queue.append(rec)
        return rec.rid

    def dispatch(self, engines: list[Any]) -> list[tuple[RequestRecord, Any]]:
        """Assign queued requests FCFS to the least-loaded serving-capable
        engine.  Engines mid-live-scaling (can_serve_alone() False) are
        skipped — their work arrives via cooperative execution.  Requests
        pinned by an open handoff (KV pages frozen or in flight) are never
        dispatched."""
        ready = [e for e in engines if getattr(e, "can_serve_alone", lambda: True)()]
        out = []
        deferred = []
        while self.queue and ready:
            rec = self.queue.popleft()
            if self.pinned(rec.rid):
                deferred.append(rec)
                continue
            eng = min(ready, key=lambda e: len(getattr(e, "queue", [])) + len(getattr(e, "active", {})))
            out.append((rec, eng))
        self.queue.extendleft(reversed(deferred))
        return out

    # -- three-step PD handoff ----------------------------------------------
    def begin_handoff(
        self, rid: int, src: int, dst: int, tokens_frozen: int, now: float
    ) -> Handoff:
        """Step 1: freeze the request's KV pages on the prefill instance.
        While a handoff is open (PREFILLED or MIGRATING) the request is
        pinned — ``dispatch`` will never hand it to an engine."""
        h = Handoff(rid, src, dst, tokens_frozen, HandoffPhase.PREFILLED, t_begin=now)
        self.handoffs[rid] = h
        return h

    def mark_migrating(self, rid: int) -> None:
        """Step 2: the frozen pages entered the network toward ``dst``."""
        self.handoffs[rid].phase = HandoffPhase.MIGRATING

    def complete_handoff(self, rid: int, tokens_resumed: int, now: float) -> bool:
        """Step 3: the decode instance spliced the pages and resumes.  Returns
        True when the resume position matches the freeze position (no token
        dropped or replayed); mismatches are recorded in ``dropped``."""
        h = self.handoffs[rid]
        h.phase = HandoffPhase.RESUMED
        h.t_resume = now
        ok = tokens_resumed == h.tokens_frozen
        if not ok:
            self.dropped.append(rid)
        return ok

    def in_transit(self, rid: int) -> bool:
        h = self.handoffs.get(rid)
        return h is not None and h.phase is HandoffPhase.MIGRATING

    def pinned(self, rid: int) -> bool:
        """True while a handoff is open (not yet RESUMED)."""
        h = self.handoffs.get(rid)
        return h is not None and h.phase is not HandoffPhase.RESUMED

    def handoff_report(self) -> tuple[int, int]:
        """(completed handoffs, token-gapped requests)."""
        done = sum(1 for h in self.handoffs.values() if h.phase is HandoffPhase.RESUMED)
        return done, len(self.dropped)

    # -- SLO accounting ------------------------------------------------------
    def note_first_token(self, rid: int, now: float) -> None:
        rec = self.records[rid]
        if rec.ttft is None:
            rec.ttft = now - rec.arrival
        rec.token_times.append(now)

    def note_token(self, rid: int, now: float) -> None:
        self.records[rid].token_times.append(now)

    def note_done(self, rid: int) -> None:
        self.records[rid].done = True

    def reject(self, rid: int, now: float) -> None:
        """Admission control: mark a never-dispatched request as explicitly
        rejected (the caller removes it from the queue).  Rejected requests
        are excluded from SLO accounting — they were refused, not violated."""
        rec = self.records[rid]
        rec.rejected = True
        rec.rejected_at = now
        self.rejections.append(rid)

    def slo_report(self, multiplier: float = 5.0) -> SLOReport:
        recs = [r for r in self.records.values() if r.ttft is not None]
        if not recs:
            return SLOReport(0, 0, 0, 0, 0, 1.0)
        ttfts = np.array([r.ttft for r in recs])
        tbts = np.concatenate([np.array(r.tbts()) for r in recs if r.tbts()] or [np.zeros(1)])
        t_slo = multiplier * float(ttfts.mean())
        b_slo = multiplier * float(tbts.mean()) if len(tbts) else float("inf")
        ok = sum(
            1
            for r in recs
            if r.ttft <= t_slo and all(t <= b_slo for t in r.tbts())
        )
        return SLOReport(
            n=len(recs),
            mean_ttft=float(ttfts.mean()),
            p99_ttft=float(np.percentile(ttfts, 99)),
            mean_tbt=float(tbts.mean()),
            p99_tbt=float(np.percentile(tbts, 99)),
            attainment=ok / len(recs),
        )
