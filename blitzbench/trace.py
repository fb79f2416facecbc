"""Spans around the program's calls, and the profiled slice of a traced run.

``Recorder`` wraps methods of the program's classes for the length of a
window: each call becomes a span on the host clock (name, start, end, what
the call was given) and, while the profiler runs, a ``bench.<name>#<i>``
annotation in its trace, ``i`` the span's index.  The engine calls end in a
host read of their result, so the device work each launched lies inside its
annotation.

``Slice`` runs ``torch.profiler`` over one stretch of the window and keeps
what the readers need: device records (kernels, copies, sets) and the
annotations.  The profiler now and then loses a device record
(``chip_smoke.py`` checks its windows for that); here a lost record shows
as an annotation holding fewer records of a kernel than the call launched,
and the readers leave such a call out.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

@dataclasses.dataclass
class Span:
    idx: int  # numbered at the call's start
    name: str
    t0: float  # host perf_counter seconds
    t1: float
    info: dict


class Recorder:
    def __init__(self):
        self.spans: list[Span] = []  # in the order the calls ended
        self._next = 0
        self._undo: list = []

    def wrap(self, cls, method: str, name: str, info=None) -> None:
        """``cls.method`` as a span; ``info(obj, *args)`` gives its details,
        read before the call."""
        import torch

        orig = getattr(cls, method)

        def wrapper(obj, *args, **kw):
            i, self._next = self._next, self._next + 1
            details = info(obj, *args) if info is not None else {}
            with torch.profiler.record_function(f"bench.{name}#{i}"):
                t0 = time.perf_counter()
                out = orig(obj, *args, **kw)
                t1 = time.perf_counter()
            self.spans.append(Span(i, name, t0, t1, details))
            return out

        setattr(cls, method, wrapper)
        self._undo.append((cls, method, orig))

    def restore(self) -> None:
        for cls, method, orig in reversed(self._undo):
            setattr(cls, method, orig)
        self._undo.clear()


@dataclasses.dataclass
class TraceSummary:
    t0_ns: int
    t1_ns: int
    device: list  # (start_ns, end_ns, name), sorted by start
    annotations: dict  # span index -> (name, start_ns, end_ns)

    def __post_init__(self):
        self._starts = [d[0] for d in self.device]

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def merged(self) -> list[tuple[int, int]]:
        """Device activity inside the window, overlapping records merged."""
        out: list[list[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def inside(self, start_ns: int, end_ns: int, kernel: str) -> list[tuple]:
        """Records of ``kernel`` that start inside [start_ns, end_ns]."""
        lo = bisect.bisect_left(self._starts, start_ns)
        hi = bisect.bisect_right(self._starts, end_ns)
        return [d for d in self.device[lo:hi] if kernel in d[2]]


class Slice:
    """The profiler over [start, start + seconds) of the window (host
    seconds from the window's start)."""

    def __init__(self, start: float, seconds: float):
        self.start, self.end = start, start + seconds
        self.prof = None
        self.summary: TraceSummary | None = None
        self.host = (None, None)  # perf_counter seconds of start and stop

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so that its first start (CUPTI's
        set-up) falls in the run's set-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def poll(self, now: float) -> None:
        """Start or stop at the slice's bounds; ``now`` is window time."""
        if self.prof is None and now >= self.start:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self._t0_ns, self.host = time.time_ns(), (time.perf_counter(), None)
        elif now >= self.end:
            self.stop()

    def stop(self) -> None:
        """Stop the profiler (at the slice's end, or the window's)."""
        if self.prof is None or self.host[1] is not None:
            return
        import torch

        torch.cuda.synchronize()
        self._t1_ns = time.time_ns()
        self.host = (self.host[0], time.perf_counter())
        self.prof.stop()

    def read(self) -> TraceSummary | None:
        """The slice's summary, read once the window has closed."""
        if self.prof is not None and self.summary is None:
            self.stop()
            self.summary = summarize(self.prof, self._t0_ns, self._t1_ns)
        return self.summary


def summarize(prof, t0_ns: int, t1_ns: int) -> TraceSummary:
    from torch.autograd import DeviceType

    device, annotations = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("bench."):  # the annotations' device-side ranges
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name.startswith("bench."):
            kind, _, idx = name[len("bench."):].partition("#")
            annotations[int(idx)] = (kind, e.start_ns(), e.start_ns() + e.duration_ns())
    device.sort()
    return TraceSummary(t0_ns, t1_ns, device, annotations)


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing: inside a span (``in decode``) or between
    spans."""
    by_op: dict[str, int] = {}
    for s, e, name in summary.device:
        by_op[name] = by_op.get(name, 0) + (min(e, summary.t1_ns) - max(s, summary.t0_ns))
    ops = sorted(((n[:100], ns / 1e9) for n, ns in by_op.items() if ns > 0), key=lambda x: -x[1])
    spans = sorted((s, e, k) for k, s, e in summary.annotations.values())
    starts = [s for s, _, _ in spans]

    def label(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return f"in {spans[i][2]}" if i >= 0 and spans[i][1] >= t else "between spans"

    gaps: dict[str, int] = {}
    prev = summary.t0_ns
    for s, e in summary.merged() + [(summary.t1_ns, summary.t1_ns)]:
        if s > prev:
            k = label((prev + s) // 2)
            gaps[k] = gaps.get(k, 0) + (s - prev)
        prev = max(prev, e)
    idle = sorted(((k, ns / 1e9) for k, ns in gaps.items()), key=lambda x: -x[1])
    return {"device_ops": [list(x) for x in ops[:top]], "idle_gaps": [list(x) for x in idle[:top]]}
