"""Metric registry: counters, gauges, fixed-bucket histograms, snapshots.

One :class:`MetricRegistry` is the single sink for every numeric signal a
control plane produces.  The three hand-rolled stats dataclasses that grew
up around the repo (``RuntimeStats``, ``FleetStats``, ``TenantStats``) now
share one base, :class:`StatBlock`: plain attribute increments keep working
(``stats.migrations += 1``), but once a block is ``bind()``-ed to a
registry every assignment is mirrored into a named counter — so a fleet-
wide registry sees every tenant's and runtime's counters under one
namespace, and a benchmark can flatten the whole thing into a
``BENCH_*.json`` perf record with :meth:`MetricRegistry.flat`.

Design constraints:

  * **deterministic** — metric names are explicit, snapshots are sorted,
    nothing reads the wall clock; a seeded simulation produces an
    identical registry every run;
  * **cheap** — counters and gauges are one attribute store; histograms
    are a ``bisect`` into fixed bucket bounds (no allocation per observe);
  * **serializable** — ``snapshot()``/``flat()`` emit plain dicts of
    floats, ready for ``json.dump``.

``snap(t)`` appends a timestamped snapshot to ``series`` — the periodic-
snapshot hook the simulator's monitor loop drives, giving post-hoc reports
a time axis without a separate time-series store.
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_left
from collections import deque
from typing import Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "StatBlock",
    "DEFAULT_LATENCY_BUCKETS_S",
]

#: fixed buckets for latency histograms (seconds) — sub-ms to minutes
DEFAULT_LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonic-by-convention numeric cell (``set`` exists so a bound
    :class:`StatBlock` can mirror plain field assignment)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def set(self, v: float) -> None:
        self.value = float(v)


class Gauge:
    """Last-value-wins numeric cell."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` observations fell at or below
    ``bounds[i]``; the final slot is the overflow bucket."""

    __slots__ = ("name", "bounds", "counts", "total", "count")

    def __init__(self, name: str, bounds: Iterable[float]):
        self.name = name
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError(f"histogram {name!r} needs at least one bucket bound")
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        # bisect_left keeps an observation exactly equal to bounds[i] in
        # bucket i — the documented "at or below bounds[i]" semantics
        self.counts[bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.total,
            "count": self.count,
        }


class MetricRegistry:
    """Named counters/gauges/histograms + timestamped snapshot series.

    ``series_maxlen`` bounds the snapshot series as a ring buffer (oldest
    snapshots evicted, ``series_dropped`` counts them) — the same contract
    as ``FlowEventLog``'s ring-buffer mode, so a long-horizon simulation's
    periodic ``snap()`` cannot grow memory without limit.  ``None`` (the
    default) keeps the unbounded behaviour."""

    def __init__(self, *, series_maxlen: int | None = None):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.series: deque[tuple[float, dict]] = deque(maxlen=series_maxlen)
        self.series_maxlen = series_maxlen
        self.series_dropped = 0

    # -- cells ---------------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(
        self, name: str, bounds: Iterable[float] = DEFAULT_LATENCY_BUCKETS_S
    ) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, bounds)
        return h

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """Sorted, JSON-ready view of every cell."""
        return {
            "counters": {k: self.counters[k].value for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k].value for k in sorted(self.gauges)},
            "histograms": {
                k: self.histograms[k].as_dict() for k in sorted(self.histograms)
            },
        }

    def flat(self) -> dict[str, float]:
        """One flat name->number mapping (histograms contribute their count,
        sum and mean) — the shape ``BENCH_*.json`` perf records store."""
        out: dict[str, float] = {}
        for k in sorted(self.counters):
            out[k] = self.counters[k].value
        for k in sorted(self.gauges):
            out[k] = self.gauges[k].value
        for k in sorted(self.histograms):
            h = self.histograms[k]
            out[f"{k}.count"] = float(h.count)
            out[f"{k}.sum"] = h.total
            out[f"{k}.mean"] = h.mean
        return out

    def snap(self, t: float) -> None:
        """Append a timestamped snapshot to ``series`` (the periodic-
        snapshot hook a monitor loop calls).  At ``series_maxlen`` the
        oldest snapshot is evicted and counted in ``series_dropped``."""
        if (self.series_maxlen is not None
                and len(self.series) == self.series_maxlen):
            self.series_dropped += 1
        self.series.append((float(t), self.snapshot()))


class StatBlock:
    """Base for stats dataclasses: ``as_dict()`` + optional registry backing.

    Subclasses stay ordinary mutable dataclasses — every existing
    ``stats.field += 1`` call site is untouched.  After ``bind(registry,
    prefix)``, each assignment is mirrored to ``registry.counter(f"{prefix}.
    {field}")``, which is what unifies the previously divergent hand-rolled
    counter patterns behind one queryable surface."""

    def as_dict(self) -> dict[str, float]:
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)  # type: ignore[arg-type]
        }

    def bind(self, registry: MetricRegistry, prefix: str) -> "StatBlock":
        object.__setattr__(self, "_reg", registry)
        object.__setattr__(self, "_prefix", prefix)
        for name, value in self.as_dict().items():
            registry.counter(f"{prefix}.{name}").set(value)
        return self

    def __setattr__(self, name: str, value) -> None:
        object.__setattr__(self, name, value)
        reg = self.__dict__.get("_reg")
        if reg is not None and not name.startswith("_"):
            reg.counter(f"{self.__dict__['_prefix']}.{name}").set(value)
