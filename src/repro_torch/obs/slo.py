"""Streaming SLO monitor: P² quantiles + burn-rate windows + fleet_health().

The paper's autoscaler (and the SLO-aware coordinated scaling of "Taming
the Chaos") assumes something watches SLO attainment *online* — not a
post-hoc percentile over a finished run.  This module is that watcher:

  * :class:`P2Quantile` — the Jain & Chlamtac P² streaming estimator:
    O(1) memory per quantile, no sample buffer, deterministic for a
    deterministic observation stream;
  * per-tenant TTFT/TBT quantiles plus **SLO burn rate** over sliding
    windows (SRE convention: ``violation_rate / error_budget``, so burn
    1.0 consumes the budget exactly at the sustainable pace, and a fast
    window burning >> 1 pages before the slow window notices);
  * :meth:`SLOMonitor.fleet_health` — one JSON-ready summary the
    FleetScheduler exposes; its per-tenant status breaks arbitration ties
    (``FleetPolicy.slo_aware_arbitration``).

Feed it directly (``observe_ttft`` / ``observe_tbt``) or from a span trace
(:meth:`SLOMonitor.ingest_spans` consumes the tracer's ``request`` root
spans carrying a ``ttft`` attr).  The port's copy of ``repro.obs.slo``.
"""

from __future__ import annotations

__all__ = ["P2Quantile", "SLOMonitor", "DEFAULT_WINDOWS_S"]

from collections import deque

#: default burn-rate windows (seconds): a fast page window + a slow trend
DEFAULT_WINDOWS_S = (30.0, 300.0)


class P2Quantile:
    """Jain & Chlamtac's P² algorithm: streaming quantile in O(1) memory.

    Five markers track (min, q/2, q, (1+q)/2, max); marker heights move by
    piecewise-parabolic interpolation as observations arrive.  Until five
    observations exist the estimate is the nearest rank of the sorted
    buffer."""

    __slots__ = ("q", "_h", "_n", "_np", "_dn", "count")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._h: list[float] = []  # marker heights (or first <5 observations)
        self._n: list[float] = []  # marker positions
        self._np: list[float] = []  # desired positions
        self._dn = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        if self.count <= 5:
            self._h.append(v)
            if self.count == 5:
                self._h.sort()
                self._n = [0.0, 1.0, 2.0, 3.0, 4.0]
                q = self.q
                self._np = [0.0, 2.0 * q, 4.0 * q, 2.0 + 2.0 * q, 4.0]
            return
        h, n = self._h, self._n
        if v < h[0]:
            h[0] = v
            k = 0
        elif v >= h[4]:
            h[4] = v
            k = 3
        else:
            k = 0
            while v >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic candidate, linear fallback when the
                # parabola would break marker monotonicity
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
                )
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:
                    j = i + int(d)
                    h[i] = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                n[i] += d

    def value(self) -> float | None:
        """Current estimate; None before any observation."""
        if self.count == 0:
            return None
        if self.count < 5:
            s = sorted(self._h)
            return s[min(int(self.q * len(s)), len(s) - 1)]
        return self._h[2]


class _BurnWindow:
    """Sliding-window violation counter -> burn rate."""

    __slots__ = ("horizon", "_events", "bad", "n")

    def __init__(self, horizon_s: float):
        self.horizon = horizon_s
        self._events: deque[tuple[float, bool]] = deque()
        self.bad = 0
        self.n = 0

    def add(self, t: float, violated: bool) -> None:
        self._events.append((t, violated))
        self.n += 1
        if violated:
            self.bad += 1
        self._expire(t)

    def _expire(self, now: float) -> None:
        cutoff = now - self.horizon
        ev = self._events
        while ev and ev[0][0] < cutoff:
            _, v = ev.popleft()
            self.n -= 1
            if v:
                self.bad -= 1

    def burn(self, now: float, error_budget: float) -> float:
        """``violation_rate / error_budget`` over the window; 0 when empty."""
        self._expire(now)
        if self.n == 0:
            return 0.0
        rate = self.bad / self.n
        if error_budget <= 0.0:
            return float("inf") if rate > 0.0 else 0.0
        return rate / error_budget


class _TenantState:
    __slots__ = ("ttft_p50", "ttft_p99", "tbt_p50", "tbt_p99",
                 "ttft_windows", "tbt_windows",
                 "ttft_n", "ttft_bad", "tbt_n", "tbt_bad", "last_t")

    def __init__(self, windows_s):
        self.ttft_p50 = P2Quantile(0.5)
        self.ttft_p99 = P2Quantile(0.99)
        self.tbt_p50 = P2Quantile(0.5)
        self.tbt_p99 = P2Quantile(0.99)
        self.ttft_windows = {w: _BurnWindow(w) for w in windows_s}
        self.tbt_windows = {w: _BurnWindow(w) for w in windows_s}
        self.ttft_n = self.ttft_bad = 0
        self.tbt_n = self.tbt_bad = 0
        self.last_t = 0.0


class SLOMonitor:
    """Per-tenant streaming TTFT/TBT quantiles + SLO burn rate.

    ``target`` is the attainment objective (0.99 -> a 1% error budget);
    ``burn_warn`` / ``burn_page`` translate window burn rates into a
    status: any window at/above ``burn_warn`` -> ``warn``, any at/above
    ``burn_page`` -> ``page`` (the SRE fast-burn page)."""

    def __init__(
        self,
        *,
        ttft_slo_s: float | None = None,
        tbt_slo_s: float | None = None,
        windows_s=DEFAULT_WINDOWS_S,
        target: float = 0.99,
        burn_warn: float = 1.0,
        burn_page: float = 10.0,
    ):
        self.default_slo = (ttft_slo_s, tbt_slo_s)
        self.windows_s = tuple(float(w) for w in windows_s)
        self.target = target
        self.error_budget = 1.0 - target
        self.burn_warn = burn_warn
        self.burn_page = burn_page
        self._slos: dict[str, tuple[float | None, float | None]] = {}
        self._tenants: dict[str, _TenantState] = {}
        self._now = 0.0

    # -- configuration -------------------------------------------------------
    def set_slo(self, tenant: str, *, ttft_slo_s: float | None = None,
                tbt_slo_s: float | None = None) -> None:
        """Per-tenant SLO override (falls back to the constructor default)."""
        self._slos[tenant] = (ttft_slo_s, tbt_slo_s)

    def _slo_for(self, tenant: str) -> tuple[float | None, float | None]:
        return self._slos.get(tenant, self.default_slo)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(self.windows_s)
        return st

    # -- observation ---------------------------------------------------------
    def observe_ttft(self, tenant: str, t: float, value: float) -> None:
        st = self._state(tenant)
        st.ttft_p50.observe(value)
        st.ttft_p99.observe(value)
        slo = self._slo_for(tenant)[0]
        bad = slo is not None and value > slo
        st.ttft_n += 1
        st.ttft_bad += bad
        for w in st.ttft_windows.values():
            w.add(t, bad)
        st.last_t = max(st.last_t, t)
        self._now = max(self._now, t)

    def observe_tbt(self, tenant: str, t: float, value: float) -> None:
        st = self._state(tenant)
        st.tbt_p50.observe(value)
        st.tbt_p99.observe(value)
        slo = self._slo_for(tenant)[1]
        bad = slo is not None and value > slo
        st.tbt_n += 1
        st.tbt_bad += bad
        for w in st.tbt_windows.values():
            w.add(t, bad)
        st.last_t = max(st.last_t, t)
        self._now = max(self._now, t)

    def ingest_spans(self, spans, tenant: str = "default") -> int:
        """Feed finished ``request`` root spans (the tracer's stream): each
        span's ``ttft`` attr is observed at its completion time.  Returns
        the number of requests ingested."""
        n = 0
        for sp in spans:
            if getattr(sp, "name", None) != "request":
                continue
            ttft = sp.attrs.get("ttft")
            if ttft is None:
                continue
            t = sp.t1 if sp.t1 is not None else sp.t0 + float(ttft)
            self.observe_ttft(sp.attrs.get("tenant", tenant), t, float(ttft))
            n += 1
        return n

    # -- reporting -----------------------------------------------------------
    def _status(self, burns: dict[str, float]) -> str:
        worst = max(burns.values(), default=0.0)
        if worst >= self.burn_page:
            return "page"
        if worst >= self.burn_warn:
            return "warn"
        return "ok"

    def tenant_health(self, tenant: str, now: float | None = None) -> dict:
        st = self._state(tenant)
        now = self._now if now is None else now
        burns = {}
        for w in self.windows_s:
            b_ttft = st.ttft_windows[w].burn(now, self.error_budget)
            b_tbt = st.tbt_windows[w].burn(now, self.error_budget)
            burns[f"{w:g}s"] = max(b_ttft, b_tbt)
        return {
            "requests": st.ttft_n,
            "ttft_p50_s": st.ttft_p50.value(),
            "ttft_p99_s": st.ttft_p99.value(),
            "tbt_p50_s": st.tbt_p50.value(),
            "tbt_p99_s": st.tbt_p99.value(),
            "ttft_attainment": (
                1.0 - st.ttft_bad / st.ttft_n if st.ttft_n else None
            ),
            "tbt_attainment": (
                1.0 - st.tbt_bad / st.tbt_n if st.tbt_n else None
            ),
            "burn_rate": burns,
            "status": self._status(burns),
        }

    def fleet_health(self, now: float | None = None) -> dict:
        """The fleet-readable summary: per-tenant health + the worst status
        fleet-wide.  JSON-ready (no NaN/inf for empty tenants — absent data
        is None)."""
        now = self._now if now is None else now
        tenants = {
            name: self.tenant_health(name, now) for name in sorted(self._tenants)
        }
        order = {"ok": 0, "warn": 1, "page": 2}
        worst = max(
            (t["status"] for t in tenants.values()),
            key=lambda s: order[s],
            default="ok",
        )
        return {
            "now": now,
            "target": self.target,
            "windows_s": list(self.windows_s),
            "tenants": tenants,
            "status": worst,
        }
