"""Fleet utilization ledgers: where every device-second and link-second went.

The paper's headline claims are *resource* claims — 49% less GPU time than
non-autoscaling serving, 94% lower tail latency — but a single
``gpu_time_s`` scalar can show *that* GPU time dropped, never *where it
went*.  Two ledgers close that gap:

:class:`DeviceTimeLedger`
    partitions every device-second a control plane accounts into exclusive
    states:

    * ``serving_prefill`` / ``serving_decode`` — the device ran a forward
      pass of that phase;
    * ``loading_params`` — parameters in flight, no work waiting on them;
    * ``stalled_waiting_layers`` — parameters in flight WITH work queued
      behind them (the latency the paper's live scaling exists to hide);
    * ``allocated_idle`` — held by an instance/grant but executing nothing;
    * ``draining`` — finishing in-flight work before releasing the device.

    The conservation invariant is **by construction**: callers accrue every
    accounted interval into exactly one state, and :meth:`total` sums the
    per-state totals in one fixed order — so ``sum(breakdown().values())
    == total()`` bit-for-bit, and a caller that defines its
    ``gpu_time_s`` as ``ledger.total()`` gets exact attribution for free.

:class:`LinkLedger`
    attributes per-link busy time and bytes to flow-kind groups
    (``multicast`` / ``kv`` / ``cold_start`` / ``serving``).  FlowSim
    accrues into it on every integration step when one is attached
    (:meth:`repro_torch.net.flowsim.FlowSim.attach_ledger`); detached, the data
    plane is untouched — golden flow-event traces stay bit-for-bit.
    Busy-seconds are capacity-normalized (``moved_bytes / rate_cap``), so
    the per-link sum across all groups can never exceed the elapsed
    horizon (max-min sharing conserves link capacity).

The port's copy of ``repro.obs.ledger``.  Under Python 3.12 the built-in
``sum()`` over floats uses compensated summation, so it can differ from
``total()``'s plain ``+=`` in the last bits: compare totals with ``total()``.
"""

from __future__ import annotations

from repro_torch.net.flows import Flow, FlowKind

__all__ = [
    "DEVICE_STATES",
    "FLOW_GROUPS",
    "DeviceTimeLedger",
    "LinkLedger",
]

#: exclusive device states; the FIXED summation order behind the
#: conservation invariant — never reorder (total() and breakdown() both
#: iterate it, which is what makes their sums bit-identical)
DEVICE_STATES = (
    "serving_prefill",
    "serving_decode",
    "loading_params",
    "allocated_idle",
    "stalled_waiting_layers",
    "draining",
)

#: FlowKind -> attribution group for the link ledger
FLOW_GROUPS = {
    FlowKind.MULTICAST_HOP: "multicast",
    FlowKind.ALLGATHER: "multicast",
    FlowKind.KV_MIGRATION: "kv",
    FlowKind.COLD_START: "cold_start",
    FlowKind.SERVING: "serving",
}


class DeviceTimeLedger:
    """Exclusive-state device-second accounting with exact conservation."""

    __slots__ = ("_totals", "_by_owner")

    def __init__(self):
        self._totals = {s: 0.0 for s in DEVICE_STATES}
        self._by_owner: dict[str, dict[str, float]] = {}

    def accrue(self, state: str, device_seconds: float,
               owner: str | None = None) -> None:
        """Charge ``device_seconds`` to one exclusive ``state`` (optionally
        attributed to an ``owner`` — a tenant/model name)."""
        if device_seconds <= 0.0:
            return
        if state not in self._totals:
            raise ValueError(f"unknown ledger state {state!r} "
                             f"(expected one of {DEVICE_STATES})")
        self._totals[state] += device_seconds
        if owner is not None:
            o = self._by_owner.get(owner)
            if o is None:
                o = self._by_owner[owner] = {s: 0.0 for s in DEVICE_STATES}
            o[state] += device_seconds

    # -- views ---------------------------------------------------------------
    def total(self) -> float:
        """Accounted device-seconds.  Summed in DEVICE_STATES order — the
        same floats in the same order as ``sum(breakdown().values())``, so
        the conservation check is exact, not within-epsilon."""
        t = 0.0
        for s in DEVICE_STATES:
            t += self._totals[s]
        return t

    def breakdown(self) -> dict[str, float]:
        """Per-state totals, every state present, DEVICE_STATES order."""
        return {s: self._totals[s] for s in DEVICE_STATES}

    def owners(self) -> list[str]:
        return sorted(self._by_owner)

    def owner_breakdown(self, owner: str) -> dict[str, float]:
        o = self._by_owner.get(owner)
        return {s: (o[s] if o else 0.0) for s in DEVICE_STATES}

    def utilization(self) -> float:
        """Fraction of accounted device-time doing useful serving work."""
        t = self.total()
        if t <= 0.0:
            return 0.0
        return (self._totals["serving_prefill"]
                + self._totals["serving_decode"]) / t

    def as_metrics(self, prefix: str = "gpu_s") -> dict[str, float]:
        """Flat ``{prefix}.{state}`` mapping for BENCH_*.json records."""
        return {f"{prefix}.{s}": self._totals[s] for s in DEVICE_STATES}


class LinkLedger:
    """Per-link busy time and bytes attributed to flow-kind groups."""

    __slots__ = ("bytes", "busy_s", "cap_seen", "horizon")

    def __init__(self):
        # (link_key, group) -> accumulated value
        self.bytes: dict[tuple, float] = {}
        self.busy_s: dict[tuple, float] = {}
        # link_key -> max rate_cap observed while accruing (degrades shrink
        # the live cap; the bound test compares against the max ever seen)
        self.cap_seen: dict[tuple, float] = {}
        self.horizon = 0.0  # last network time observed (note_time)

    def accrue_flow(self, flow: Flow, moved_bytes: float, dt: float) -> None:
        """Charge one integration step of ``flow``: ``moved_bytes`` crossed
        every link on its path during ``dt`` seconds."""
        if moved_bytes <= 0.0:
            return
        group = FLOW_GROUPS.get(flow.kind, flow.kind.value)
        for link in flow.path:
            key = (link.key, group)
            self.bytes[key] = self.bytes.get(key, 0.0) + moved_bytes
            cap = link.rate_cap
            if cap > 0.0:
                self.busy_s[key] = self.busy_s.get(key, 0.0) + moved_bytes / cap
                prev = self.cap_seen.get(link.key, 0.0)
                if cap > prev:
                    self.cap_seen[link.key] = cap

    def note_time(self, now: float) -> None:
        if now > self.horizon:
            self.horizon = now

    # -- views ---------------------------------------------------------------
    def groups(self) -> list[str]:
        return sorted({g for _, g in self.bytes})

    def links(self) -> list[tuple]:
        return sorted({k for k, _ in self.bytes}, key=repr)

    def bytes_by_group(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for (_, g), v in self.bytes.items():
            out[g] = out.get(g, 0.0) + v
        return {g: out[g] for g in sorted(out)}

    def busy_by_group(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for (_, g), v in self.busy_s.items():
            out[g] = out.get(g, 0.0) + v
        return {g: out[g] for g in sorted(out)}

    def link_busy(self, link_key: tuple) -> float:
        """Capacity-normalized busy-seconds of one link across all groups —
        bounded above by the elapsed horizon."""
        return sum(v for (k, _), v in self.busy_s.items() if k == link_key)

    def link_breakdown(self, link_key: tuple) -> dict[str, float]:
        return {
            g: v for (k, g), v in sorted(self.busy_s.items(), key=lambda kv: kv[0][1])
            if k == link_key
        }

    def busiest(self, n: int = 5) -> list[tuple[tuple, float]]:
        """The ``n`` links with the most attributed busy time."""
        per_link: dict[tuple, float] = {}
        for (k, _), v in self.busy_s.items():
            per_link[k] = per_link.get(k, 0.0) + v
        return sorted(per_link.items(), key=lambda kv: (-kv[1], repr(kv[0])))[:n]
