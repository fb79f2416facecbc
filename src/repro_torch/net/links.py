"""Directed-link model of the scale-out network (leaf-spine + scale-up).

The flow simulator shares bandwidth on *directed* links — the paper's
full-duplex cornerstone (Fig. 7c): a device's egress and ingress are two
independent links, so opposite-direction flows never contend.  The graph is
derived from :class:`repro.core.topology.Topology`:

  * every device (accelerator or CPU-host pseudo-device) gets a NIC egress
    link (``DEV_OUT``) and a NIC ingress link (``DEV_IN``) at its scale-out
    bandwidth;
  * every leaf gets per-direction uplinks to the spine (``LEAF_UP`` /
    ``LEAF_DOWN``), sized at the sum of member NIC bandwidth divided by
    ``spine_oversub`` — ``spine_oversub=1`` reproduces the planner's
    non-blocking ECMP assumption (§5.1), larger values model oversubscribed
    spines; ``spine_planes>1`` splits each uplink into parallel planes so a
    failed plane can re-route instead of aborting;
  * every scale-up (NVLink/ICI) domain gets one shared fabric link
    (``SCALEUP``) at aggregate NVLink bandwidth — intra-domain hops use it
    instead of the scale-out NICs, so they are near-free but still modelled.

Scenario knobs live on the :class:`Link`: ``degrade`` multiplies capacity
(a flapping or rate-limited link) and ``failed`` zeroes it (the flow
simulator re-routes or aborts flows crossing a failed link).

Latency model: every link carries a propagation delay (``prop_delay_s``)
and a switching delay (``switch_delay_s``) for the switching element a
path traverses to *enter* that link — so a cross-leaf path (NIC egress →
leaf uplink → leaf downlink → NIC ingress) pays 4 propagation terms + 3
switching terms, an intra-leaf path pays 2 + 1, and the scale-up fabric
pays only its own propagation.  :meth:`NetworkModel.path_latency` composes
them; the flow simulator charges the total as first-byte setup time before
a flow starts claiming its max-min bandwidth share, so small transfers
(per-request KV pages, per-layer multicast messages) become
latency-dominated while bulk transfers stay bandwidth-dominated.  Both
terms default to zero, which reproduces the pure bandwidth-sharing model
exactly.

Heterogeneous hardware: the uniform ``link_latency_s`` / ``switch_latency_s``
knobs seed every link identically; ``link_profiles`` overrides individual
links (a slow inter-building uplink, a fast NVLink-class NIC island) with
per-link latency, switching delay and/or bandwidth — see
:class:`LinkProfile`.  A profile keyed ``(LEAF_UP, leaf)`` (no plane)
applies to every spine plane of that uplink.  With no profiles the model
is bit-for-bit the uniform PR-4 arithmetic (golden-trace pinned).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.topology import NVLINK_GBPS, Topology, gbps_to_bytes_per_s

DEV_OUT = "dev_out"  # device NIC egress -> leaf switch
DEV_IN = "dev_in"  # leaf switch -> device NIC ingress
LEAF_UP = "leaf_up"  # leaf -> spine (per plane)
LEAF_DOWN = "leaf_down"  # spine -> leaf (per plane)
SCALEUP = "scaleup"  # shared NVLink/ICI fabric of one scale-up domain

LinkKey = tuple  # (kind, id) or (kind, id, plane)


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Per-link override of the uniform latency/bandwidth knobs.

    ``None`` fields keep the uniform value, so a profile can override any
    subset: ``LinkProfile(latency_s=5e-4)`` models a long-haul uplink,
    ``LinkProfile(bandwidth_gbps=400.0)`` a faster NIC generation,
    ``LinkProfile(switch_latency_s=1e-4)`` a slow switching ASIC feeding
    that link."""

    latency_s: float | None = None  # propagation delay of this link
    switch_latency_s: float | None = None  # delay of the element entering it
    bandwidth_gbps: float | None = None  # capacity override


@dataclasses.dataclass
class Link:
    """One directed link with its scenario state."""

    key: LinkKey
    capacity: float  # bytes/s nominal
    degrade: float = 1.0  # bandwidth multiplier (degraded-link scenario)
    failed: bool = False
    prop_delay_s: float = 0.0  # per-hop propagation delay (latency model)
    switch_delay_s: float = 0.0  # switching element traversed to enter this link

    @property
    def rate_cap(self) -> float:
        return 0.0 if self.failed else self.capacity * self.degrade

    @property
    def is_spine(self) -> bool:
        """True for leaf<->spine uplinks/downlinks — the links whose
        population decides load-balanced plane selection in the router."""
        return self.key[0] in (LEAF_UP, LEAF_DOWN)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "FAILED" if self.failed else (
            f"x{self.degrade:g}" if self.degrade != 1.0 else "ok"  # simcheck: exact-float -- 1.0 is the pristine-link sentinel, set only by assignment
        )
        return f"Link({self.key}, {self.capacity:.3g} B/s, {state})"


class NetworkModel:
    """The directed-link graph + deterministic path routing."""

    def __init__(
        self,
        topo: Topology,
        *,
        spine_oversub: float = 1.0,
        spine_planes: int = 1,
        scaleup_gbps: float = NVLINK_GBPS,
        link_latency_s: float = 0.0,
        switch_latency_s: float = 0.0,
        link_profiles: Mapping[LinkKey, LinkProfile] | None = None,
    ):
        if spine_planes < 1:
            raise ValueError("spine_planes must be >= 1")
        if link_latency_s < 0.0 or switch_latency_s < 0.0:
            raise ValueError("latency terms must be >= 0")
        self.topo = topo
        self.spine_planes = spine_planes
        self.link_latency_s = link_latency_s
        self.switch_latency_s = switch_latency_s
        self.links: dict[LinkKey, Link] = {}
        leaf_bw: dict[int, float] = {}
        for d in topo.devices:
            bw = gbps_to_bytes_per_s(d.bw_gbps)
            self._add((DEV_OUT, d.id), bw)
            self._add((DEV_IN, d.id), bw)
            leaf_bw[d.leaf] = leaf_bw.get(d.leaf, 0.0) + bw
        for leaf, bw in leaf_bw.items():
            per_plane = bw / spine_oversub / spine_planes
            for p in range(spine_planes):
                self._add((LEAF_UP, leaf, p), per_plane)
                self._add((LEAF_DOWN, leaf, p), per_plane)
        groups: dict[int, int] = {}
        for d in topo.devices:
            if not d.is_host:
                groups[d.scaleup] = groups.get(d.scaleup, 0) + 1
        for su, n in groups.items():
            self._add((SCALEUP, su), gbps_to_bytes_per_s(scaleup_gbps) * n)
        self._apply_profiles(link_profiles or {})
        # heterogeneous/uniform latency present at all?  A zero-latency
        # graph routes the planner onto its pure-bandwidth path (bit-for-bit
        # the legacy arithmetic).
        self.has_latency = any(
            l.prop_delay_s > 0.0 or l.switch_delay_s > 0.0
            for l in self.links.values()
        )

    def _add(self, key: LinkKey, capacity: float) -> None:
        self.links[key] = Link(
            key,
            capacity,
            prop_delay_s=self.link_latency_s,
            switch_delay_s=self.switch_latency_s,
        )

    def _apply_profiles(self, profiles: Mapping[LinkKey, LinkProfile]) -> None:
        for key, prof in profiles.items():
            keys = self._expand_profile_key(tuple(key))
            if not keys:
                raise ValueError(f"link_profiles key {key!r} matches no link")
            for field in ("latency_s", "switch_latency_s", "bandwidth_gbps"):
                v = getattr(prof, field)
                if v is not None and v < 0.0:
                    raise ValueError(f"link_profiles[{key!r}].{field} must be >= 0")
            for k in keys:
                link = self.links[k]
                if prof.latency_s is not None:
                    link.prop_delay_s = prof.latency_s
                if prof.switch_latency_s is not None:
                    link.switch_delay_s = prof.switch_latency_s
                if prof.bandwidth_gbps is not None:
                    link.capacity = gbps_to_bytes_per_s(prof.bandwidth_gbps)

    def _expand_profile_key(self, key: LinkKey) -> list[LinkKey]:
        """A profile key is either an exact link key or a plane-less
        ``(LEAF_UP/LEAF_DOWN, leaf)`` shorthand covering every spine plane."""
        if key in self.links:
            return [key]
        if len(key) == 2 and key[0] in (LEAF_UP, LEAF_DOWN):
            planes = [
                (key[0], key[1], p)
                for p in range(self.spine_planes)
                if (key[0], key[1], p) in self.links
            ]
            return planes
        return []

    def link(self, key: LinkKey) -> Link:
        return self.links[key]

    def path_latency(self, path: Sequence[Link]) -> float:
        """First-byte latency of a path: per-hop propagation plus the
        switching delay of every element between consecutive links (charged
        to the link being entered, so heterogeneous profiles compose as a
        per-hop sum).  Empty paths (same-device transfers) have zero
        latency."""
        if not path:
            return 0.0
        return (
            sum(l.prop_delay_s for l in path)
            + sum(l.switch_delay_s for l in path[1:])
        )

    def route_latency(self, src: int, dst: int) -> float:
        """Nominal (plane-0) first-byte latency of a src->dst path — the
        latency view a multicast planner consults per candidate hop."""
        return self.path_latency(self.path(src, dst, plane=0))

    def hop_latency(self, src: int, dst: int) -> float:
        """Worst-case first-byte latency across live spine planes.  Routing
        picks planes by load, not latency, so a store-and-forward stage must
        conservatively budget the slowest live plane for its downstream
        hops.  Falls back to the plane-0 value when every plane is down
        (the flow will abort anyway)."""
        worst, any_live = 0.0, False
        for p in range(self.spine_planes):
            path = self.path(src, dst, plane=p)
            lat = self.path_latency(path)
            if len(path) <= 2:  # intra-leaf / scale-up: plane-independent
                return lat
            if not any(l.failed for l in path):
                any_live = True
                worst = max(worst, lat)
        if any_live:
            return worst
        return self.path_latency(self.path(src, dst, plane=0))

    # -- routing -------------------------------------------------------------
    def path(self, src: int, dst: int, *, plane: int = 0) -> list[Link]:
        """The (single, deterministic) path of a src->dst flow on spine
        ``plane``.  Same-device flows have an empty path (instant)."""
        if src == dst:
            return []
        a, b = self.topo.device(src), self.topo.device(dst)
        if a.scaleup == b.scaleup and not a.is_host and not b.is_host:
            return [self.links[(SCALEUP, a.scaleup)]]
        p = [self.links[(DEV_OUT, src)]]
        if a.leaf != b.leaf:
            p.append(self.links[(LEAF_UP, a.leaf, plane)])
            p.append(self.links[(LEAF_DOWN, b.leaf, plane)])
        p.append(self.links[(DEV_IN, dst)])
        return p

    def device_ok(self, dev: int) -> bool:
        """False when the device's NIC (either direction) is failed — such a
        device cannot be a transfer endpoint and should not be provisioned."""
        return not (
            self.links[(DEV_OUT, dev)].failed or self.links[(DEV_IN, dev)].failed
        )
