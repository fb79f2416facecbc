"""Congestion-aware flow-level network simulator (progressive max-min).

One :class:`FlowSim` serves every bandwidth consumer in the repo — multicast
chain execution, KV-cache migration, cold-start unicast, background serving
streams — over the directed-link graph of :class:`repro.net.links
.NetworkModel`.  Rates follow *progressive filling* max-min fairness:

  repeat until every flow is frozen:
    find the link whose remaining capacity / unfrozen users is smallest;
    freeze those users at that fair share; subtract it along their paths.

This yields the classic invariants (property-tested in tests/test_net.py):
per-link conservation (sum of rates <= capacity), and every flow
bottlenecked on at least one saturated link where no competitor gets more.
The per-ingress fair-share incast model this replaces is the single-link
special case: ``n`` flows into one ingress each get ``BW/n``.

Fleet-scale core (the incremental engine)
-----------------------------------------
The naive engine re-solves progressive filling over EVERY flow on every
arrival/departure/activation and scans every flow per integration step —
O(flows x links) per event, hopeless at thousands of devices.  The default
engine (``incremental=True``) keeps allocations bit-for-bit identical while
re-solving only what an event can actually change:

  * **incremental max-min** — progressive filling decomposes exactly over
    connected components of the flow/link sharing graph (flows in disjoint
    components never compete for a link, so their fill order can't interact
    and the float arithmetic per component is identical to the full solve).
    A maintained link->flows index finds the component of a changed flow by
    BFS; only those flows are re-solved, everyone else keeps their frozen
    rate.  A FULL re-solve still happens on any link-capacity mutation
    (degrade / fail / recover / eviction reroutes) — those can move rates
    in every component at once and are rare scenario events.
  * **event calendar** — a lazy-invalidation heap of projected completion
    and activation times replaces the O(flows) min-scan per step.  Each
    active finite flow carries one entry keyed by the projected time it
    enters its completion epsilon zone; entries go stale (generation bump)
    on any rate change and are discarded on pop.  Because eager per-step
    integration drifts a projection by at most a few ulps between
    refreshes, the engine pops every candidate within a small pad of the
    heap top and evaluates the EXACT per-flow expressions the naive scan
    used (``remaining / rate``, ``active_at - now``) — the min over that
    superset is bit-for-bit the naive scan's min.  Same-timestamp events
    batch exactly as before: every completion inside the epsilon window of
    a step settles in one batch, with one rate re-solve.
  * the same index de-linearizes ``flows_through`` / ``flows_into`` /
    ``utilization``, failure eviction, and the router's plane load count.

``incremental=False`` keeps the pre-refactor reference engine (full solve +
linear scans) — the oracle the equivalence property tests drive and the
baseline ``benchmarks/net_scale.py`` measures speedup against.

Time advances event-by-event: flow start, flow finish, and any scenario
mutation (degrade / fail / recover) are rate-change events; between events
every flow progresses linearly at its frozen rate, so integration is exact.

Latency terms (``link_latency_s`` per-hop propagation, ``switch_latency_s``
per switching element) compose with the bandwidth shares as first-byte
setup time: a starting flow spends its path latency *propagating* — rate
zero, contending with nobody — and only then claims its max-min share, so
an uncontended transfer takes ``latency + size/bandwidth`` exactly.  Both
terms default to zero, in which case behaviour (and floating-point
arithmetic) is identical to the pure bandwidth-sharing model.

Scenario knobs: ``degrade_link`` (bandwidth multiplier), ``fail_link`` /
``fail_device`` / ``fail_leaf`` (flows re-route onto a surviving spine
plane when one exists — emitting ``FLOW_REROUTED`` with their first-byte
latency re-charged for the new path — else abort via their ``on_abort``
callback, the hook Autoscaler/FleetScheduler re-planning hangs off),
``spine_oversub`` (oversubscribed spines) and ``spine_planes`` (parallel
spine planes).

Every lifecycle edge and scenario mutation is also broadcast to
``subscribe``d observers as a :class:`repro.net.events.NetEvent` — the
channel the FleetScheduler uses to react to failures immediately and the
golden-trace regression harness uses to diff seeded runs.
"""

from __future__ import annotations

import heapq
import math
from typing import Callable, Iterable, Sequence

from repro_torch.core.topology import NVLINK_GBPS, Topology
from repro_torch.net import events as ev
from repro_torch.net.events import NetEvent
from repro_torch.net.flows import Flow, FlowKind
from repro_torch.net.links import DEV_IN, DEV_OUT, LEAF_DOWN, LEAF_UP, Link, LinkKey, NetworkModel

_EPS = 1e-9


def flow_done_eps(size: float) -> float:
    """The ONE completion threshold shared by the live engine and the
    what-if estimator: a transfer of ``size`` bytes is done once its
    remaining bytes drop to ``_EPS * max(size, 1.0)``.  Keeping both sides
    on this helper is what lets ``estimate_transfer_time`` and realized
    completion agree on tiny flows (the planner's <=1% guarantee)."""
    return _EPS * max(size, 1.0)


def maxmin_rates(paths: Sequence[Sequence[Link]]) -> list[float]:
    """Progressive-filling max-min allocation for ``paths[i]`` = the links
    flow ``i`` crosses.  Pure function — shared by the live engine (full
    and per-component incremental re-solves) and the non-mutating what-if
    estimator.  Empty paths get ``inf`` (same-device transfers are
    instant)."""
    n = len(paths)
    rates = [0.0] * n
    users: dict[LinkKey, list[int]] = {}
    cap: dict[LinkKey, float] = {}
    for i, path in enumerate(paths):
        for l in path:
            users.setdefault(l.key, []).append(i)
            cap.setdefault(l.key, l.rate_cap)
    # unfrozen-user count per link, maintained across freeze rounds — the
    # same value the original formulation rescanned ``users`` for every
    # round, so shares (and therefore every float) are computed identically
    live = {key: len(idxs) for key, idxs in users.items()}
    unfrozen = {i for i in range(n) if paths[i]}
    for i in range(n):
        if not paths[i]:
            rates[i] = math.inf
    while unfrozen:
        best_key, best_share = None, math.inf
        for key, lv in live.items():
            if lv == 0:
                continue
            share = cap[key] / lv
            if share < best_share:
                best_key, best_share = key, share
        if best_key is None:  # pragma: no cover - every flow has links
            break
        for i in users[best_key]:
            if i not in unfrozen:
                continue
            rates[i] = best_share
            unfrozen.discard(i)
            for l in paths[i]:
                cap[l.key] = max(0.0, cap[l.key] - best_share)
                live[l.key] -= 1
    return rates


class FlowSim:
    """The shared flow-level data plane over one cluster topology."""

    def __init__(
        self,
        topo: Topology,
        *,
        spine_oversub: float = 1.0,
        spine_planes: int = 1,
        scaleup_gbps: float = NVLINK_GBPS,
        link_latency_s: float = 0.0,
        switch_latency_s: float = 0.0,
        link_profiles=None,
        incremental: bool = True,
    ):
        self.net = NetworkModel(
            topo,
            spine_oversub=spine_oversub,
            spine_planes=spine_planes,
            scaleup_gbps=scaleup_gbps,
            link_latency_s=link_latency_s,
            switch_latency_s=switch_latency_s,
            link_profiles=link_profiles,
        )
        self.flows: list[Flow] = []
        self.now = 0.0
        self.completed_count = 0
        self.aborted_count = 0
        #: False selects the pre-refactor reference engine: full max-min on
        #: every event and linear min/done scans.  Allocations and event
        #: streams are bit-for-bit identical either way (property-tested);
        #: the flag exists as the equivalence oracle and the net_scale
        #: benchmark baseline.
        self.incremental = incremental
        self._subscribers: list[Callable[[NetEvent], None]] = []
        # optional link-time ledger (repro.obs.ledger.LinkLedger): accrues
        # per-link bytes/busy-seconds by flow kind on every integration
        # step.  None (the default) keeps the data plane untouched — no
        # events, no extra arithmetic, golden traces bit-for-bit.
        self.ledger = None
        # -- indices (maintained in BOTH engines; the reference engine only
        # uses them where results are provably identical: router plane
        # loads, introspection, failure eviction) -------------------------
        self._next_seq = 0
        self._link_flows: dict[LinkKey, dict[Flow, None]] = {}
        self._src_flows: dict[int, dict[Flow, None]] = {}
        self._dst_flows: dict[int, dict[Flow, None]] = {}
        # -- event calendar (incremental engine only): heap of
        # (projected_t, flow.seq, flow.cal_gen, flow) --------------------
        self._cal: list[tuple[float, int, int, Flow]] = []

    # -- event subscription --------------------------------------------------
    def subscribe(self, cb: Callable[[NetEvent], None]) -> Callable:
        """Deliver every :class:`NetEvent` to ``cb`` in simulation order.
        Returns ``cb`` so ``sim.subscribe(FlowEventLog())`` reads naturally."""
        self._subscribers.append(cb)
        return cb

    def unsubscribe(self, cb: Callable[[NetEvent], None]) -> None:
        if cb in self._subscribers:
            self._subscribers.remove(cb)

    def attach_ledger(self, ledger):
        """Attach a :class:`repro.obs.ledger.LinkLedger` (duck-typed:
        anything with ``accrue_flow(flow, moved_bytes, dt)`` and
        ``note_time(now)``).  Returns the ledger for chaining."""
        self.ledger = ledger
        return ledger

    def _emit(self, kind: str, **kw) -> None:
        if not self._subscribers:
            return
        event = NetEvent(kind, self.now, **kw)
        for cb in list(self._subscribers):
            cb(event)

    # -- latency -------------------------------------------------------------
    @property
    def has_latency(self) -> bool:
        """True when any link carries a latency term — the flag the multicast
        planner keys its latency-aware ranking on (a zero-latency network
        plans bit-for-bit like the pure bandwidth model)."""
        return self.net.has_latency

    def route_latency(self, src: int, dst: int) -> float:
        """Nominal (plane-0) first-byte latency of a src->dst path."""
        return self.net.route_latency(src, dst)

    def hop_latency(self, src: int, dst: int) -> float:
        """Worst-case src->dst first-byte latency across live spine planes —
        what a multicast planner (and a chain execution charging downstream
        hops their upstream store-and-forward delay) should budget per hop:
        routing picks planes by load, not latency, so the slowest live plane
        bounds when the next hop's first byte can move."""
        return self.net.hop_latency(src, dst)

    def _flow_latency(self, flow: Flow) -> float:
        return self.net.path_latency(flow.path) + flow.extra_latency_s

    # -- flow / endpoint indices ---------------------------------------------
    def _index(self, f: Flow) -> None:
        for l in f.path:
            self._link_flows.setdefault(l.key, {})[f] = None
        self._src_flows.setdefault(f.src, {})[f] = None
        self._dst_flows.setdefault(f.dst, {})[f] = None

    def _unindex(self, f: Flow) -> None:
        for l in f.path:
            d = self._link_flows.get(l.key)
            if d is not None:
                d.pop(f, None)
                if not d:
                    del self._link_flows[l.key]
        for table, key in ((self._src_flows, f.src), (self._dst_flows, f.dst)):
            d = table.get(key)
            if d is not None:
                d.pop(f, None)
                if not d:
                    del table[key]

    def _set_path(self, f: Flow, path: list[Link]) -> None:
        """Reroute ``f`` onto ``path``, keeping the link index coherent."""
        for l in f.path:
            d = self._link_flows.get(l.key)
            if d is not None:
                d.pop(f, None)
                if not d:
                    del self._link_flows[l.key]
        f.path = path
        for l in path:
            self._link_flows.setdefault(l.key, {})[f] = None

    # -- event calendar -------------------------------------------------------
    # Projected keys are refreshed lazily: eager per-step integration drifts
    # a completion projection by ulps between refreshes, so every pop-side
    # consumer evaluates candidates within _cal_pad of the boundary with the
    # exact per-flow expressions and treats the key only as an ordering hint.
    def _cal_pad(self, scale: float = 0.0) -> float:
        return 1e-7 * (1.0 + abs(self.now) + scale)

    def _cal_push(self, f: Flow) -> None:
        """(Re)schedule ``f``'s calendar entry, invalidating any prior one.
        Completion entries are keyed by the projected time the flow enters
        its done-epsilon zone; activation entries by the exact activation
        time.  Background flows and stalled (rate-0) flows outside the done
        zone schedule nothing — they impose no future event."""
        f.cal_gen += 1
        if f.active_at is not None:
            heapq.heappush(self._cal, (f.active_at, f.seq, f.cal_gen, f))
            return
        if f.background:
            return
        eps = flow_done_eps(f.size)
        if f.rate > 0.0:
            key = self.now + (f.remaining - eps) / f.rate
        elif f.remaining <= eps:
            key = self.now  # already in the done zone, just stalled
        else:
            return
        heapq.heappush(self._cal, (key, f.seq, f.cal_gen, f))
        if len(self._cal) > 64 and len(self._cal) > 4 * len(self.flows):
            self._cal = [e for e in self._cal if e[2] == e[3].cal_gen]
            heapq.heapify(self._cal)

    def _next_dt(self) -> float:
        """Exact min over flows of ``active_at - now`` (propagating) and
        ``remaining / rate`` (active) — bit-for-bit the reference engine's
        linear scan, computed from the calendar: pop every candidate whose
        key could still beat the best exact value, evaluate it exactly,
        re-push with a refreshed key."""
        cal = self._cal
        best = math.inf
        bound = math.inf
        repush: list[Flow] = []
        while cal:
            key, _, gen, f = cal[0]
            if gen != f.cal_gen:
                heapq.heappop(cal)
                continue
            if key - self.now > bound:
                break
            heapq.heappop(cal)
            if f.active_at is not None:
                d = f.active_at - self.now
            elif f.rate > 0.0:
                d = f.remaining / f.rate
            else:
                d = math.inf  # stalled in the done zone: no dt event
            repush.append(f)
            if d < best:
                best = d
                bound = best + self._cal_pad(best)
        for f in repush:
            self._cal_push(f)
        return best

    def _collect_done(self) -> list[Flow]:
        """Flows in the completion-epsilon zone, in admission order — the
        exact ``remaining <= eps`` test the reference engine scans for,
        applied only to calendar candidates at/near the current time."""
        cal = self._cal
        pad = self._cal_pad()
        done: list[Flow] = []
        repush: list[Flow] = []
        while cal:
            key, _, gen, f = cal[0]
            if gen != f.cal_gen:
                heapq.heappop(cal)
                continue
            if key - self.now > pad:
                break
            heapq.heappop(cal)
            if (
                f.active_at is None
                and not f.background
                and f.remaining <= flow_done_eps(f.size)
            ):
                done.append(f)
            else:
                repush.append(f)
        for f in repush:
            self._cal_push(f)
        done.sort(key=lambda f: f.seq)
        return done

    # -- routing -------------------------------------------------------------
    def _route(self, src: int, dst: int) -> list[Link] | None:
        """Pick a live path: for cross-leaf flows, the spine plane with the
        fewest active flows among non-failed planes.  None = no live path.
        Plane load is read from the link->flows index (one dict-len per
        spine link) instead of scanning every flow."""
        best, best_load = None, None
        for p in range(self.net.spine_planes):
            path = self.net.path(src, dst, plane=p)
            if any(l.failed for l in path):
                continue
            load = sum(
                len(self._link_flows.get(l.key, ())) for l in path if l.is_spine
            )
            if best is None or load < best_load:
                best, best_load = path, load
            if len(path) <= 2:  # intra-leaf / intra-scale-up: plane-independent
                break
        return best

    def device_ok(self, dev: int) -> bool:
        return self.net.device_ok(dev)

    def dead_devices(self) -> set[int]:
        """Accelerators whose NIC (either direction) is failed — the ONE
        definition of 'dead' every failure-subscription control plane
        (FleetScheduler, standalone ClusterRuntime) tears down against."""
        return {
            d.id
            for d in self.net.topo.devices
            if not d.is_host and not self.net.device_ok(d.id)
        }

    # -- flow lifecycle ------------------------------------------------------
    def start(self, flow: Flow, now: float | None = None) -> Flow:
        """Begin a transfer.  Advances to ``now`` first, so rates of already-
        running flows are settled before the newcomer claims its share."""
        self.start_many([flow], now)
        return flow

    def start_many(self, flows: Sequence[Flow], now: float | None = None) -> list[Flow]:
        """Begin a batch of transfers with ONE rate recomputation at the end
        — a multi-chain multicast plan joining a loaded network would
        otherwise run a progressive-filling pass per hop."""
        if now is not None:
            self.advance_to(now)
        instant: list[Flow] = []
        aborted: list[Flow] = []
        fresh_active: list[Flow] = []
        for flow in flows:
            flow.started_at = self.now
            self._emit(ev.FLOW_STARTED, flow=flow)  # every abort/completion
            path = self._route(flow.src, flow.dst)  # has a matching start
            if path is None:
                aborted.append(flow)
                continue
            flow.path = path
            if not path or flow.remaining <= 0.0:
                instant.append(flow)  # same-device (or empty) transfer
                continue
            lat = self._flow_latency(flow)
            if lat > 0.0:
                flow.active_at = self.now + lat  # first-byte setup
            flow.seq = self._next_seq
            self._next_seq += 1
            self.flows.append(flow)
            self._index(flow)
            if self.incremental:
                if flow.active_at is None:
                    fresh_active.append(flow)
                else:
                    flow.rate = 0.0  # propagating: contends with nobody
                    self._cal_push(flow)  # activation entry
        if self.incremental:
            if fresh_active:
                self._recompute(seeds=fresh_active)
        else:
            self._recompute()
        for flow in instant:
            flow.transferred = flow.size if math.isfinite(flow.size) else 0.0
            flow.remaining = 0.0
            flow.finished_at = self.now
            self.completed_count += 1
            if flow.on_complete:
                flow.on_complete(flow, self.now)
            self._emit(ev.FLOW_COMPLETED, flow=flow)
        for flow in aborted:
            self._abort(flow)
        return list(flows)

    def remove(self, flow: Flow, now: float | None = None, *, abort: bool = True) -> None:
        """Withdraw a flow (e.g. its consumer was drained).  ``abort=True``
        fires the flow's on_abort callback."""
        if now is not None:
            self.advance_to(now)
        if flow not in self.flows:
            return
        self.flows.remove(flow)
        self._unindex(flow)
        flow.cal_gen += 1  # drop any calendar entry
        if self.incremental:
            if flow.active_at is None:
                self._recompute(seeds=[flow])
            # a propagating flow held no bandwidth: nothing to re-solve
        else:
            self._recompute()
        if abort:
            self._abort(flow, removed=True)

    def _abort(self, flow: Flow, *, removed: bool = False) -> None:
        flow.aborted = True
        self.aborted_count += 1
        if flow.on_abort:
            flow.on_abort(flow, self.now)
        self._emit(ev.FLOW_ABORTED, flow=flow)

    # -- time ----------------------------------------------------------------
    def _done_eps(self, flow: Flow) -> float:
        return flow_done_eps(flow.size)

    def _activate_pending(self) -> bool:
        """Flip flows whose first-byte setup latency has elapsed into the
        contending set.  Returns True when any activation happened (rates
        were re-filled)."""
        if not self.incremental:
            hit = [
                f for f in self.flows
                if f.active_at is not None and f.active_at - self.now <= _EPS
            ]
            if not hit:
                return False
            for f in hit:
                f.active_at = None
            self._recompute()
            return True
        # calendar engine: due activations sit at (or near) the heap top;
        # completion entries inside the same window are re-pushed untouched
        cal = self._cal
        hit: list[Flow] = []
        repush: list[Flow] = []
        while cal:
            key, _, gen, f = cal[0]
            if gen != f.cal_gen:
                heapq.heappop(cal)
                continue
            if key - self.now > _EPS:
                break
            heapq.heappop(cal)
            if f.active_at is not None and f.active_at - self.now <= _EPS:
                hit.append(f)
            else:
                repush.append(f)
        for f in repush:
            self._cal_push(f)
        if not hit:
            return False
        for f in hit:
            f.active_at = None
        self._recompute(seeds=hit)
        return True

    def advance_to(self, now: float) -> list[Flow]:
        """Integrate to ``now``, settling completions (and latency-model
        activations) at their exact event times (rates are re-filled after
        every event).  Returns flows completed in completion order.  The
        incremental engine batches every same-timestamp completion into one
        settle + one component re-solve, exactly as the reference engine's
        epsilon-window scan did."""
        completed: list[Flow] = []
        self._activate_pending()
        while now - self.now > _EPS:
            if self.incremental:
                dt_evt = self._next_dt()
            else:
                dt_evt = math.inf
                for f in self.flows:
                    if f.active_at is not None:
                        dt_evt = min(dt_evt, f.active_at - self.now)
                    elif not f.background and f.rate > 0.0:
                        dt_evt = min(dt_evt, f.remaining / f.rate)
            step = min(now - self.now, dt_evt)
            if step > 0.0:
                led = self.ledger
                for f in self.flows:
                    if f.active_at is None and f.rate > 0.0:
                        moved = f.rate * step
                        f.transferred += moved
                        if not f.background:
                            f.remaining -= moved
                        if led is not None:
                            led.accrue_flow(f, moved, step)
                self.now += step
            activated = self._activate_pending()
            if self.incremental:
                done = self._collect_done()
            else:
                done = [
                    f for f in self.flows
                    if f.active_at is None
                    and not f.background
                    and f.remaining <= self._done_eps(f)
                ]
            if done:
                for f in done:
                    f.remaining = 0.0
                    f.transferred = float(f.size)
                    f.finished_at = self.now
                    self.flows.remove(f)
                    self._unindex(f)
                    f.cal_gen += 1
                    self.completed_count += 1
                    completed.append(f)
                if self.incremental:
                    self._recompute(seeds=done)
                else:
                    self._recompute()
                for f in done:
                    if f.on_complete:
                        f.on_complete(f, self.now)
                for f in done:
                    self._emit(ev.FLOW_COMPLETED, flow=f)
            if step <= 0.0 and not done and not activated:
                break  # nothing can progress (all flows stalled at rate 0)
        if now > self.now:
            self.now = now
        self._activate_pending()
        if self.ledger is not None:
            self.ledger.note_time(self.now)
        return completed

    def next_event_time(self) -> float | None:
        """When the earliest in-flight flow finishes under current rates (or
        a propagating flow activates and rates change) — where a discrete-
        event driver should schedule its next net poll.  O(candidates) off
        the calendar top in the incremental engine."""
        if not self.incremental:
            ts = [
                self.now + f.remaining / f.rate
                for f in self.flows
                if f.active_at is None and not f.background and f.rate > 0.0
            ]
            ts.extend(f.active_at for f in self.flows if f.active_at is not None)
            return min(ts) if ts else None
        cal = self._cal
        best = math.inf
        bound = math.inf
        repush: list[Flow] = []
        while cal:
            key, _, gen, f = cal[0]
            if gen != f.cal_gen:
                heapq.heappop(cal)
                continue
            if key > bound:
                break
            heapq.heappop(cal)
            if f.active_at is not None:
                t = f.active_at
            elif f.rate > 0.0:
                t = self.now + f.remaining / f.rate
            else:
                t = math.inf  # stalled in the done zone
            repush.append(f)
            if t < best:
                best = t
                bound = best + self._cal_pad(abs(best))
        for f in repush:
            self._cal_push(f)
        return best if math.isfinite(best) else None

    # -- rate allocation -----------------------------------------------------
    def _recompute(self, seeds: Sequence[Flow] | None = None) -> None:
        """Re-solve max-min rates.  ``seeds=None`` (or the reference engine)
        re-solves every flow; otherwise only the connected component of the
        flow/link sharing graph reachable from ``seeds`` — which progressive
        filling provably allocates identically to the full solve, float for
        float."""
        if not self.incremental or seeds is None:
            active = [f for f in self.flows if f.active_at is None]
            rates = maxmin_rates([f.path for f in active])
            for f, r in zip(active, rates):
                f.rate = r
            for f in self.flows:
                if f.active_at is not None:
                    f.rate = 0.0  # still propagating: contends with nobody
            if self.incremental:
                for f in active:
                    self._cal_push(f)
            return
        comp = self._component(seeds)
        if not comp:
            return
        comp.sort(key=lambda f: f.seq)  # full-solve enumeration order
        rates = maxmin_rates([f.path for f in comp])
        for f, r in zip(comp, rates):
            f.rate = r
            self._cal_push(f)

    def _component(self, seeds: Sequence[Flow]) -> list[Flow]:
        """Active flows transitively sharing a link with any seed (seeds
        themselves included only while still indexed — removed flows seed
        their old neighbourhood without rejoining it)."""
        comp: list[Flow] = []
        seen: set[Flow] = set()
        links_done: set[LinkKey] = set()
        stack = list(seeds)
        while stack:
            f = stack.pop()
            for l in f.path:
                if l.key in links_done:
                    continue
                links_done.add(l.key)
                for g in self._link_flows.get(l.key, ()):
                    if g.active_at is None and g not in seen:
                        seen.add(g)
                        comp.append(g)
                        stack.append(g)
        return comp

    # -- scenario knobs ------------------------------------------------------
    def degrade_link(self, key: LinkKey, multiplier: float, now: float | None = None) -> None:
        """Scale a link's capacity (1.0 restores it).  Takes effect as a
        rate-change event at ``now``.  Capacity mutations re-solve the FULL
        allocation — they can shift rates in every component at once."""
        if now is not None:
            self.advance_to(now)
        self.net.link(key).degrade = multiplier
        self._recompute()
        self._emit(ev.LINK_DEGRADED, link_key=key)

    def fail_link(self, key: LinkKey, now: float | None = None) -> list[Flow]:
        """Fail one directed link.  Flows crossing it re-route onto a
        surviving spine plane when possible (emitting FLOW_REROUTED);
        otherwise they abort (their ``on_abort`` fires — the re-planning
        hook).  Returns aborted flows.  Subscribers see LINK_FAILED *after*
        the aborts and reroutes have settled, so a control plane reacting to
        it observes the post-failure network."""
        if now is not None:
            self.advance_to(now)
        link = self.net.link(key)
        link.failed = True
        aborted = self._evict_failed(failed_keys=(key,))
        self._emit(ev.LINK_FAILED, link_key=key)
        return aborted

    def fail_device(self, dev: int, now: float | None = None) -> list[Flow]:
        """Fail a whole device: its NIC links go down AND any flow with the
        device as an endpoint aborts (scale-up fabric hops included — the
        accelerator is gone, not just its scale-out port)."""
        if now is not None:
            self.advance_to(now)
        self.net.link((DEV_OUT, dev)).failed = True
        self.net.link((DEV_IN, dev)).failed = True
        aborted = self._evict_failed(
            dead_devs={dev}, failed_keys=((DEV_OUT, dev), (DEV_IN, dev))
        )
        self._emit(ev.DEVICE_FAILED, device=dev)
        return aborted

    def fail_leaf(self, leaf: int, now: float | None = None) -> list[Flow]:
        """Fail a whole leaf switch: every member NIC and every uplink."""
        if now is not None:
            self.advance_to(now)
        keys: list[LinkKey] = []
        for d in self.net.topo.devices:
            if d.leaf == leaf:
                keys += [(DEV_OUT, d.id), (DEV_IN, d.id)]
        for p in range(self.net.spine_planes):
            keys += [(LEAF_UP, leaf, p), (LEAF_DOWN, leaf, p)]
        for key in keys:
            self.net.link(key).failed = True
        aborted = self._evict_failed(failed_keys=keys)
        self._emit(ev.LEAF_FAILED, leaf=leaf)
        return aborted

    def recover_link(self, key: LinkKey, now: float | None = None) -> None:
        if now is not None:
            self.advance_to(now)
        self.net.link(key).failed = False
        self._recompute()
        self._emit(ev.LINK_RECOVERED, link_key=key)

    def recover_device(self, dev: int, now: float | None = None) -> None:
        if now is not None:
            self.advance_to(now)
        self.net.link((DEV_OUT, dev)).failed = False
        self.net.link((DEV_IN, dev)).failed = False
        self._recompute()
        self._emit(ev.DEVICE_RECOVERED, device=dev)

    def _evict_failed(
        self,
        dead_devs: set[int] = frozenset(),
        failed_keys: Iterable[LinkKey] | None = None,
    ) -> list[Flow]:
        """Settle flows hit by the links in ``failed_keys`` / the devices in
        ``dead_devs``: re-route onto a surviving plane (re-charging first-
        byte latency for flows still propagating, since their budget came
        from the dead path) or abort.  Candidates come from the link and
        endpoint indices — live flows never cross an already-failed link
        (routing and prior evictions guarantee it), so the newly failed
        keys bound the damage.  ``failed_keys=None`` falls back to a full
        sweep."""
        if failed_keys is None and not dead_devs:
            candidates = list(self.flows)
        else:
            cand: dict[Flow, None] = {}
            for key in failed_keys or ():
                for f in self._link_flows.get(key, ()):
                    cand[f] = None
            for dev in sorted(dead_devs):
                for f in self._src_flows.get(dev, ()):
                    cand[f] = None
                for f in self._dst_flows.get(dev, ()):
                    cand[f] = None
            candidates = sorted(cand, key=lambda f: f.seq)
        aborted: list[Flow] = []
        rerouted: list[Flow] = []
        for f in candidates:
            endpoint_dead = f.src in dead_devs or f.dst in dead_devs
            if not endpoint_dead and not any(l.failed for l in f.path):
                continue
            alt = None if endpoint_dead else self._route(f.src, f.dst)
            if alt is not None and alt:
                self._set_path(f, alt)  # re-routed onto a surviving plane
                if f.active_at is not None:
                    # its first byte never escaped the dead path: the setup
                    # charge restarts on the new path's latency
                    f.active_at = self.now + self._flow_latency(f)
                    f.cal_gen += 1
                    if self.incremental:
                        self._cal_push(f)
                rerouted.append(f)
            else:
                self.flows.remove(f)
                self._unindex(f)
                f.cal_gen += 1
                aborted.append(f)
        self._recompute()  # full: capacities and paths changed
        for f in aborted:
            self._abort(f, removed=True)
        for f in rerouted:
            self._emit(ev.FLOW_REROUTED, flow=f)
        return aborted

    # -- what-if estimation (non-mutating) -----------------------------------
    def estimate_transfer_time(
        self, src: int, dst: int, nbytes: float, *, max_events: int = 10_000
    ) -> float:
        """Seconds a hypothetical src->dst transfer of ``nbytes`` would take
        under the CURRENT traffic (existing flows run to completion, no new
        arrivals).  Pure — the live state is untouched.  ``inf`` when no
        live path exists.  Includes the latency model: the hypothetical
        flow (and any still-propagating live flow) only starts claiming
        bandwidth once its first-byte setup has elapsed.  Completion uses
        :func:`flow_done_eps` — the SAME threshold as the live engine, so a
        what-if answer and the realized completion agree even on tiny
        flows.  Used by FleetScheduler placement affinity."""
        path = self._route(src, dst)
        if path is None:
            return math.inf
        if not path or nbytes <= 0:
            return 0.0
        paths = [f.path for f in self.flows]
        rem = [f.remaining for f in self.flows]
        fin = [not f.background for f in self.flows]
        eps = [self._done_eps(f) for f in self.flows]
        # time (from now) at which each flow starts claiming bandwidth
        act = [
            max(0.0, f.active_at - self.now) if f.active_at is not None else 0.0
            for f in self.flows
        ]
        paths.append(list(path))
        rem.append(float(nbytes))
        fin.append(True)
        eps.append(flow_done_eps(float(nbytes)))
        act.append(self.net.path_latency(path))
        target = len(paths) - 1
        t = 0.0
        for _ in range(max_events):
            live = [i for i in range(len(paths)) if act[i] <= t + _EPS]
            rates_live = maxmin_rates([paths[i] for i in live])
            rates = [0.0] * len(paths)
            for i, r in zip(live, rates_live):
                rates[i] = r
            dt = math.inf
            for i in range(len(paths)):
                if act[i] > t + _EPS:
                    dt = min(dt, act[i] - t)  # activation boundary
                elif fin[i] and rates[i] > 0.0:
                    dt = min(dt, rem[i] / rates[i])
            if not math.isfinite(dt):
                return math.inf  # stalled (zero-capacity link on the path)
            t += dt
            done_idx = []
            for i in range(len(paths)):
                if rates[i] > 0.0 and fin[i]:
                    rem[i] -= rates[i] * dt
                    if rem[i] <= eps[i]:
                        done_idx.append(i)
            if target in done_idx:
                return t
            for i in reversed(done_idx):
                del paths[i], rem[i], fin[i], act[i], eps[i]
                if i < target:
                    target -= 1
        return math.inf  # pragma: no cover - event budget exhausted

    # -- introspection -------------------------------------------------------
    def flows_through(self, key: LinkKey) -> list[Flow]:
        return sorted(self._link_flows.get(key, ()), key=lambda f: f.seq)

    def flows_into(self, dev: int, kinds: Iterable[FlowKind] | None = None) -> list[Flow]:
        ks = set(kinds) if kinds is not None else None
        fs = sorted(self._dst_flows.get(dev, ()), key=lambda f: f.seq)
        return [f for f in fs if ks is None or f.kind in ks]

    def utilization(self, key: LinkKey) -> float:
        link = self.net.link(key)
        if link.rate_cap <= 0.0:
            return 0.0
        used = sum(f.rate for f in self.flows_through(key) if math.isfinite(f.rate))
        return used / link.rate_cap
