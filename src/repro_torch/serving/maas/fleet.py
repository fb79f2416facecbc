"""Fleet-wide GPU arbitration for serverless multi-model MaaS (paper §1, §5.3).

The paper's premise is that many models share one GPU fleet: each scales up
in seconds via GPU-to-GPU multicast, and *down to zero accelerators* — only
the single O(1) host-DRAM copy in the shared :class:`ParameterPool` remains
— so the fleet's free devices are a common pool every model draws from.
This module is the control plane that makes those decisions:

  * **arbitration** — each tick, free devices are granted to per-model
    runtimes in priority order (priority = SLO pressure × queue depth);
    grants a runtime does not consume flow back the next tick, so devices
    move between models at tick granularity;
  * **scale-to-zero** — a model idle past a timeout drains all engines and
    releases every device; the ParameterPool keeps exactly one host copy;
  * **cold start** — a request for a parked model triggers a re-multicast
    live-scale from a surviving GPU copy (possibly a draining co-instance)
    or, when none exists, the O(1) host copy;
  * **preemption** — when a hot model is starved (pressure above bound, no
    free device), the lowest-priority idle model is drained to give up
    devices.

The per-model scaling *mechanism* stays inside each
:class:`~repro_torch.serving.disagg.runtime.ClusterRuntime` (live-scaling,
mutation, decode pre-scaling, §5.4); the fleet only decides who may hold
which accelerator.

The port's copy of ``repro.serving.maas.fleet``.  Each tenant's runtime
builds its engines on the one parameter dict ``add_model`` is given.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import topology as topo_mod
from repro_torch.core.parameter_pool import ParameterPool
from repro_torch.net import FAILURE_KINDS, FlowSim, NetEvent
from repro_torch.obs.metrics import MetricRegistry, StatBlock
from repro_torch.obs.trace import NULL_TRACER, NetEventBridge
from repro_torch.serving.disagg import pools as P
from repro_torch.serving.disagg.runtime import ClusterRuntime
from repro_torch.serving.maas import tenant as T
from repro_torch.serving.maas.tenant import Tenant


@dataclasses.dataclass
class FleetPolicy:
    idle_to_zero_s: float = 3.0  # drain a model idle this long (scale-to-zero)
    grow_pressure: float = 1.0  # grant devices above this SLO pressure
    starve_pressure: float = 1.0  # an unserved demander above this may preempt
    preempt_pressure: float = 0.5  # victims must be *below* this priority
    max_grant_per_tick: int = 2  # per-tenant grant rate limit
    arbitration: bool = True  # False = static allocation (benchmark baseline)
    # SLO-burn tie-break: at equal arbitration pressure, a tenant whose SLO
    # monitor says ``page`` outranks one at ``warn`` outranks ``ok`` — the
    # fleet_health() surface feeding back into the grant loop.  No-op when
    # no SLOMonitor is attached.
    slo_aware_arbitration: bool = True
    scale_to_zero: bool = True
    # admission control: when the fleet saturates (no grantable device and
    # every demander above saturation_pressure), queued requests of the
    # LOWEST SLO class present are shed beyond this depth instead of letting
    # queues grow unboundedly
    admission_control: bool = True
    saturation_pressure: float = 1.0
    shed_queue_depth: int = 64
    # placement affinity: FlowSim transfer-time estimates are computed for
    # at most this many affinity-ranked candidates per grant decision
    affinity_estimates: int = 8


@dataclasses.dataclass
class FleetStats(StatBlock):
    cold_starts: int = 0
    scale_to_zero_events: int = 0
    preemptions: int = 0
    grants: int = 0  # devices handed out by arbitration
    rejections: int = 0  # requests shed by admission control
    gpu_seconds: float = 0.0  # fleet-wide device-seconds occupied by engines
    grant_cancellations: int = 0  # granted devices revoked on NIC/leaf death
    failure_regrants: int = 0  # engines re-granted by the failure subscription


class FleetScheduler:
    """N models on one shared topology + one shared O(1) parameter pool."""

    def __init__(
        self,
        topo: topo_mod.Topology,
        *,
        policy: FleetPolicy | None = None,
        net: FlowSim | None = None,
        tracer=None,
        metrics: MetricRegistry | None = None,
        ledger=None,
        slo_monitor=None,
        flight_recorder=None,
        verbose: bool = False,
    ):
        self.topo = topo
        self.policy = policy or FleetPolicy()
        self.param_pool = ParameterPool(topo)
        # ONE flow-level network simulator for the whole fleet: every
        # tenant's KV migrations, live-scale parameter streams and cold
        # starts contend on the same links (and its transfer-time estimates
        # drive placement affinity)
        self.net = net if net is not None else FlowSim(topo)
        self.tenants: dict[str, Tenant] = {}
        # ONE registry for the whole fleet: FleetStats plus every tenant's
        # RuntimeStats/TenantStats mirror into it under fleet./runtime.<m>./
        # tenant.<m>. prefixes — one queryable, JSON-able surface
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # ONE flow->span bridge for the whole fleet (the FlowSim is shared:
        # per-runtime bridges would emit duplicate spans per flow); tenant
        # runtimes receive it so _live_scale can pin its parameter flows
        # under the scale_op span
        self.bridge = None
        if self.tracer.enabled:
            self.bridge = NetEventBridge(self.tracer)
            self.net.subscribe(self.bridge)
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.stats = FleetStats().bind(self.metrics, "fleet")
        # fleet-wide device-time ledger: tenant runtimes accrue their own
        # engine states into it (owner = model name); the fleet adds only
        # the granted-but-unconsumed FREE devices, so nothing double-bills
        self.ledger = ledger
        # streaming SLO monitor: fed per-tenant from completed requests each
        # tick; fleet_health() is its observe-only summary surface
        self.slo_monitor = slo_monitor
        # anomaly-triggered flight recorder: rides the same FlowSim
        # subscription for failure triggers; SLO-page escalations are
        # edge-detected by poll() at the end of every tick
        self.flight_recorder = flight_recorder
        if flight_recorder is not None:
            flight_recorder.attach(self.net)
        self.verbose = verbose
        self._last_tick: float | None = None
        # first-class failure subscription: the scheduler learns of a
        # leaf/device death the instant the FlowSim processes it — not one
        # tick later via the victim runtime's drain path — and immediately
        # cancels doomed grants and re-grants on surviving leaves
        self.net.subscribe(self._on_net_event)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    # -- fleet membership ----------------------------------------------------
    def free_devices(self) -> list[int]:
        """Spare accelerators owned by no tenant — the arbitration pool.
        Devices with a failed NIC are not grantable."""
        owned: set[int] = set()
        for t in self.tenants.values():
            if t.runtime.allowed_devices:
                owned |= t.runtime.allowed_devices
        return [
            d.id
            for d in self.topo.spares()
            if d.id not in owned and self.net.device_ok(d.id)
        ]

    def add_model(
        self,
        cfg,
        params,
        *,
        n_prefill: int = 1,
        n_decode: int = 1,
        slo_class: str = T.LATENCY,
        **runtime_kw,
    ) -> Tenant:
        """Register a model with the fleet and seat it on free devices.

        The runtime shares the fleet's topology, ParameterPool and FlowSim;
        its allowed-device set starts as exactly the initial grant, so it
        can never provision outside what arbitration hands it.

        ``slo_class`` is the tenant's SLO tier (``tenant.LATENCY`` or
        ``tenant.THROUGHPUT``): it weights arbitration priority and decides
        who is shed first under admission control."""
        if cfg.name in self.tenants:
            raise ValueError(f"model {cfg.name!r} already registered")
        free = self.free_devices()
        need = n_prefill + n_decode
        if need > len(free):
            raise ValueError(
                f"model {cfg.name!r} needs {need} devices but the fleet has "
                f"only {len(free)} free"
            )
        rt = ClusterRuntime(
            cfg,
            params,
            topo=self.topo,
            param_pool=self.param_pool,
            allowed_devices=free[:need],
            n_prefill=n_prefill,
            n_decode=n_decode,
            net=self.net,
            # the fleet subscribes to FlowSim failures once, fleet-wide,
            # and drives teardown/re-grant itself — a per-runtime
            # subscription would double-handle every failure
            failure_subscription=False,
            tracer=self.tracer,
            bridge=self.bridge,
            metrics=self.metrics,
            ledger=self.ledger,
            **runtime_kw,
        )
        t = Tenant(cfg.name, rt, slo_class=slo_class)
        t.stats.bind(self.metrics, f"tenant.{cfg.name}")
        self.tenants[cfg.name] = t
        return t

    # -- request intake ------------------------------------------------------
    def submit(self, model: str, prompt, max_new_tokens: int, now: float) -> int:
        t = self.tenants[model]
        t.note_arrival()
        return t.runtime.submit(prompt, max_new_tokens, now)

    @property
    def n_outstanding(self) -> int:
        return sum(t.runtime.n_outstanding for t in self.tenants.values())

    # -- the control loop ----------------------------------------------------
    def tick(self, now: float) -> dict[str, list[int]]:
        """One fleet iteration; returns rids completed this tick per model."""
        p = self.policy
        dt = 0.0 if self._last_tick is None else max(0.0, now - self._last_tick)
        self._last_tick = now

        # 0. GPU-time accounting: device-seconds occupied by engines
        #    (loading and draining engines hold their device too)
        for t in self.tenants.values():
            held = t.runtime.n_engines * dt
            t.stats.gpu_seconds += held
            self.stats.gpu_seconds += held
        if self.ledger is not None and dt > 0:
            # granted devices no engine occupies yet are still billed to the
            # tenant holding the grant (engine-held time is accrued by each
            # runtime itself inside tick())
            for t in self.tenants.values():
                for dev in t.runtime.allowed_devices or ():
                    if self.topo.device(dev).role is topo_mod.Role.FREE:
                        self.ledger.accrue("allocated_idle", dt, owner=t.name)

        if p.arbitration:
            # 1. grants not consumed by a scale-up flow back to the fleet
            for t in self.tenants.values():
                t.runtime.release_devices()

        # 2. scale-to-zero: drain models idle past the timeout
        if p.scale_to_zero:
            for t in self.tenants.values():
                if t.busy:
                    t.idle_since = None
                elif t.state == T.ACTIVE and t.runtime.n_engines > 0:
                    if t.idle_since is None:
                        t.idle_since = now
                    elif now - t.idle_since >= p.idle_to_zero_s:
                        t.runtime.drain_all()
                        t.state = T.DRAINING
                        self._log(f"[fleet] {t.name}: idle -> draining to zero")

        # 3. arbitration: free devices go to demanders, hottest first (class
        #    weight breaks priority ties); tenants at zero capacity with
        #    waiting work cold-start.  Grants follow placement affinity:
        #    devices in leaves holding a surviving GPU copy first, ranked by
        #    FlowSim-estimated transfer time under current traffic.
        starved: list[tuple[Tenant, int]] = []
        if p.arbitration:
            # SLO-burn tie-break: fleet_health() closes the loop here — at
            # equal pressure a paging tenant outranks a warning one outranks
            # a healthy one (all-zeros when unmonitored or disabled, so the
            # sort degrades to the pressure-only policy)
            slo_rank = self._slo_ranks(now)
            ranked = sorted(
                self.tenants.values(),
                key=lambda t: (t.priority(), slo_rank.get(t.name, 0),
                               t.class_weight),
                reverse=True,
            )
            free = set(self.free_devices())
            for t in ranked:
                want = self._demand(t)
                granted: list[int] = []
                if want > 0 and free:
                    for dev in self._rank_free_for(t, free):
                        if want <= 0:
                            break
                        granted.append(dev)
                        free.discard(dev)
                        want -= 1
                if granted:
                    t.runtime.acquire_devices(granted)
                    self.stats.grants += len(granted)
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "grant", now, cat="fleet", track="fleet",
                            model=t.name, devices=list(granted))
                    self._log(f"[fleet] {t.name}: granted devices {granted}")
                    if self._needs_cold_start(t):
                        host_starts_before = t.runtime.stats.cold_starts_from_host
                        started = t.runtime.cold_start(now)
                        if started:
                            from_host = (
                                t.runtime.stats.cold_starts_from_host > host_starts_before
                            )
                            t.state = T.ACTIVE
                            self.stats.cold_starts += 1
                            if self.tracer.enabled:
                                self.tracer.instant(
                                    "cold_start", now, cat="fleet",
                                    track="fleet", model=t.name,
                                    from_host=from_host)
                            self._log(
                                f"[fleet] {t.name}: cold start ({started} "
                                f"engine(s), source="
                                f"{'host O(1) copy' if from_host else 'GPU copy'})"
                            )
                if want > 0 and (
                    self._needs_cold_start(t)
                    or t.runtime.slo_pressure() >= p.starve_pressure
                ):
                    starved.append((t, want))

            # 4. preemption: starved hot models reclaim devices from idle ones
            for t, want in starved:
                self._preempt_for(t, want, now)

            # 4.5 admission control: fleet-wide saturation (nothing grantable
            # and every demander above the pressure bound) -> shed the
            # lowest-class tenants' excess queue with explicit rejections
            if p.admission_control and not free:
                self._admission_control(now)

        # 5. advance every runtime; finalize drain-to-zero transitions
        finished: dict[str, list[int]] = {}
        for name, t in self.tenants.items():
            finished[name] = t.runtime.tick(now)
            if self.slo_monitor is not None:
                for rid in finished[name]:
                    rec = t.runtime.router.records.get(rid)
                    if rec is None:
                        continue
                    if rec.ttft is not None:
                        self.slo_monitor.observe_ttft(name, now, rec.ttft)
                    for tbt in rec.tbts():
                        self.slo_monitor.observe_tbt(name, now, tbt)
            if t.fully_drained():
                t.state = T.ZERO
                t.idle_since = None
                # defensive: every GPU copy must be reclaimed by now — the
                # pool keeps exactly the single O(1) host copy
                self.param_pool.deactivate(t.name)
                t.runtime.release_devices()
                t.stats.scaled_to_zero += 1
                self.stats.scale_to_zero_events += 1
                self._log(f"[fleet] {t.name}: at zero (host copy only)")
        if self.flight_recorder is not None:
            # after this tick's SLO observations landed, so a page triggered
            # by them dumps in the same tick it escalates
            self.flight_recorder.poll(now)
        return finished

    # -- failure subscription ------------------------------------------------
    def _on_net_event(self, event: NetEvent) -> None:
        if event.kind in FAILURE_KINDS:
            self._handle_failure(event.t)

    def _handle_failure(self, now: float) -> None:
        """React to a link/device/leaf failure the moment the FlowSim emits
        it: revoke grants on dead devices, tear down live-scales that were
        loading onto them (the runtime's abort callback already marked them;
        we retire them NOW instead of waiting for its drain path), re-rank
        placement affinity against the post-failure network, and re-grant +
        restart each lost engine on a surviving leaf — all within the same
        event, so a cold start survives a mid-flight leaf death without
        losing a tick."""
        dead = self.net.dead_devices()
        if not dead:
            return
        for t in self.tenants.values():
            rt = t.runtime
            revoked = rt.revoke_devices(dead)
            self.stats.grant_cancellations += len(revoked)
            lost = rt.fail_devices(dead, now)
            if not lost:
                continue
            # affinity is re-ranked from scratch: dead devices are no longer
            # grantable and estimates route around failed links
            ranked = self._rank_free_for(t, set(self.free_devices()))
            for phase in lost:
                if not ranked:
                    break  # nothing survives; regular arbitration retries
                dev = ranked.pop(0)
                rt.acquire_devices([dev])
                if rt.restart_scale(phase, now, target=dev) is not None:
                    self.stats.failure_regrants += 1
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "failure_regrant", now, cat="fleet",
                            track="fleet", model=t.name, device=dev,
                            phase=phase)
                    self._log(
                        f"[fleet] {t.name}: failure re-grant -> {phase} "
                        f"live-scale on dev {dev}"
                    )

    # -- internals -----------------------------------------------------------
    _SLO_RANK = {"ok": 0, "warn": 1, "page": 2}

    def _slo_ranks(self, now: float) -> dict[str, int]:
        """Per-tenant burn-rate severity for the arbitration tie-break;
        empty (rank 0 for everyone) when unmonitored or disabled."""
        if self.slo_monitor is None or not self.policy.slo_aware_arbitration:
            return {}
        return {
            name: self._SLO_RANK.get(
                self.slo_monitor.tenant_health(name, now).get("status", "ok"), 0)
            for name in self.tenants
        }

    def _rank_free_for(self, t: Tenant, free: set[int]) -> list[int]:
        """Placement-affinity order for granting ``free`` devices to ``t``:
        leaves holding a surviving GPU copy of the model first (the cold
        start / scale-up multicast stays intra-leaf — ROADMAP next-steps
        item), then by the FlowSim's estimated parameter transfer time from
        the nearest source under whatever traffic is currently live."""
        cands = sorted(free)
        gpu_srcs, host = self.param_pool.sources(t.name)
        gpu_srcs = [s for s in gpu_srcs if self.net.device_ok(s)]
        src_devs = gpu_srcs or [
            d.id
            for d in self.topo.devices
            if d.is_host and d.host == host and self.net.device_ok(d.id)
        ]
        if not src_devs:
            return cands
        src_leaves = {self.topo.leaf_of(i) for i in src_devs}

        def nearest_src(dev: int) -> int:
            leaf = self.topo.leaf_of(dev)
            same = [s for s in src_devs if self.topo.leaf_of(s) == leaf]
            return same[0] if same else src_devs[0]

        cands.sort(key=lambda d: 0 if self.topo.leaf_of(d) in src_leaves else 1)
        head = cands[: self.policy.affinity_estimates]
        est = {
            d: self.net.estimate_transfer_time(nearest_src(d), d, t.runtime.model_bytes)
            for d in head
        }
        head.sort(
            key=lambda d: (
                0 if self.topo.leaf_of(d) in src_leaves else 1,
                est[d],
                d,
            )
        )
        return head + cands[len(head):]

    def _admission_control(self, now: float) -> None:
        p = self.policy
        demanders = [t for t in self.tenants.values() if t.queue_depth > 0]
        if not demanders or any(
            t.runtime.slo_pressure() < p.saturation_pressure for t in demanders
        ):
            return  # someone is still comfortably provisioned — not saturated
        low = min(t.class_weight for t in demanders)
        for t in sorted(demanders, key=Tenant.priority):
            if t.class_weight != low:
                continue  # only the lowest SLO class present is shed
            over = t.queue_depth - p.shed_queue_depth
            if over <= 0:
                continue
            shed = t.runtime.shed_queued(over, now)
            t.stats.rejected += len(shed)
            self.stats.rejections += len(shed)
            self._log(
                f"[fleet] {t.name}: saturation -> shed {len(shed)} queued "
                f"request(s) ({t.slo_class} class)"
            )

    def _needs_cold_start(self, t: Tenant) -> bool:
        rt = t.runtime
        n_prov = rt.pool.n_provisioned(P.PREFILL) + rt.pool.n_provisioned(P.DECODE)
        return n_prov == 0 and t.queue_depth > 0

    def _demand(self, t: Tenant) -> int:
        """Devices this tenant wants from arbitration this tick."""
        p = self.policy
        rt = t.runtime
        if self._needs_cold_start(t):
            return 2  # one prefill + one decode seat
        n_pre = rt.pool.n_provisioned(P.PREFILL)
        n_dec = rt.pool.n_provisioned(P.DECODE)
        if (n_pre + n_dec == 0) or rt.frozen:
            return 0  # parked (and nothing queued), or held static
        # per-phase: the runtime's own policy caps instances per phase, so
        # granting a device its binding phase can't use just ping-pongs it
        # through release_devices() every tick
        cap = rt.autoscaler.policy.max_instances
        pressures = rt.autoscaler.phase_pressures(n_pre, n_dec)
        want = 0
        for pressure, n, head in zip(pressures, (n_pre, n_dec), (cap - n_pre, cap - n_dec)):
            if head <= 0:
                continue
            if n == 0 and rt.n_outstanding > 0:
                # a half-seated tenant (e.g. a cold start that only got one
                # device) reads zero pressure on the empty phase — but work
                # cannot flow without at least one instance of each
                want += 1
            elif pressure <= p.grow_pressure:
                continue
            elif not math.isfinite(pressure):
                want += head
            else:
                want += min(head, math.ceil((pressure - 1.0) * max(n, 1)) or 1)
        return min(p.max_grant_per_tick, want)

    def _preempt_for(self, starving: Tenant, want: int, now: float) -> None:
        """Idle-model preemption: drain capacity from the lowest-priority
        tenants so ``starving`` finds free devices in a following tick."""
        victims = sorted(self.tenants.values(), key=Tenant.priority)
        for v in victims:
            if want <= 0:
                break
            if v is starving or v.runtime.n_engines == 0:
                continue
            if v.priority() >= self.policy.preempt_pressure:
                break  # sorted ascending: nobody cheaper remains
            if not v.busy and self.policy.scale_to_zero:
                n = v.runtime.drain_all()
                if n:
                    v.state = T.DRAINING
                    v.stats.preempted += 1
                    self.stats.preemptions += 1
                    want -= n
                    self._log(
                        f"[fleet] {v.name}: preempted (drain all {n}) for {starving.name}"
                    )
            else:
                dev = v.runtime.preempt_one(now)
                if dev is not None:
                    v.stats.preempted += 1
                    self.stats.preemptions += 1
                    want -= 1
                    self._log(
                        f"[fleet] {v.name}: preempted dev {dev} for {starving.name}"
                    )

    # -- reporting -----------------------------------------------------------
    def fleet_health(self, now: float | None = None) -> dict:
        """SLO summary (per-tenant quantiles, attainment, burn rates) from
        the attached :class:`~repro_torch.obs.slo.SLOMonitor`; empty dict when the
        fleet runs unmonitored.  No longer observe-only: per-tenant status
        feeds the arbitration tie-break (``slo_aware_arbitration``) and a
        fleet-level ``page`` triggers the flight recorder's incident dump."""
        if self.slo_monitor is None:
            return {}
        return self.slo_monitor.fleet_health(now if now is not None
                                             else self._last_tick)

    def slo_reports(self):
        return {name: t.runtime.router.slo_report() for name, t in self.tenants.items()}

    def attainment(self, ttft_slo: float, tbt_slo: float) -> float:
        """Fleet-wide fraction of requests within an *absolute* SLO — the
        cross-system comparison metric (the per-router 5x-average SLO is
        self-referential, so it cannot compare two systems at 'equal SLO')."""
        ok = n = 0
        for t in self.tenants.values():
            for r in t.runtime.router.records.values():
                if r.ttft is None:
                    continue
                n += 1
                if r.ttft <= ttft_slo and all(b <= tbt_slo for b in r.tbts()):
                    ok += 1
        return ok / n if n else 1.0

    def run_until_done(self, clock, *, max_ticks: int = 100_000) -> bool:
        """Drive ticks until every submitted request completed."""
        for _ in range(max_ticks):
            if self.n_outstanding == 0:
                return True
            self.tick(clock())
        return self.n_outstanding == 0
