"""PD-disaggregated cluster runtime: real engines + autoscaler + migration.

This is the real-engine counterpart of the §5.4 policy that previously
lived only in the discrete-event simulator: phase-tagged pools of
:class:`InstanceEngine` serve prefill and decode separately; finished
prefills freeze their KV pages and migrate them to a decode instance over
the topology-modelled network; the :class:`Autoscaler` drives

  * prefill scale-up by live-scaling spare devices (parameters stream at
    the multicast plan's modelled bandwidth while the engine ramps
    ``loaded_layers``);
  * **decode pre-scaling** — a prefill surge forecasts a decode surge one
    generation later, so decode capacity is raised in the same decision;
  * **decode scale-up by mutation** — an active prefill instance flips to
    decode in place (parameters already resident → zero parameter traffic,
    no incast with KVCache migration) while a replacement prefill
    live-scales on a spare device;
  * scale-down by draining: the instance finishes in-flight work, takes
    nothing new, and frees its device.

Every forward pass is a real model execution on the port's engines, all of
which share the runtime's one ``params`` dict (on the card, one copy of the
weights); time is supplied by the caller (wall clock in ``launch/serve.py``,
virtual clock in tests).  The port's copy of
``repro.serving.disagg.runtime``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

import numpy as np

from repro_torch.core import multicast as mc
from repro_torch.core import topology as topo_mod
from repro_torch.core.autoscaler import Autoscaler, LoadSample, PolicyConfig
from repro_torch.core.live_scaling import LiveSession
from repro_torch.core.parameter_pool import ParameterPool
from repro_torch.net import FAILURE_KINDS, FlowSim, MulticastExecution, NetEvent
from repro_torch.obs.metrics import StatBlock
from repro_torch.obs.trace import NULL_TRACER, NetEventBridge
from repro_torch.serving.disagg import pools as P
from repro_torch.serving.disagg.kv_migration import KVMigrationChannel, make_payload
from repro_torch.serving.engine import InstanceEngine, ServeRequest
from repro_torch.serving.router import Router


@dataclasses.dataclass
class RuntimeStats(StatBlock):
    migrations: int = 0
    migrated_bytes: int = 0
    mutations: int = 0
    mutation_param_bytes: int = 0  # stays 0 — that's the point of §5.4
    live_scaled_prefill: int = 0
    direct_decode_scales: int = 0  # fallback path (incast-prone)
    live_scale_param_bytes: int = 0
    prescaled_decodes: int = 0
    scale_downs: int = 0
    retired: int = 0
    cold_starts: int = 0
    cold_starts_from_host: int = 0  # re-multicast seeded by the O(1) host copy
    preemptions: int = 0  # engines drained by fleet arbitration, not own policy
    rejected: int = 0  # requests shed by fleet admission control
    aborted_param_streams: int = 0  # live-scales killed by a link/NIC failure
    remigrations: int = 0  # KV migrations re-targeted after a failure
    re_prefills: int = 0  # requests re-prefilled after their source died
    cancelled_scales: int = 0  # doomed live-scales torn down by a failure
    #   subscription (fleet's or the runtime's own — immediate, instead of
    #   the drain/retire path)
    failure_replans: int = 0  # engines re-provisioned by the runtime's OWN
    #   failure subscription, inside the failure event


class ClusterRuntime:
    def __init__(
        self,
        cfg,
        params,
        *,
        topo: topo_mod.Topology | None = None,
        policy: PolicyConfig | None = None,
        n_prefill: int = 1,
        n_decode: int = 1,
        n_slots: int = 4,
        max_seq: int = 64,
        prefill_capacity_tps: float = 1000.0,
        decode_capacity_tps: float = 100.0,
        model_bytes: int | None = None,
        page_tokens: int = 16,
        prefills_per_engine_per_tick: int = 1,
        param_pool: ParameterPool | None = None,
        allowed_devices: Iterable[int] | None = None,
        net: FlowSim | None = None,
        failure_subscription: bool = True,
        tracer=None,
        bridge=None,
        metrics=None,
        ledger=None,
        verbose: bool = False,
    ):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.prefills_per_tick = prefills_per_engine_per_tick
        self.verbose = verbose

        if topo is None:
            topo = topo_mod.add_host_sources(topo_mod.make_cluster(2, 4, bw_gbps=100.0))
        self.topo = topo
        # model_bytes drives the *network model* (live-scale + migration
        # sizing); callers may pass the full-architecture footprint while
        # computing on a reduced config.
        self.model_bytes = model_bytes or cfg.approx_params() * 2
        # a shared pool + an allowed-device set are how the MaaS fleet
        # scheduler multi-tenants several runtimes onto one topology; a
        # standalone runtime owns the whole cluster (allowed_devices=None)
        self.param_pool = param_pool if param_pool is not None else ParameterPool(topo)
        self.allowed_devices = (
            set(allowed_devices) if allowed_devices is not None else None
        )
        self.param_pool.register(cfg.name, self.model_bytes)

        # ONE flow-level network simulator carries every transfer this
        # runtime makes (KV migrations AND live-scaling parameter streams);
        # under MaaS the fleet passes its shared instance so co-tenant
        # traffic contends too
        self.net = net if net is not None else FlowSim(topo)
        # first-class failure subscription (mirrors the MaaS FleetScheduler):
        # a link/device/leaf failure retires doomed LOADING engines and
        # re-plans INSIDE the FlowSim event, not a tick later through the
        # per-flow abort -> drain path.  The fleet passes False for its
        # tenant runtimes — it subscribes once itself and drives the same
        # teardown via fail_devices()/restart_scale(), so a runtime-level
        # subscription would double-handle every failure.
        self._failure_subscribed = failure_subscription
        self._aborted_scales: set[int] = set()  # devs whose param stream
        #   aborted, awaiting the failure event that always follows
        if failure_subscription:
            self.net.subscribe(self._on_net_event)
        # observability: the null tracer keeps every site a no-op; a bound
        # metrics registry mirrors RuntimeStats under runtime.<model>.*
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # flow->span bridge: a standalone traced runtime subscribes its own;
        # under MaaS the fleet passes ONE shared bridge (the FlowSim is
        # shared, so per-runtime bridges would emit duplicate flow spans)
        self.bridge = bridge
        if self.bridge is None and self.tracer.enabled:
            self.bridge = NetEventBridge(self.tracer)
            self.net.subscribe(self.bridge)
        self.metrics = metrics
        # device-time ledger (repro.obs.ledger.DeviceTimeLedger): every tick
        # attributes the elapsed interval to exclusive engine states, owner-
        # keyed by model name so a multi-tenant fleet can split the bill
        self.ledger = ledger
        self._last_ledger_t: float | None = None
        self._scale_spans: dict[int, object] = {}  # loading dev -> open span
        self.pool = P.EnginePool(topo)
        self.channel = KVMigrationChannel(net=self.net, tracer=self.tracer)
        self.router = Router()
        self._live_execs: dict[int, MulticastExecution] = {}  # target dev -> exec
        self._orphan_migrations: list = []  # failed KV payloads awaiting re-target
        self.autoscaler = Autoscaler(
            policy or PolicyConfig(),
            prefill_capacity_tps=prefill_capacity_tps,
            decode_capacity_tps=decode_capacity_tps,
        )
        self.stats = RuntimeStats()
        if metrics is not None:
            self.stats.bind(metrics, f"runtime.{cfg.name}")
        # frozen: policy-driven scaling suspended.  Set while the fleet
        # drains this runtime to zero (a parked model must not re-grow from
        # decaying monitor samples) and by the static-allocation baseline;
        # cold_start() unfreezes.  Monitors keep recording so slo_pressure()
        # stays live for fleet arbitration.
        self.frozen = False
        self._sreqs: dict[int, ServeRequest] = {}
        self.completed: dict[int, ServeRequest] = {}
        self.rejected: dict[int, ServeRequest | None] = {}  # admission-shed
        self._arrived_tokens = 0  # offered prefill load since last monitor tick
        self._decoded_tokens = 0
        self._last_mon: float | None = None

        spare_ids = self._spare_ids()
        if n_prefill + n_decode > len(spare_ids):
            raise ValueError(
                f"requested {n_prefill} prefill + {n_decode} decode instances "
                f"but only {len(spare_ids)} spare devices are available"
            )
        spares = iter(spare_ids)
        for phase, n in ((P.PREFILL, n_prefill), (P.DECODE, n_decode)):
            for _ in range(n):
                dev = next(spares)
                self.pool.add(P.PooledEngine(self._new_engine(), dev, phase))
                self.param_pool.deploy(cfg.name, [dev])

    def _new_engine(self) -> InstanceEngine:
        return InstanceEngine(
            self.cfg, self.params, n_slots=self.n_slots, max_seq=self.max_seq
        )

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    # -- multi-tenancy hooks (MaaS fleet arbitration) ------------------------
    def _spare_ids(self) -> list[int]:
        """Free accelerators this runtime may provision — the whole cluster's
        spares for a standalone runtime, only the fleet scheduler's grants
        when multi-tenanted.  Devices with a failed NIC are unusable."""
        ids = [d.id for d in self.topo.spares() if self.net.device_ok(d.id)]
        if self.allowed_devices is not None:
            ids = [i for i in ids if i in self.allowed_devices]
        return ids

    @property
    def n_engines(self) -> int:
        return len(self.pool.all())

    @property
    def n_serving(self) -> int:
        return len(self.pool.serving(P.PREFILL)) + len(self.pool.serving(P.DECODE))

    def slo_pressure(self) -> float:
        """The fleet-arbitration signal: >1 means under-provisioned now."""
        return self.autoscaler.slo_pressure(
            self.pool.n_provisioned(P.PREFILL), self.pool.n_provisioned(P.DECODE)
        )

    def acquire_devices(self, ids: Iterable[int]) -> None:
        """Fleet grant: these devices may be provisioned by this runtime."""
        if self.allowed_devices is None:
            self.allowed_devices = set()
        self.allowed_devices.update(ids)

    def release_devices(self) -> list[int]:
        """Return granted-but-unoccupied devices to the fleet (called every
        scheduler tick — grants not consumed by a scale-up flow back)."""
        if self.allowed_devices is None:
            return []
        freed = [
            i
            for i in sorted(self.allowed_devices)
            if self.topo.device(i).role is topo_mod.Role.FREE
        ]
        self.allowed_devices.difference_update(freed)
        return freed

    def revoke_devices(self, ids: Iterable[int]) -> list[int]:
        """Strip granted devices (dead NICs the fleet's failure subscription
        found) from the allowed set — a doomed grant must not be consumed.
        Returns the devices actually revoked."""
        if self.allowed_devices is None:
            return []
        revoked = [i for i in ids if i in self.allowed_devices]
        self.allowed_devices.difference_update(revoked)
        return revoked

    def _on_net_event(self, event: NetEvent) -> None:
        if event.kind in FAILURE_KINDS:
            self._handle_net_failure(event.t)

    def _handle_net_failure(self, now: float) -> None:
        """React to a link/device/leaf failure the moment the FlowSim emits
        it (standalone-runtime counterpart of the FleetScheduler's
        subscription): retire doomed LOADING engines — those on dead
        devices AND those whose parameter stream aborted without the device
        dying (a severed spine path) — and re-plan each lost phase from
        surviving sources, all inside the same event.  The per-flow abort
        callback only *records* its device (aborts settle before the
        failure event fires), so nothing is drained twice."""
        doomed = self.net.dead_devices() | self._aborted_scales
        self._aborted_scales.clear()
        if not doomed:
            return
        lost = self.fail_devices(doomed, now)
        if self.frozen:
            return  # a parked/drained model must not re-provision itself
        for phase in lost:
            if self.restart_scale(phase, now) is not None:
                self.stats.failure_replans += 1
                self._log(f"[scale] failure re-plan -> {phase} live-scale")

    def fail_devices(self, dead: set[int], now: float) -> list[str]:
        """Failure-subscription teardown (fleet's or the runtime's own):
        tear down live-scales doomed by ``dead`` devices RIGHT NOW — the
        engine is removed from the pool and its device reclaimed
        immediately, instead of waiting for the drain→retire path a tick
        later — and report the phases that lost an engine so the caller can
        re-provision elsewhere.  Idempotent: an engine already torn down is
        gone from the pool, so a second failure event for the same devices
        finds nothing."""
        lost: list[str] = []
        for pe in list(self.pool.all()):
            if pe.device_id not in dead or pe.session is None:
                continue  # only in-flight live-scales are "doomed grants"
            exec_ = self._live_execs.pop(pe.device_id, None)
            if exec_ is not None:
                exec_.cancel(self.net)
            self.pool.engines[pe.phase].remove(pe)
            dev = self.topo.device(pe.device_id)
            dev.role = topo_mod.Role.FREE
            dev.model = None
            self.param_pool.reclaim(self.cfg.name, [pe.device_id])
            self.stats.cancelled_scales += 1
            self._close_scale_span(pe.device_id, now, aborted=True)
            lost.append(pe.phase)
            self._log(
                f"[fleet] cancelled doomed {pe.phase} live-scale on dead "
                f"dev {pe.device_id}"
            )
        return lost

    def restart_scale(
        self, phase: str, now: float, *, target: int | None = None
    ) -> P.PooledEngine | None:
        """Re-provision one engine after a failure — the fleet's re-grant
        path (``target`` pins the affinity-ranked device it just granted)."""
        return self._live_scale(phase, now, target=target)

    def drain_all(self) -> int:
        """Scale-to-zero entry: every engine finishes its in-flight work,
        takes nothing new, and frees its device on retirement.  The shared
        ParameterPool keeps only the single O(1) host copy once the last
        GPU copy is reclaimed."""
        self.frozen = True
        n = 0
        for pe in self.pool.all():
            if pe.state != P.DRAINING:
                self.pool.drain(pe)
                n += 1
        return n

    def cold_start(self, now: float) -> int:
        """Re-provision from zero capacity: live-scale a prefill and a decode
        engine, re-multicasting parameters from a surviving GPU copy if one
        exists, else from the O(1) host-cached copy.  Returns the number of
        engines started."""
        self.frozen = False
        gpu_srcs, _ = self.param_pool.sources(self.cfg.name)
        from_host = not any(self.net.device_ok(s) for s in gpu_srcs)
        n = 0
        for phase in (P.PREFILL, P.DECODE):
            if self._live_scale(phase, now) is not None:
                n += 1
        if n:
            self.stats.cold_starts += 1
            if from_host:
                self.stats.cold_starts_from_host += 1
        return n

    def preempt_one(self, now: float) -> int | None:
        """Fleet-driven preemption: drain the least-loaded engine of the
        better-provisioned phase so a starved co-tenant can take the device
        once it retires.  Returns the device id, or None if nothing can be
        spared without killing a lone phase."""
        cands = {
            ph: [pe for pe in self.pool.phase(ph) if pe.state == P.ACTIVE]
            for ph in (P.PREFILL, P.DECODE)
        }
        phase = max(cands, key=lambda ph: len(cands[ph]))
        if len(cands[phase]) <= 1:
            return None
        victim = min(cands[phase], key=P.PooledEngine.load)
        self.pool.drain(victim)
        self.stats.preemptions += 1
        self._log(f"[fleet] preempted {phase} dev {victim.device_id}")
        return victim.device_id

    def shed_queued(self, n: int, now: float) -> list[int]:
        """Fleet admission control: reject the ``n`` NEWEST queued requests
        (the oldest keep their place — they have aged the most against the
        TTFT SLO).  Rejected requests get an explicit rejection status on
        the router and stop counting as outstanding.  Returns shed rids."""
        shed: list[int] = []
        while n > 0 and self.router.queue:
            rec = self.router.queue.pop()
            self.router.reject(rec.rid, now)
            self.rejected[rec.rid] = self._sreqs.pop(rec.rid, None)
            self.stats.rejected += 1
            shed.append(rec.rid)
            n -= 1
        if shed:
            self._log(f"[fleet] admission control shed {len(shed)} request(s)")
        return shed

    # -- request intake -----------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int, now: float) -> int:
        rid = self.router.submit(len(prompt), max_new_tokens, now)
        self._sreqs[rid] = ServeRequest(rid, np.asarray(prompt, np.int32), max_new_tokens)
        self._arrived_tokens += len(prompt)
        return rid

    @property
    def n_outstanding(self) -> int:
        return len(self._sreqs) - len(self.completed)

    # -- scaling actions ----------------------------------------------------
    def _close_scale_span(self, dev: int, t: float, *,
                          aborted: bool = False) -> None:
        sp = self._scale_spans.pop(dev, None)
        if sp is None:
            return
        if aborted:
            self.tracer.end(sp, t, aborted=True)
        else:
            self.tracer.instant("serving", t, cat="scale", parent=sp)
            self.tracer.end(sp, t)

    def _live_scale(
        self, phase: str, now: float, *, target: int | None = None
    ) -> P.PooledEngine | None:
        """Provision a spare device with a live-scaling engine: the multicast
        plan's hops become real flows on the shared FlowSim, and the engine
        ramps ``loaded_layers`` from the *realized* bytes delivered — so KV
        migrations, co-tenant traffic and degraded links all slow the ramp.
        ``target`` pins a specific spare (the fleet's affinity-ranked
        failure re-grant); otherwise the first spare is taken."""
        spares = self._spare_ids()
        if not spares:
            return None
        target = target if target in spares else spares[0]
        gpu_srcs, host = self.param_pool.sources(self.cfg.name)
        # a copy behind a failed NIC cannot source a multicast: never plan
        # from it (the plan's flows would abort on arrival)
        gpu_srcs = [s for s in gpu_srcs if self.net.device_ok(s)]
        host_devs = [
            d.id for d in self.topo.devices
            if d.is_host and d.host == host and self.net.device_ok(d.id)
        ]
        srcs = gpu_srcs or host_devs
        if not srcs:
            return None
        # the planner sees the same network the data plane simulates: hop
        # latencies (heterogeneous profiles included) rank chains alongside
        # bandwidth, so its transfer_seconds predicts realized arrival
        plan = mc.plan_multicast(
            self.topo, srcs, [target], 1,
            net=self.net, model_bytes=self.model_bytes,
        )
        if target not in plan.covered:
            # degenerate plan (source-only chains / nothing reachable):
            # provisioning an engine on it would ramp from an instant
            # analytic estimate with no bytes ever arriving
            return None
        t_est = max(plan.transfer_seconds(self.model_bytes), 1e-6)
        span = None
        if self.tracer.enabled:
            span = self.tracer.begin(
                "scale_op", now, cat="scale", track="scale",
                phase=phase, device=target, model=self.cfg.name)
            self.tracer.instant("plan", now, cat="scale", parent=span,
                                chains=len(plan.chains))
            self._scale_spans[target] = span
        exec_ = MulticastExecution(
            plan,
            self.model_bytes,
            on_abort=lambda e, t, dev=target: self._param_stream_aborted(dev, t),
            tracer=self.tracer if span is not None else None,
            parent_span=span,
        )
        if self.bridge is not None and span is not None:
            # pin BEFORE start: the chain's hop flows land under this op's
            # scale_op span, which is what the critical-path analyzer
            # partitions the makespan against
            self.bridge.pin_all(exec_.flows, span)
        exec_.start(self.net, now)
        if exec_.aborted:
            # every hop aborted synchronously at start (no live route to the
            # target — e.g. a fully severed uplink that killed no NIC, which
            # device_ok cannot see).  The abort callback fired BEFORE the
            # engine exists, so neither the drain path nor the failure
            # subscription could ever clean it up: don't provision at all.
            self._aborted_scales.discard(target)
            self._close_scale_span(target, now, aborted=True)
            return None
        has_inflow = bool(exec_.flows_into(target))
        session = LiveSession(
            n_layers=self.cfg.n_layers,
            layer_bytes=self.model_bytes // max(self.cfg.n_layers, 1),
            link_bytes_per_s=self.model_bytes / t_est,
            started_at=now,
            progress_bytes=(
                (lambda: exec_.bytes_into(target)) if has_inflow else None
            ),
        )
        eng = self._new_engine()
        eng.set_loaded_layers(0)
        pe = P.PooledEngine(eng, target, phase, state=P.LOADING, session=session)
        self.pool.add(pe)
        # reserve the device; the parameter flows themselves occupy its
        # ingress on the FlowSim (incast with KV migration emerges there)
        self.topo.device(target).role = (
            topo_mod.Role.DECODE if phase == P.DECODE else topo_mod.Role.PREFILL
        )
        self._live_execs[target] = exec_
        self.stats.live_scale_param_bytes += self.model_bytes
        if phase == P.PREFILL:
            self.stats.live_scaled_prefill += 1
        else:
            self.stats.direct_decode_scales += 1
        self._log(
            f"[scale] live-scaling {phase} on dev {target} "
            f"({self.model_bytes/1e6:.0f} MB, ~{t_est*1e3:.0f} ms on dedicated links)"
        )
        return pe

    def _param_stream_aborted(self, dev: int, t: float) -> None:
        """A link/NIC failure killed the parameter stream mid-live-scale.
        When this runtime subscribes to FlowSim failure events, the abort
        only *records* the device — aborts settle before the failure event
        fires, and the subscription handler then retires the doomed engine
        and re-plans inside that event (aborts with no failure event
        attached are swept at the next tick).  Unsubscribed (fleet-managed)
        runtimes keep the legacy behaviour: drain the half-loaded engine so
        it retires next tick and the policy re-plans."""
        self._live_execs.pop(dev, None)
        self.stats.aborted_param_streams += 1
        if self._failure_subscribed:
            self._aborted_scales.add(dev)
            return
        for pe in self.pool.all():
            if pe.device_id == dev and pe.state == P.LOADING:
                self.pool.drain(pe)
                self._log(f"[scale] param stream to dev {dev} aborted -> drain + re-plan")

    def _scale_up_decode(self, now: float) -> bool:
        """§5.4: prefer mutating a prefill instance (zero parameter traffic,
        no incast with KV migration) and live-scale a replacement prefill;
        fall back to a direct decode live-scale only when no prefill can be
        spared.  Returns False when neither path had resources."""
        prefills = self.pool.serving(P.PREFILL)
        can_mutate = prefills and (
            self.pool.n_provisioned(P.PREFILL) >= 2 or self._spare_ids()
        )
        if can_mutate:
            victim = min(prefills, key=P.PooledEngine.load)
            self.pool.mutate_to_decode(victim)
            self.stats.mutations += 1
            self._log(f"[scale] mutated prefill dev {victim.device_id} -> decode (0 param bytes)")
            self._live_scale(P.PREFILL, now)  # replacement; may be None if no spare
            return True
        return self._live_scale(P.DECODE, now) is not None

    def _scale_down(self, phase: str, now: float) -> None:
        cands = self.pool.serving(phase)
        if len(cands) <= 1:
            return
        victim = min(cands, key=P.PooledEngine.load)
        self.pool.drain(victim)
        self.stats.scale_downs += 1
        self._log(f"[scale] draining {phase} dev {victim.device_id}")

    def _accrue_ledger(self, now: float) -> None:
        """Attribute the device-time elapsed since the previous tick to
        exclusive ledger states.  Runs at the top of ``tick()``, BEFORE this
        tick's transitions, so each engine is billed for the state it held
        over the interval: DRAINING -> draining; LOADING with work queued
        against it -> stalled_waiting_layers (the stall live loading exists
        to hide), else loading_params; ACTIVE -> serving_<phase>, or
        allocated_idle when nothing is queued, active, or in flight."""
        last = self._last_ledger_t
        self._last_ledger_t = now
        if last is None:
            return
        dt = now - last
        if dt <= 0:
            return
        led = self.ledger
        owner = self.cfg.name
        waiting = bool(self.router.queue)
        for pe in self.pool.all():
            if pe.state == P.DRAINING:
                state = "draining"
            elif pe.state == P.LOADING:
                state = (
                    "stalled_waiting_layers"
                    if waiting or pe.pending or pe.inflight
                    else "loading_params"
                )
            elif pe.idle():
                state = "allocated_idle"
            else:
                state = (
                    "serving_prefill" if pe.phase == P.PREFILL
                    else "serving_decode"
                )
            led.accrue(state, dt, owner=owner)

    # -- main loop ----------------------------------------------------------
    def tick(self, now: float) -> list[int]:
        """One runtime iteration; returns rids completed this tick."""
        if self.ledger is not None:
            self._accrue_ledger(now)
        # 0. advance the shared network to now (flow completions fire here),
        #    then retire drained instances; free their devices (idle() holds
        #    retirement while KV migrations are still in flight toward one)
        self.net.advance_to(now)
        if self._aborted_scales:
            # param-stream aborts that no failure event followed (a flow
            # started across an already-severed path): same teardown +
            # re-plan as the subscription path, one tick later
            self._handle_net_failure(now)
        for pe in self.pool.retire_idle():
            exec_ = self._live_execs.pop(pe.device_id, None)
            if exec_ is not None:
                # drained mid-live-scale: withdraw the parameter flows so
                # they stop occupying the retired device's ingress
                exec_.cancel(self.net)
            self.param_pool.reclaim(self.cfg.name, [pe.device_id])
            self.stats.retired += 1
            self._close_scale_span(pe.device_id, now, aborted=True)
            self._log(f"[scale] retired {pe.phase} dev {pe.device_id}")

        # 1. advance live-scaling sessions from realized flow progress
        for pe in self.pool.all():
            if pe.state == P.LOADING and pe.session is not None:
                pe.engine.set_loaded_layers(pe.session.layers_loaded(now))
                if pe.engine.can_serve_alone():
                    self.pool.activate(pe)
                    self._live_execs.pop(pe.device_id, None)
                    self._close_scale_span(pe.device_id, now)
                    self.param_pool.deploy(self.cfg.name, [pe.device_id])
                    self._log(f"[scale] dev {pe.device_id} fully loaded -> active {pe.phase}")

        # 2. dispatch prefills (bounded per engine per tick) + start migrations
        budget = {
            id(pe): self.prefills_per_tick for pe in self.pool.serving(P.PREFILL)
        }
        while self.router.queue:
            targets = [
                pe for pe in self.pool.migration_targets()
                if self.net.device_ok(pe.device_id)
            ]
            dst = min(targets, key=P.PooledEngine.load) if targets else None
            src_cands = [
                pe for pe in self.pool.serving(P.PREFILL)
                if budget.get(id(pe), 0) > 0 and self.net.device_ok(pe.device_id)
            ]
            if dst is None or not src_cands:
                break
            src = min(src_cands, key=P.PooledEngine.load)
            budget[id(src)] -= 1
            rec = self.router.queue.popleft()
            sreq = self._sreqs[rec.rid]
            first, one = src.engine.prefill_only(sreq)
            self.router.note_first_token(rec.rid, now)
            payload = make_payload(
                sreq,
                first,
                one,
                max_seq=self.max_seq,
                src_dev=src.device_id,
                dst_dev=dst.device_id,
                page_tokens=self.page_tokens,
            )
            self.router.begin_handoff(
                rec.rid, src.device_id, dst.device_id, len(sreq.out_tokens), now
            )
            self.channel.start(payload, now)
            self.router.mark_migrating(rec.rid)
            dst.inflight += 1
            self.stats.migrations += 1
            self.stats.migrated_bytes += payload.total_bytes

        # 3. migration completions land on their decode instance
        by_dev = {pe.device_id: pe for pe in self.pool.all()}
        for payload in self.channel.poll(now):
            pe = by_dev[payload.dst_dev]
            pe.inflight -= 1
            pe.pending.append(payload)

        # 3.5 failed migrations (link/NIC died mid-flight): the pages are
        # still frozen on the prefill side — re-target onto a surviving
        # decode instance, retrying next tick when none is reachable yet
        for payload in self.channel.take_failed():
            old = by_dev.get(payload.dst_dev)
            if old is not None:
                old.inflight -= 1
            self._orphan_migrations.append(payload)
        if self._orphan_migrations:
            targets = [
                pe for pe in self.pool.migration_targets()
                if self.net.device_ok(pe.device_id)
            ]
            retry, self._orphan_migrations = self._orphan_migrations, []
            for payload in retry:
                if not self.net.device_ok(payload.src_dev):
                    # the SOURCE NIC died: the frozen pages cannot leave that
                    # device — un-pin the request and re-run prefill on a
                    # healthy engine (the re-target path would abort forever)
                    self.router.handoffs.pop(payload.rid, None)
                    payload.request.out_tokens = []
                    self.router.queue.appendleft(self.router.records[payload.rid])
                    self.stats.re_prefills += 1
                    self._log(
                        f"[scale] KV source dev {payload.src_dev} dead -> "
                        f"re-prefilling rid={payload.rid} elsewhere"
                    )
                    continue
                if not targets:
                    self._orphan_migrations.append(payload)
                    continue
                dst = min(targets, key=P.PooledEngine.load)
                payload.dst_dev = dst.device_id
                self.router.begin_handoff(
                    payload.rid, payload.src_dev, dst.device_id,
                    len(payload.tokens_at_freeze), now,
                )
                self.channel.start(payload, now)
                self.router.mark_migrating(payload.rid)
                dst.inflight += 1
                self.stats.remigrations += 1
                self._log(
                    f"[scale] re-targeted failed KV migration rid={payload.rid} "
                    f"-> dev {dst.device_id}"
                )

        # 4. decode: admit migrated requests, then one batched step per engine
        finished_rids: list[int] = []
        for pe in self.pool.phase(P.DECODE):
            eng = pe.engine
            if not eng.can_serve_alone():
                continue
            while pe.pending and eng.free_slots:
                p = pe.pending.popleft()
                eng.admit_prefilled(p.request, p.first_token, p.cache_one)
                # compare against the independent freeze-time snapshot: the
                # request must resume with exactly the tokens it froze with
                # (nothing decoded, lost, or replayed while in transit)
                resumed = (
                    len(p.request.out_tokens)
                    if p.request.out_tokens == p.tokens_at_freeze
                    else -1
                )
                self.router.complete_handoff(p.rid, resumed, now)
            if not eng.active:
                continue
            rids = [r.rid for r in eng.active.values()]
            done = eng.step()
            self._decoded_tokens += len(rids)
            for rid in rids:
                self.router.note_token(rid, now)
            for r in done:
                self.router.note_done(r.rid)
                self.completed[r.rid] = r
                finished_rids.append(r.rid)

        # 5. liveness guard: queued work must never sit against an empty
        #    phase pool — mutation can flip the last prefill instance to
        #    decode after the load monitors already decayed, and decide()
        #    treats zero instances as capacity one, so nothing would ever
        #    re-provision the phase
        if not self.frozen and self.router.queue:
            for phase in (P.PREFILL, P.DECODE):
                if self.pool.n_provisioned(phase) == 0:
                    self._live_scale(phase, now)

        # 6. feed the load monitors + run the scaling policy
        if self._last_mon is None:
            self._last_mon = now
        dt = now - self._last_mon
        if dt > 0:
            decode_kv = max(
                (pe.engine.kv_used_frac() for pe in self.pool.serving(P.DECODE)),
                default=0.0,
            )
            self.autoscaler.prefill_mon.record(
                LoadSample(now, self._arrived_tokens / dt, 0.0, len(self.router.queue))
            )
            self.autoscaler.decode_mon.record(
                LoadSample(now, self._decoded_tokens / dt, decode_kv, 0)
            )
            self._arrived_tokens = 0
            self._decoded_tokens = 0
            self._last_mon = now
            if self.frozen:
                return finished_rids
            decision = self.autoscaler.decide(
                now,
                self.pool.n_provisioned(P.PREFILL),
                self.pool.n_provisioned(P.DECODE),
            )
            for _ in range(max(0, decision.prefill_delta)):
                if self._live_scale(P.PREFILL, now) is None:
                    break
            performed = 0
            for _ in range(max(0, decision.decode_delta)):
                if not self._scale_up_decode(now):
                    break
                performed += 1
            if decision.prescaled and performed:
                # these decode instances were raised by the §5.4 forecast
                # (prefill surge), not by observed decode pressure
                self.stats.prescaled_decodes += performed
            if decision.prefill_delta < 0:
                self._scale_down(P.PREFILL, now)
            if decision.decode_delta < 0:
                self._scale_down(P.DECODE, now)

        return finished_rids

    # -- convenience --------------------------------------------------------
    def run_until_done(self, clock, *, max_ticks: int = 100_000) -> bool:
        """Drive ticks until every submitted request completed.  ``clock``
        is a zero-arg callable returning the current time.  Returns False
        when the tick budget ran out with requests still outstanding."""
        for _ in range(max_ticks):
            if self.n_outstanding == 0:
                return True
            self.tick(clock())
        return self.n_outstanding == 0
