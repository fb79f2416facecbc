"""Discrete-event MAAS cluster simulator (the paper's Fig. 3 methodology).

Reproduces the paper's evaluation: real-world-shaped traces are served by a
cluster of instances whose autoscaling *data plane* is modelled per system:

  ==============  =========================================================
  system          data plane on scale-up
  ==============  =========================================================
  blitz           Algorithm-11 multicast over the compute network (+ live
                  ZigZag cooperative execution: the overloaded source
                  instance's throughput ramps with the target's loaded
                  layers, reaching 2x at L/2)
  blitz-nolive    same network multicast, stop-the-world
  blitz-naive     compute network, but unicast from one copy through a
                  single egress, interference-ignorant ("+Network")
  sllm            ServerlessLLM: host-cache hit -> PCIe; miss -> SSD; TTL
                  keepalive makes its host cache O(#hosts touched) (Fig.19)
  allcache        ServerlessLLM-optimal: always PCIe from host cache
  fixed           DistServe/vLLM-style: no autoscaling (full / half
                  provisioning)
  ==============  =========================================================

The *network* data planes (multicast, naive unicast) ride the shared
flow-level simulator ``repro_torch.net.FlowSim``: scale transfers are real flows
that contend — under max-min fair sharing — with serving traffic and with
each other, over the modelled leaf-spine graph (``spine_oversub`` exposes
oversubscribed spines; ``link_latency_s`` / ``switch_latency_s`` enable
the per-hop latency model).  Serving traffic itself is request-granular:
every finished prefill ships its ACTUAL KV volume (``prompt_tokens x
kv_bytes_per_token``) as one prefill→decode flow, and the request only
starts decoding when that flow lands — so scale-up multicast, KV
migration and real serving traffic contend at request granularity.
``per_request_kv=False`` restores the PR-3 behaviour (one persistent
background stream per active prefill instance), the configuration the
golden-trace regression test pins bit-for-bit.  Host-local planes (SSD,
PCIe host cache) remain analytic.

Timing model (per instance): prefill is compute-bound
(``tokens / prefill_tps``), decode is memory-bound (weight pass + per-seq
KV read per round); decode pre-scaling (§5.4) applies to every autoscaling
system, as in the paper.  All timing constants derive from the paper's
A800 cluster (Table 1) so Fig. 3/17 magnitudes are comparable.

The port's copy of ``repro.core.simulator``: host arithmetic only (stdlib
and numpy), no tensor and no device.  ``A800_TFLOPS`` and ``A800_HBM`` are
the modelled cluster's, kept as the paper gives them: every second this
simulator reports is a modelled second on that A800 cluster, never a time
measured on the card the port's kernels run on.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import defaultdict, deque
from typing import Callable, Iterable

import numpy as np

from repro_torch.core import multicast as mc
from repro_torch.core import topology as topo_mod
from repro_torch.core.autoscaler import Autoscaler, LoadSample, PolicyConfig
from repro_torch.core.live_scaling import LiveSession
from repro_torch.core.parameter_pool import ParameterPool
from repro_torch.core.topology import Role, Topology, gbps_to_bytes_per_s
from repro_torch.net import Flow, FlowKind, FlowSim, MulticastExecution
from repro_torch.obs.ledger import DEVICE_STATES, DeviceTimeLedger
from repro_torch.obs.trace import NULL_TRACER, NetEventBridge
from repro_torch.workloads.traces import request_kv_bytes

# ---------------------------------------------------------------------------
# Model serving profile
# ---------------------------------------------------------------------------

A800_TFLOPS = 312e12 * 0.45  # effective prefill FLOP/s per GPU (MFU ~0.45)
A800_HBM = 1.6e12  # effective HBM bytes/s per GPU


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    param_bytes: int
    n_layers: int
    devices_per_instance: int
    kv_bytes_per_token: int
    ttft_slo_s: float
    tbt_slo_s: float

    @property
    def prefill_tps(self) -> float:
        """Compute-bound: 2*N FLOPs/token over the instance's GPUs."""
        flops_per_tok = 2.0 * (self.param_bytes / 2)  # bf16 -> N params
        return A800_TFLOPS * self.devices_per_instance / flops_per_tok

    @property
    def weight_pass_s(self) -> float:
        """One decode round reads all weights once (per GPU shard)."""
        return (self.param_bytes / self.devices_per_instance) / A800_HBM

    def kv_read_s(self, ctx_tokens: float) -> float:
        return ctx_tokens * self.kv_bytes_per_token / (A800_HBM * self.devices_per_instance)

    @property
    def kv_capacity_tokens(self) -> int:
        """KV room per instance: 80 GB/GPU minus weights."""
        free = 80e9 * self.devices_per_instance - self.param_bytes * 1.2
        return max(int(free / self.kv_bytes_per_token), 1)


def profile_for(size: str) -> ModelProfile:
    """The paper's three evaluation models (§6: SLOs follow DistServe)."""
    if size == "8b":
        return ModelProfile("llama3-8b", 16_000_000_000, 32, 1,
                            2 * 32 * 8 * 128 * 2, 0.45, 0.15)
    if size == "24b":
        return ModelProfile("mistral-24b", 48_000_000_000, 40, 2,
                            2 * 40 * 8 * 128 * 2, 0.80, 0.175)
    if size == "72b":
        return ModelProfile("qwen2.5-72b", 144_000_000_000, 80, 4,
                            2 * 80 * 8 * 128 * 2, 1.25, 0.20)
    raise ValueError(size)


# ---------------------------------------------------------------------------
# Requests and instances
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt: int
    output: int
    prefill_done: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    decoded: int = 0
    kv_src: int | None = None  # device whose prefill froze this request's KV

    @property
    def ttft(self) -> float | None:
        return None if self.prefill_done is None else self.prefill_done - self.arrival

    def tbts(self) -> list[float]:
        ts = [self.prefill_done] + self.token_times if self.prefill_done else self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


@dataclasses.dataclass
class Instance:
    iid: int
    phase: str  # 'prefill' | 'decode'
    device_ids: tuple[int, ...]
    active_from: float  # when it can serve at full capacity (inf = loading,
    #                     resolved when the scale flows actually complete)
    # live scaling: a session attached to the *source* (overloaded) instance;
    # its throughput multiplier ramps 1 -> 2 as the paired target loads layers
    live_boost: LiveSession | None = None
    queue: deque = dataclasses.field(default_factory=deque)
    busy_until: float = 0.0
    active_reqs: dict = dataclasses.field(default_factory=dict)  # rid -> Request
    kv_tokens: int = 0
    retired: bool = False
    pending_devs: set = dataclasses.field(default_factory=set)  # devices whose
    #   scale flows have not landed yet (network data planes)
    scale_start: float = 0.0

    def boost(self, now: float) -> float:
        if self.live_boost is None:
            return 1.0
        if now >= self.live_boost.done_at():
            self.live_boost = None
            return 1.0
        return self.live_boost.throughput_multiplier(now)


# ---------------------------------------------------------------------------
# System policy descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str
    data_plane: str  # 'ssd'|'hostcache'|'network_naive'|'network_multicast'|'fixed'|'delay'
    live: bool = False
    autoscale: bool = True
    keepalive_s: float = 300.0  # S-LLM 5-minute TTL
    fixed_prefill: int = 0
    fixed_decode: int = 0
    fixed_delay_s: float = 0.0  # for the Fig. 3 scaling-stop sweep
    allow_interference: bool = False
    control_plane_s: float = 0.05  # CUDA-context-pool / pre-lowered exec (§A.1)
    prewarm: bool = False  # AllCache: parameters start cached on every host


BLITZ = SystemConfig("blitz", "network_multicast", live=True)
BLITZ_NOLIVE = SystemConfig("blitz-nolive", "network_multicast", live=False)
BLITZ_NAIVE = SystemConfig("blitz-naive", "network_naive", live=False,
                           allow_interference=True)
SLLM = SystemConfig("sllm", "hostcache", live=False)
ALLCACHE = SystemConfig("allcache", "hostcache", live=False, keepalive_s=1e18,
                        prewarm=True)
SSD_ONLY = SystemConfig("ssd", "ssd", live=False)


def fixed_system(name: str, n_prefill: int, n_decode: int) -> SystemConfig:
    return SystemConfig(name, "fixed", autoscale=False,
                        fixed_prefill=n_prefill, fixed_decode=n_decode)


def delay_system(delay_s: float) -> SystemConfig:
    """Fig. 3 methodology: a manual scaling stop duration."""
    return SystemConfig(f"delay-{delay_s:g}s", "delay", fixed_delay_s=delay_s)


# ---------------------------------------------------------------------------
# Result metrics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    system: str
    requests: list[Request]
    gpu_time_s: float  # integral of (allocated devices) dt — the ledger total
    host_cache_peak_bytes: dict[int, int]  # per host
    scale_events: int
    scale_seconds: list[float]  # data-plane durations
    net_scale_bytes: float  # bytes moved over compute network for scaling
    timeline: list[tuple[float, int, int]]  # (t, n_prefill, n_decode)
    kv_stream_bytes: float = 0.0  # per-request KV serving bytes over the net
    kv_re_prefills: int = 0  # requests re-prefilled after their KV source died
    # exclusive-state attribution of gpu_time_s (repro_torch.obs.ledger.DEVICE_STATES
    # order); conservation is exact: sum(device_seconds.values()) == gpu_time_s
    device_seconds: dict[str, float] = dataclasses.field(default_factory=dict)

    def ttfts(self) -> np.ndarray:
        return np.array([r.ttft for r in self.requests if r.ttft is not None])

    def tbts(self) -> np.ndarray:
        out = []
        for r in self.requests:
            out.extend(r.tbts())
        return np.array(out) if out else np.array([0.0])

    def slo_attainment(self, prof: ModelProfile) -> float:
        ok = 0
        n = 0
        for r in self.requests:
            if r.ttft is None:
                n += 1
                continue
            n += 1
            good = r.ttft <= prof.ttft_slo_s
            if good and r.tbts():
                good = float(np.percentile(r.tbts(), 99)) <= prof.tbt_slo_s
            ok += bool(good)
        return ok / max(n, 1)

    def p99_ttft(self) -> float:
        t = self.ttfts()
        return float(np.percentile(t, 99)) if len(t) else float("inf")

    def mean_ttft(self) -> float:
        t = self.ttfts()
        return float(np.mean(t)) if len(t) else float("inf")

    def p99_tbt(self) -> float:
        return float(np.percentile(self.tbts(), 99))

    def mean_tbt(self) -> float:
        return float(np.mean(self.tbts()))

    def host_cache_total(self) -> float:
        return float(sum(self.host_cache_peak_bytes.values()))


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------


class Simulator:
    def __init__(
        self,
        system: SystemConfig,
        prof: ModelProfile,
        *,
        n_hosts: int = 4,
        devs_per_host: int = 8,
        net_gbps: float = 100.0,
        nvlink: bool = True,
        pcie_gbps: float = 256.0,
        ssd_gbps: float = 10.0,
        monitor_dt: float = 0.1,
        spine_oversub: float = 1.0,
        link_latency_s: float = 0.0,
        switch_latency_s: float = 0.0,
        link_profiles=None,
        per_request_kv: bool = True,
        seed: int = 0,
        tracer=None,
        metrics=None,
        slo_monitor=None,
        link_ledger=None,
        flight_recorder=None,
    ):
        self.sys = system
        self.prof = prof
        self.net_gbps = net_gbps
        self.pcie_gbps = pcie_gbps
        self.ssd_gbps = ssd_gbps
        self.monitor_dt = monitor_dt
        # request-granular serving traffic (per-prefill KV flows) only makes
        # sense on the network data planes; False restores the PR-3 model of
        # one persistent background stream per active prefill instance
        self._kv_net = per_request_kv and system.data_plane in (
            "network_multicast", "network_naive"
        )
        # host pseudo-devices join the topology so cold-start unicasts from
        # the O(1) host copy are real flows on the shared network simulator
        self.topo = topo_mod.add_host_sources(
            topo_mod.make_cluster(
                n_hosts, devs_per_host, bw_gbps=net_gbps,
                scaleup_per_host=nvlink,
            ),
            pcie_gbps=pcie_gbps,
        )
        self.flowsim = FlowSim(
            self.topo,
            spine_oversub=spine_oversub,
            link_latency_s=link_latency_s,
            switch_latency_s=switch_latency_s,
            link_profiles=link_profiles,
        )
        self.pool = ParameterPool(self.topo)
        self.pool.register(prof.name, prof.param_bytes)
        self.rng = np.random.default_rng(seed)

        self.instances: dict[int, Instance] = {}
        self._iid = 0
        self.now = 0.0
        self.events: list[tuple[float, int, str, object]] = []
        self._eid = 0
        self.done: set[int] = set()
        self.waiting_decode: deque[Request] = deque()
        # S-LLM style host cache tracking: host -> model -> last_used
        self.host_cache: dict[int, dict[str, float]] = defaultdict(dict)
        self.host_cache_peak: dict[int, int] = defaultdict(int)
        self.scale_seconds: list[float] = []
        self.net_scale_bytes = 0.0
        self.scale_events = 0
        # the device-time ledger IS the GPU-time accounting: every accounted
        # interval lands in exactly one state, and gpu_time_s is defined as
        # the ledger total — attribution conserves by construction
        self.ledger = DeviceTimeLedger()
        self._last_gpu_t = 0.0
        self.timeline: list[tuple[float, int, int]] = []
        self._serving_flows: dict[int, Flow] = {}  # prefill iid -> KV stream
        self._dev2inst: dict[int, Instance] = {}  # scale flows in flight
        self.kv_stream_bytes = 0.0  # per-request KV volume shipped over the net
        self.kv_re_prefills = 0  # KV source died -> re-prefilled elsewhere

        # observability: the null tracer keeps every instrumented site a
        # no-op, and the net bridge is only subscribed when tracing is on —
        # a disabled run's flow-event stream is bit-for-bit unchanged
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        # optional streaming SLO monitor (repro_torch.obs.slo.SLOMonitor): fed at
        # prefill completion (TTFT) and request completion (TBTs)
        self.slo = slo_monitor
        # optional link-time ledger: attaches to the FlowSim so every byte
        # the run moves is attributed to its flow-kind group per link
        self.link_ledger = link_ledger
        if link_ledger is not None:
            self.flowsim.attach_ledger(link_ledger)
        self._bridge = None
        if self.tracer.enabled:
            self._bridge = NetEventBridge(self.tracer)
            self.flowsim.subscribe(self._bridge)
        # optional flight recorder (repro_torch.obs.flightrec.FlightRecorder):
        # rides the same NetEvent subscription for its always-on ring and
        # failure triggers; SLO-page triggers are polled from _monitor
        self.flight_recorder = flight_recorder
        if flight_recorder is not None:
            flight_recorder.attach(self.flowsim)
        self._req_spans: dict[int, object] = {}  # rid -> request root span
        self._decode_spans: dict[int, object] = {}  # rid -> open decode span
        self._scale_spans: dict[int, object] = {}  # iid -> instance-load span
        self._scale_ops: dict[int, object] = {}  # op sid -> scale_op span
        self._scale_pending: dict[int, set[int]] = {}  # op sid -> open iids

        cap_tps = self.prof.prefill_tps
        dec_tps = 32.0 / (self.prof.weight_pass_s + 32 * self.prof.kv_read_s(1024))
        n_accel = sum(1 for d in self.topo.devices if not d.is_host)
        self.scaler = Autoscaler(
            PolicyConfig(max_instances=n_accel // prof.devices_per_instance),
            prefill_capacity_tps=cap_tps * 0.9,
            decode_capacity_tps=dec_tps,
        )
        self._reqs: dict[int, Request] = {}

    # -- event machinery ----------------------------------------------------
    def schedule(self, t: float, fn) -> None:
        """Run ``fn(sim)`` at simulation time ``t`` — the hook failure
        scenarios use (e.g. ``sim.schedule(5.0, lambda s:
        s.flowsim.fail_device(3, s.now))``)."""
        self.push(t, "call", fn)

    def push(self, t: float, kind: str, payload: object = None) -> None:
        if not math.isfinite(t):
            return  # loading instances have active_from=inf until flows land
        self._eid += 1
        # never schedule into the past — a stale net event must not move
        # simulation time backwards
        heapq.heappush(self.events, (max(t, self.now), self._eid, kind, payload))

    def _schedule_net(self) -> None:
        """Keep a poll event at the flow simulator's next completion time;
        any flow mutation moves that time, so this is re-armed after each."""
        t = self.flowsim.next_event_time()
        if t is not None:
            self.push(t, "net")

    # -- tracing helpers ------------------------------------------------------
    def _trace_decode_begin(self, rid: int, iid: int) -> None:
        if self.tracer.enabled and rid not in self._decode_spans:
            self._decode_spans[rid] = self.tracer.begin(
                "decode", self.now, cat="compute",
                parent=self._req_spans.get(rid), iid=iid)

    def _trace_request_done(self, r: Request, t: float) -> None:
        sp = self._decode_spans.pop(r.rid, None)
        if sp is not None:
            self.tracer.end(sp, t)
        root = self._req_spans.pop(r.rid, None)
        if root is not None:
            self.tracer.end(root, t, tokens=r.output)

    def _trace_scale_close(self, iid: int, t: float, *,
                           aborted: bool = False) -> None:
        """Close a loading instance's span; the batch scale_op span closes
        when its last instance does."""
        sp = self._scale_spans.pop(iid, None)
        if sp is None:
            return
        if aborted:
            self.tracer.end(sp, t, aborted=True)
        else:
            self.tracer.instant("serving", t, cat="scale", parent=sp)
            self.tracer.end(sp, t)
        pend = self._scale_pending.get(sp.parent)
        if pend is not None:
            pend.discard(iid)
            if not pend:
                del self._scale_pending[sp.parent]
                op = self._scale_ops.pop(sp.parent, None)
                if op is not None:
                    self.tracer.end(op, t)

    # -- instance management --------------------------------------------------
    def _alloc_devices(self, n_devs: int) -> list[int] | None:
        spares = [d for d in self.topo.spares() if self.flowsim.device_ok(d.id)]
        by_su = self.topo.scaleup_groups([d.id for d in spares])
        ids: list[int] = []
        for su, members in sorted(by_su.items(), key=lambda kv: -len(kv[1])):
            for m in members:
                if len(ids) < n_devs:
                    ids.append(m)
        return ids if len(ids) == n_devs else None

    def _activate_instance(self, phase: str, dev_ids: list[int],
                           active_from: float) -> Instance:
        inst = Instance(self._iid, phase, tuple(dev_ids), active_from,
                        busy_until=active_from)
        self._iid += 1
        self.instances[inst.iid] = inst
        for i in dev_ids:
            d = self.topo.device(i)
            d.role = Role.PREFILL if phase == "prefill" else Role.DECODE
            d.model = self.prof.name
        self.pool.deploy(self.prof.name, dev_ids)
        return inst

    def _retire_instance(self, inst: Instance) -> None:
        inst.retired = True
        self._trace_scale_close(inst.iid, self.now, aborted=True)
        self.pool.reclaim(self.prof.name, inst.device_ids)
        self.instances.pop(inst.iid, None)
        for i in inst.device_ids:
            if self._dev2inst.get(i) is inst:
                self._dev2inst.pop(i, None)
        f = self._serving_flows.pop(inst.iid, None)
        if f is not None:
            self.flowsim.remove(f, self.now, abort=False)
            self._schedule_net()

    def _live_instances(self, phase: str) -> list[Instance]:
        return [i for i in self.instances.values() if i.phase == phase and not i.retired]

    def _active_instances(self, phase: str) -> list[Instance]:
        return [i for i in self._live_instances(phase) if self.now >= i.active_from]

    # -- data plane models -----------------------------------------------------
    def _delay_simple(self, dev_ids: list[int]) -> float:
        """Data-plane seconds for one instance on ssd/hostcache/delay planes
        (host-LOCAL loads — the compute-network planes are real flows)."""
        s = self.sys
        pb = self.prof.param_bytes
        per_dev = pb / self.prof.devices_per_instance
        if s.data_plane == "delay":
            return s.fixed_delay_s
        if s.data_plane == "ssd":
            return per_dev / gbps_to_bytes_per_s(self.ssd_gbps)
        if s.data_plane == "hostcache":
            host = self.topo.device(dev_ids[0]).host
            cache = self.host_cache[host]
            hit = s.prewarm or (
                self.prof.name in cache
                and self.now - cache[self.prof.name] <= s.keepalive_s)
            cache[self.prof.name] = self.now
            self.host_cache_peak[host] = max(self.host_cache_peak[host],
                                             len(cache) * pb)
            bw = self.pcie_gbps if hit else self.ssd_gbps
            return per_dev / gbps_to_bytes_per_s(bw)
        raise ValueError(s.data_plane)

    def _host_source_dev(self, host: int | None) -> int:
        """The pseudo-device holding the O(1) host copy (any host if the
        pool's record is unavailable)."""
        for d in self.topo.devices:
            if d.is_host and (host is None or d.host == host):
                return d.id
        raise RuntimeError("no host pseudo-device in topology")

    def _do_scale(self, phase: str, n_new: int) -> None:
        """Allocate and start loading n_new instances."""
        alloc: list[list[int]] = []
        for _ in range(n_new):
            devs = self._alloc_devices(self.prof.devices_per_instance)
            if devs is None:
                break
            # reserve immediately so subsequent allocs don't reuse
            for i in devs:
                self.topo.device(i).model = self.prof.name
                self.topo.device(i).role = (Role.PREFILL if phase == "prefill"
                                            else Role.DECODE)
            alloc.append(devs)
        if not alloc:
            return
        pb = self.prof.param_bytes

        if self.sys.data_plane in ("network_multicast", "network_naive"):
            self._do_scale_network(phase, alloc)
            return

        for devs in alloc:
            delay = self._delay_simple(devs) + self.sys.control_plane_s
            self.scale_seconds.append(delay)
            self.scale_events += 1
            inst = self._activate_instance(phase, devs, self.now + delay)
            if self.tracer.enabled:
                op = self.tracer.span(
                    "scale_op", self.now, self.now + delay, cat="scale",
                    track="scale", phase=phase, plane=self.sys.data_plane,
                    iid=inst.iid, control_s=self.sys.control_plane_s)
                self.tracer.instant("serving", self.now + delay, cat="scale",
                                    parent=op)
            self.push(self.now + delay, "scale_done", inst.iid)

    def _do_scale_network(self, phase: str, alloc: list[list[int]]) -> None:
        """Compute-network data plane: scale transfers are flows on the
        shared FlowSim, contending with serving streams and each other;
        instances activate when their devices' flows actually land."""
        pb = self.prof.param_bytes
        for devs in alloc:  # roles already set; undo for planning targets
            for i in devs:
                self.topo.device(i).role = Role.FREE
                self.topo.device(i).model = None
        gpu_srcs, host = self.pool.sources(self.prof.name)
        tgt_ids = [i for devs in alloc for i in devs]

        op = None
        if self.tracer.enabled:
            # decision -> plan -> hops -> layer arrivals -> serving, one tree
            op = self.tracer.begin(
                "scale_op", self.now, cat="scale", track="scale",
                phase=phase, plane=self.sys.data_plane, n_instances=len(alloc),
                control_s=self.sys.control_plane_s)

        plan = None
        if self.sys.data_plane == "network_multicast":
            # ONE Algorithm-11 plan covers the whole batch (multi-chain);
            # plan_multicast falls back to the O(1) host copy when every
            # GPU source is pruned or absent (hosts are in the topology).
            # Planned while the targets are still role-FREE, against the
            # FlowSim's latency view so the planner prices the same
            # store-and-forward delays the data plane will charge.
            plan = mc.plan_multicast(
                self.topo, gpu_srcs, tgt_ids, len(tgt_ids),
                allow_interference=self.sys.allow_interference,
                net=self.flowsim, model_bytes=pb,
            )
            if op is not None:
                self.tracer.instant(
                    "plan", self.now, cat="scale", parent=op,
                    chains=len(plan.chains), covered=len(plan.covered))

        insts: list[Instance] = []
        for devs in alloc:
            inst = self._activate_instance(phase, devs, math.inf)
            inst.pending_devs = set(devs)
            inst.scale_start = self.now
            inst.busy_until = math.inf
            for i in devs:
                self._dev2inst[i] = inst
            insts.append(inst)
            self.scale_events += 1
            if op is not None:
                self._scale_spans[inst.iid] = self.tracer.begin(
                    "instance_load", self.now, cat="load", parent=op,
                    iid=inst.iid, devices=list(devs))
        if op is not None:
            self._scale_ops[op.sid] = op
            self._scale_pending[op.sid] = {i.iid for i in insts}
        self.net_scale_bytes += pb * len(alloc)

        if plan is not None:
            t_est = plan.transfer_seconds(pb)
            # degenerate plans (no chains, or only edge-less source-only
            # chains -> t_est == 0) must not feed the live-boost ramp an
            # instant/absurd rate: fall back to the analytic unicast time
            if not plan.chains or t_est <= 0.0 or not math.isfinite(t_est):
                t_est = pb / gbps_to_bytes_per_s(min(self.pcie_gbps, self.net_gbps))
            exec_ = MulticastExecution(
                plan, pb, on_node_ready=self._node_ready,
                tracer=self.tracer if op is not None else None,
                parent_span=op,
            )
            if self._bridge is not None:
                self._bridge.pin_all(exec_.flows, op)
            exec_.start(self.flowsim, self.now)
            uncovered = set(tgt_ids) - set(plan.covered)
            if self.sys.live and phase == "prefill":
                # pair loading targets with the most-loaded active sources;
                # a source's throughput ramps with the target's layer loads
                for _ in alloc:
                    srcs = self._active_instances("prefill")
                    if srcs:
                        src = max(srcs, key=lambda i: len(i.queue))
                        if src.live_boost is None:
                            src.live_boost = LiveSession(
                                self.prof.n_layers,
                                pb // self.prof.n_layers,
                                pb / max(t_est, 1e-9),
                                started_at=self.now,
                            )
        else:  # network_naive: unicast through ONE egress, interference-
            # ignorant source selection (reads from a serving GPU copy when
            # one exists — its KV stream shares the same link direction)
            src = gpu_srcs[0] if gpu_srcs else self._host_source_dev(host)
            uncovered = set()
            for inst in insts:
                f = Flow(
                    FlowKind.COLD_START, src, inst.device_ids[0], float(pb),
                    on_complete=self._unicast_done, payload=inst.iid,
                    tag=f"naive:{inst.iid}",
                )
                if self._bridge is not None:
                    self._bridge.pin(f, self._scale_spans.get(inst.iid))
                self.flowsim.start(f, self.now)
                # the flow lands on one device; siblings fill over scale-up
                inst.pending_devs = {inst.device_ids[0]}
                for i in inst.device_ids[1:]:
                    self._dev2inst.pop(i, None)

        # targets the planner could not reach at all: PCIe host fallback
        for i in sorted(uncovered):
            f = Flow(
                FlowKind.COLD_START, self._host_source_dev(host), i, float(pb),
                on_complete=lambda f, t: self._dev_ready(f.dst, t),
                tag=f"fallback:{i}",
            )
            if self._bridge is not None:
                self._bridge.pin(f, op)
            self.flowsim.start(f, self.now)
        self._schedule_net()

    # -- scale-flow completion plumbing ---------------------------------------
    def _node_ready(self, node, t: float) -> None:
        for i in node.device_ids:
            self._dev_ready(i, t)

    def _unicast_done(self, flow: Flow, t: float) -> None:
        inst = self.instances.get(flow.payload)
        if inst is not None:
            for i in list(inst.pending_devs):
                self._dev_ready(i, t)

    def _dev_ready(self, dev: int, t: float) -> None:
        inst = self._dev2inst.get(dev)
        if inst is None:
            return
        inst.pending_devs.discard(dev)
        self._dev2inst.pop(dev, None)
        if inst.pending_devs or inst.retired:
            return
        delay = (t - inst.scale_start) + self.sys.control_plane_s
        self.scale_seconds.append(delay)
        inst.active_from = t + self.sys.control_plane_s
        inst.busy_until = inst.active_from
        self._trace_scale_close(inst.iid, inst.active_from)
        self.push(inst.active_from, "scale_done", inst.iid)

    # -- serving: prefill ------------------------------------------------------
    def _best_prefill(self) -> Instance | None:
        cands = self._active_instances("prefill")
        if self._kv_net:
            # a prefill whose NIC died can compute but never hand off its
            # KV — only route there when nothing healthy exists at all
            ok = [i for i in cands if self.flowsim.device_ok(i.device_ids[0])]
            cands = ok or cands
        if not cands:
            # fall back to the earliest-activating instance (requests queue)
            pend = self._live_instances("prefill")
            return min(pend, key=lambda i: i.active_from) if pend else None
        return min(cands, key=lambda i: (len(i.queue), max(i.busy_until - self.now, 0.0)))

    def _kick_prefill(self, inst: Instance) -> None:
        if inst.retired or not inst.queue:
            return
        if self.now < inst.active_from:
            self.push(inst.active_from, "prefill_round", inst.iid)
            return
        if inst.busy_until > self.now + 1e-12:
            self.push(inst.busy_until, "prefill_round", inst.iid)
            return
        mult = inst.boost(self.now)  # >= 1; live cooperative execution
        req: Request = inst.queue.popleft()
        service = req.prompt / (self.prof.prefill_tps * mult)
        inst.busy_until = self.now + service
        if self.tracer.enabled:
            root = self._req_spans.get(req.rid)
            if root is not None:
                # partition [arrival, prefill_done] exactly: waiting for the
                # instance's parameters to arrive (load), then behind other
                # requests (queue), then the forward pass itself (compute) —
                # the three causes the attribution report splits TTFT into
                b = min(max(inst.active_from, req.arrival), self.now)
                if b - req.arrival > 1e-12:
                    self.tracer.span("load_wait", req.arrival, b, cat="load",
                                     parent=root, iid=inst.iid)
                if self.now - b > 1e-12:
                    self.tracer.span("queue", b, self.now, cat="queue",
                                     parent=root, iid=inst.iid)
                self.tracer.span("prefill", self.now, inst.busy_until,
                                 cat="compute", parent=root, iid=inst.iid)
        self.push(inst.busy_until, "prefill_done", (inst.iid, req.rid))

    # -- serving: decode -------------------------------------------------------
    def _best_decode(self, req: Request) -> Instance | None:
        need = req.prompt + req.output
        cands = [i for i in self._active_instances("decode")
                 if i.kv_tokens + need <= self.prof.kv_capacity_tokens]
        if not cands:
            return None
        return min(cands, key=lambda i: i.kv_tokens)

    def _admit_waiting(self, inst: Instance) -> None:
        if self._kv_net:
            self._drain_waiting()
            return
        while self.waiting_decode:
            r = self.waiting_decode[0]
            if inst.kv_tokens + r.prompt + r.output > self.prof.kv_capacity_tokens:
                break
            self.waiting_decode.popleft()
            was_empty = not inst.active_reqs
            inst.active_reqs[r.rid] = r
            inst.kv_tokens += r.prompt + r.output
            self._trace_decode_begin(r.rid, inst.iid)
            if was_empty:
                self.push(self.now, "decode_round", inst.iid)

    # -- per-request KV serving streams (request-granular network realism) ----
    def _best_kv_target(self, req: Request) -> Instance | None:
        """A decode instance with KV room AND a live NIC — a per-request KV
        stream must actually be deliverable."""
        need = req.prompt + req.output
        cands = [i for i in self._active_instances("decode")
                 if i.kv_tokens + need <= self.prof.kv_capacity_tokens
                 and self.flowsim.device_ok(i.device_ids[0])]
        return min(cands, key=lambda i: i.kv_tokens) if cands else None

    def _route_kv(self, r: Request) -> None:
        dinst = self._best_kv_target(r)
        if dinst is None:
            self.waiting_decode.append(r)
            return
        self._start_kv_flow(r, dinst)

    def _start_kv_flow(self, r: Request, dinst: Instance) -> None:
        """Ship the request's ACTUAL KV volume prefill→decode as one flow;
        the request starts decoding only when the flow lands.  The KV seat
        on the target is reserved at flow start so concurrent streams never
        oversubscribe its capacity."""
        dinst.kv_tokens += r.prompt + r.output
        src, dst = r.kv_src, dinst.device_ids[0]
        if src is None or src == dst:
            self._kv_landed(dinst.iid, r.rid)  # nothing to cross the wire
            return
        if not self.flowsim.device_ok(src):
            # the device holding the frozen KV died: the pages cannot leave
            # it — pay a real re-prefill on a healthy instance (mirrors the
            # disagg runtime's re_prefills path), then stream from there
            dinst.kv_tokens -= r.prompt + r.output
            self._re_prefill(r)
            return
        size = float(request_kv_bytes(r.prompt, self.prof.kv_bytes_per_token))
        self.kv_stream_bytes += size
        f = Flow(
            FlowKind.SERVING, src, dst, size,
            payload=(dinst.iid, r.rid),
            on_complete=lambda f, t: self.push(t, "kv_landed", f.payload),
            on_abort=lambda f, t: self.push(t, "kv_failed", f.payload),
            tag=f"reqkv:{r.rid}",
        )
        if self._bridge is not None:
            self._bridge.pin(f, self._req_spans.get(r.rid),
                             name="kv_transfer", cat="migration")
        self.flowsim.start(f, self.now)
        self._schedule_net()

    def _kv_landed(self, iid: int, rid: int) -> None:
        r = self._reqs[rid]
        inst = self.instances.get(iid)
        if inst is None or inst.retired:
            self._route_kv(r)  # target died/retired while KV was in flight
            return
        was_empty = not inst.active_reqs
        inst.active_reqs[rid] = r
        self._trace_decode_begin(rid, inst.iid)
        if was_empty:
            self.push(self.now, "decode_round", inst.iid)

    def _re_prefill(self, r: Request) -> None:
        """The request's frozen KV sits on a dead device: re-run prefill on
        a healthy instance (compute-bound, occupies that instance) and
        re-route the KV stream from its device when done."""
        cands = [i for i in self._active_instances("prefill")
                 if self.flowsim.device_ok(i.device_ids[0])]
        if not cands:
            # no healthy prefill anywhere: re-enter through the arrival
            # path, where the request queues, counts as offered load (so
            # the autoscaler provisions a replacement) and re-prefills
            # once an instance exists — parking it in waiting_decode would
            # strand it invisibly forever
            self.kv_re_prefills += 1
            self.push(self.now + 0.05, "arrival", r)
            return
        inst = min(cands, key=lambda i: (len(i.queue), max(i.busy_until - self.now, 0.0)))
        service = r.prompt / self.prof.prefill_tps
        t_done = max(self.now, inst.busy_until) + service
        inst.busy_until = t_done
        r.kv_src = inst.device_ids[0]
        self.kv_re_prefills += 1
        self.push(t_done, "kv_route", r.rid)

    def _drain_waiting(self) -> None:
        """Re-route queued requests now that decode capacity (or a reachable
        target) may have appeared."""
        for _ in range(len(self.waiting_decode)):
            r = self.waiting_decode.popleft()
            dinst = self._best_kv_target(r)
            if dinst is None:
                self.waiting_decode.appendleft(r)
                break
            self._start_kv_flow(r, dinst)

    def _decode_round(self, inst: Instance) -> None:
        if inst.retired or not inst.active_reqs:
            return
        if inst.busy_until > self.now + 1e-12:
            self.push(inst.busy_until, "decode_round", inst.iid)
            return
        batch = list(inst.active_reqs.values())
        ctx = sum(r.prompt + r.decoded for r in batch) / len(batch)
        round_t = self.prof.weight_pass_s + len(batch) * self.prof.kv_read_s(ctx)
        t_end = self.now + round_t
        for r in batch:
            r.decoded += 1
            r.token_times.append(t_end)
            if r.decoded >= r.output:
                inst.active_reqs.pop(r.rid, None)
                inst.kv_tokens -= r.prompt + r.output
                self.done.add(r.rid)
                if self.tracer.enabled:
                    self._trace_request_done(r, t_end)
                if self.slo is not None:
                    for tbt in r.tbts():
                        self.slo.observe_tbt("sim", t_end, tbt)
        inst.busy_until = t_end
        self._admit_waiting(inst)
        if inst.active_reqs:
            self.push(t_end, "decode_round", inst.iid)

    # -- monitoring / autoscaling ---------------------------------------------
    def _sync_serving_flows(self) -> None:
        """Keep one persistent KVCache stream (prefill egress -> decode
        ingress) per active prefill instance on the FlowSim, so scale flows
        contend with live serving traffic (the Fig. 7b interference that
        interference-aware planning avoids and 'blitz-naive' suffers)."""
        if self.sys.data_plane not in ("network_multicast", "network_naive"):
            return
        if self._kv_net:
            return  # serving traffic is per-request KV flows, not streams
        decs = self._active_instances("decode")
        desired: dict[int, tuple[int, int]] = {}
        if decs:
            for inst in self._active_instances("prefill"):
                dst = decs[inst.iid % len(decs)]
                desired[inst.iid] = (inst.device_ids[0], dst.device_ids[0])
        changed = False
        for iid, f in list(self._serving_flows.items()):
            if desired.get(iid) != (f.src, f.dst):
                self.flowsim.remove(f, self.now, abort=False)
                del self._serving_flows[iid]
                changed = True
        for iid, (s, d) in desired.items():
            if iid not in self._serving_flows:
                f = Flow(FlowKind.SERVING, s, d, math.inf, tag=f"serving:{iid}")
                self.flowsim.start(f, self.now)
                self._serving_flows[iid] = f
                changed = True
        if changed:
            self._schedule_net()

    def _monitor(self) -> None:
        self._sync_serving_flows()
        if self._kv_net and self.waiting_decode:
            self._drain_waiting()  # recover from aborts / retired targets
        if self.metrics is not None:
            m = self.metrics
            m.gauge("sim.instances.prefill").set(
                len(self._live_instances("prefill")))
            m.gauge("sim.instances.decode").set(
                len(self._live_instances("decode")))
            m.gauge("sim.waiting_decode").set(len(self.waiting_decode))
            m.counter("sim.scale_events").set(self.scale_events)
            m.counter("sim.net_scale_bytes").set(self.net_scale_bytes)
            m.counter("sim.kv_stream_bytes").set(self.kv_stream_bytes)
            m.snap(self.now)
        if self.flight_recorder is not None:
            self.flight_recorder.poll(self.now)
        if not self.sys.autoscale:
            return
        pre = self._live_instances("prefill")
        dec = self._live_instances("decode")
        q_tokens = sum(r.prompt for i in pre for r in i.queue)
        inflight = sum(1 for i in pre if i.busy_until > self.now)
        ptps = q_tokens / max(self.prof.ttft_slo_s, 1e-3) + inflight * self.prof.prefill_tps
        kv_frac = (max((i.kv_tokens for i in dec), default=0)
                   / self.prof.kv_capacity_tokens)
        dtokens = sum(len(i.active_reqs) for i in dec)
        dtps = dtokens / max(self.prof.weight_pass_s + self.prof.kv_read_s(1024), 1e-9) * 1e-3
        self.scaler.prefill_mon.record(LoadSample(self.now, ptps, 0.0, q_tokens))
        self.scaler.decode_mon.record(
            LoadSample(self.now, dtps, kv_frac, len(self.waiting_decode)))
        d = self.scaler.decide(self.now, len(pre), len(dec))
        if d.prefill_delta > 0:
            self._do_scale("prefill", d.prefill_delta)
        elif d.prefill_delta < 0 and len(pre) > 1:
            idle = [i for i in self._active_instances("prefill")
                    if not i.queue and i.busy_until <= self.now and i.live_boost is None]
            if idle:
                self._retire_instance(idle[0])
        if d.decode_delta > 0:
            self._do_scale("decode", d.decode_delta)
        elif d.decode_delta < 0 and len(dec) > 1:
            idle = [i for i in self._active_instances("decode") if not i.active_reqs]
            if idle:
                self._retire_instance(idle[0])

    def _account_gpu(self, t_new: float) -> None:
        # Partition [self._last_gpu_t, t_new] per instance into exclusive
        # ledger states.  Instance state is piecewise-constant over the
        # interval (transitions coincide with popped events), except
        # active_from, which may fall inside it — split there.
        dt = t_new - self._last_gpu_t
        if dt <= 0:
            return
        t0 = self._last_gpu_t
        led = self.ledger
        for inst in self.instances.values():
            n = len(inst.device_ids)
            af = inst.active_from
            if af >= t_new:
                load, active = dt, 0.0
            elif af <= t0:
                load, active = 0.0, dt
            else:
                load, active = af - t0, t_new - af
            if load > 0.0:
                # loading with work already queued = the stall BLITZSCALE's
                # live loading exists to hide
                led.accrue(
                    "stalled_waiting_layers" if (inst.queue or inst.active_reqs)
                    else "loading_params", load * n)
            if active > 0.0:
                a0 = max(t0, af)
                busy = min(max(inst.busy_until - a0, 0.0), active)
                if busy > 0.0:
                    led.accrue("serving_prefill" if inst.phase == "prefill"
                               else "serving_decode", busy * n)
                idle = active - busy
                if idle > 0.0:
                    led.accrue("allocated_idle", idle * n)
        self._last_gpu_t = t_new

    # -- main loop ---------------------------------------------------------------
    def run(self, trace: list[tuple[float, int, int]]) -> SimResult:
        """trace: list of (arrival_s, prompt_tokens, output_tokens)."""
        reqs = [Request(i, t, p, o) for i, (t, p, o) in enumerate(trace)]
        for r in reqs:
            self._reqs[r.rid] = r
            self.push(r.arrival, "arrival", r)
        horizon = max(t for t, _, _ in trace) + 120.0

        if self.sys.autoscale:
            init_p, init_d = 1, 1
        else:
            init_p, init_d = self.sys.fixed_prefill, self.sys.fixed_decode
        for _ in range(init_p):
            devs = self._alloc_devices(self.prof.devices_per_instance)
            if devs:
                self._activate_instance("prefill", devs, 0.0)
        for _ in range(init_d):
            devs = self._alloc_devices(self.prof.devices_per_instance)
            if devs:
                self._activate_instance("decode", devs, 0.0)

        self.push(0.0, "monitor")
        guard = 0
        while self.events and guard < 5_000_000:
            guard += 1
            t, _, kind, payload = heapq.heappop(self.events)
            if t > horizon:
                break
            self._account_gpu(t)
            self.now = t
            if kind == "arrival":
                r: Request = payload
                if self.tracer.enabled and r.rid not in self._req_spans:
                    self._req_spans[r.rid] = self.tracer.begin(
                        "request", r.arrival, cat="request",
                        track=f"req{r.rid % 8}", rid=r.rid,
                        prompt=r.prompt, output=r.output)
                inst = self._best_prefill()
                if inst is None:
                    self.push(self.now + 0.05, "arrival", r)
                    continue
                inst.queue.append(r)
                self._kick_prefill(inst)
            elif kind in ("prefill_round", "kick_prefill"):
                inst = self.instances.get(payload)
                if inst:
                    self._kick_prefill(inst)
            elif kind == "prefill_done":
                iid, rid = payload
                inst = self.instances.get(iid)
                r = self._reqs[rid]
                r.prefill_done = self.now
                if self.tracer.enabled:
                    root = self._req_spans.get(rid)
                    if root is not None and r.ttft is not None:
                        root.attrs["ttft"] = r.ttft
                if self.metrics is not None and r.ttft is not None:
                    self.metrics.histogram("sim.ttft_s").observe(r.ttft)
                if self.slo is not None and r.ttft is not None:
                    self.slo.observe_ttft("sim", self.now, r.ttft)
                if self._kv_net:
                    # the frozen KV pages live on the prefill device; they
                    # reach decode as a real flow, not an instant handoff
                    r.kv_src = inst.device_ids[0] if inst is not None else None
                    self._route_kv(r)
                else:
                    dinst = self._best_decode(r)
                    if dinst is None:
                        self.waiting_decode.append(r)
                    else:
                        was_empty = not dinst.active_reqs
                        dinst.active_reqs[r.rid] = r
                        dinst.kv_tokens += r.prompt + r.output
                        if was_empty:
                            self.push(self.now, "decode_round", dinst.iid)
                if inst:
                    self._kick_prefill(inst)
            elif kind == "kv_landed":
                self._kv_landed(*payload)
            elif kind == "kv_route":
                self._route_kv(self._reqs[payload])
            elif kind == "call":
                payload(self)  # scheduled scenario hook (failures etc.)
                self._schedule_net()  # the hook may have changed flow rates
            elif kind == "kv_failed":
                iid, rid = payload
                r = self._reqs[rid]
                dinst = self.instances.get(iid)
                if dinst is not None and not dinst.retired:
                    dinst.kv_tokens -= r.prompt + r.output  # release the seat
                self._route_kv(r)  # re-target on a surviving instance
            elif kind == "decode_round":
                inst = self.instances.get(payload)
                if inst:
                    self._decode_round(inst)
            elif kind == "net":
                # settle flow completions (their callbacks finalize scale
                # events) and re-arm at the new next completion time
                self.flowsim.advance_to(self.now)
                self._schedule_net()
            elif kind == "scale_done":
                inst = self.instances.get(payload)
                if inst is not None:
                    if inst.phase == "prefill":
                        # steal queued work from overloaded active siblings
                        sib = self._active_instances("prefill")
                        donors = sorted(sib, key=lambda i: -len(i.queue))
                        for d_inst in donors:
                            if d_inst.live_boost is not None:
                                d_inst.live_boost = None  # rebalance step 3
                            while len(d_inst.queue) > len(inst.queue) + 1:
                                inst.queue.append(d_inst.queue.pop())
                        self._kick_prefill(inst)
                    else:
                        self._admit_waiting(inst)
            elif kind == "monitor":
                self._monitor()
                self.timeline.append(
                    (self.now, len(self._live_instances("prefill")),
                     len(self._live_instances("decode"))))
                if self.now < horizon and len(self.done) < len(reqs):
                    self.push(self.now + self.monitor_dt, "monitor")
        self._account_gpu(self.now)
        # unfinished requests / background flows must not leave dangling spans
        self.tracer.close_open(self.now)
        return SimResult(
            system=self.sys.name,
            requests=reqs,
            gpu_time_s=self.ledger.total(),
            device_seconds=self.ledger.breakdown(),
            host_cache_peak_bytes=dict(self.host_cache_peak),
            scale_events=self.scale_events,
            scale_seconds=self.scale_seconds,
            net_scale_bytes=self.net_scale_bytes,
            timeline=self.timeline,
            kv_stream_bytes=self.kv_stream_bytes,
            kv_re_prefills=self.kv_re_prefills,
        )


def run_system(system: SystemConfig, prof: ModelProfile,
               trace: list[tuple[float, int, int]], **kw) -> SimResult:
    return Simulator(system, prof, **kw).run(trace)
