"""The port's copies of the serving control plane against the JAX package's
modules: the multicast planner, the flow-level network, the autoscaler, the
parameter pool, the router and ``select_live_pairs``.

Each scenario is written once against a namespace of modules and run twice,
through the JAX package's modules and through the port's copies.  Its result
is plain data (numbers, tuples, rendered event lines), and the two results
must be equal exactly: the copies do the same float operations in the same
order.  Plans are compared without ``gen_seconds``, which is wall time.
"""

import dataclasses
import math
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.autoscaler as j_autoscaler  # noqa: E402
import repro.core.live_scaling as j_live  # noqa: E402
import repro.core.multicast as j_mc  # noqa: E402
import repro.core.parameter_pool as j_pool  # noqa: E402
import repro.core.topology as j_tp  # noqa: E402
import repro.net as j_net  # noqa: E402
import repro.serving.router as j_router  # noqa: E402
import repro_torch.core.autoscaler as t_autoscaler  # noqa: E402
import repro_torch.core.live_scaling as t_live  # noqa: E402
import repro_torch.core.multicast as t_mc  # noqa: E402
import repro_torch.core.parameter_pool as t_pool  # noqa: E402
import repro_torch.core.topology as t_tp  # noqa: E402
import repro_torch.net as t_net  # noqa: E402
import repro_torch.serving.router as t_router  # noqa: E402

JAX = types.SimpleNamespace(tp=j_tp, mc=j_mc, net=j_net, auto=j_autoscaler, pool=j_pool,
                            router=j_router, live=j_live)
PORT = types.SimpleNamespace(tp=t_tp, mc=t_mc, net=t_net, auto=t_autoscaler, pool=t_pool,
                             router=t_router, live=t_live)
GB = 1e9  # 8 Gbps links -> 1e9 bytes/s


def _plan_data(m, topo, plan, model_bytes=int(16e9)):
    d = dataclasses.asdict(plan)
    d.pop("gen_seconds")  # wall time of the planner, never equal between runs
    return {
        "plan": d,
        "transfer_seconds": plan.transfer_seconds(model_bytes),
        "errors": m.mc.validate_plan(topo, plan),
        "tails": [n.device_ids for n in plan.live_scale_nodes],
    }


def _cluster(m, n_hosts, devs, bw=100.0, hosts_per_leaf=2):
    return m.tp.add_host_sources(
        m.tp.make_cluster(n_hosts, devs, bw_gbps=bw, hosts_per_leaf=hosts_per_leaf))


def _flat(m, n_devs, *, hosts_per_leaf=2, bw=8.0):
    return m.tp.make_cluster(n_devs, 1, hosts_per_leaf=hosts_per_leaf, bw_gbps=bw)


def _finish(flows):
    return [(f.src, f.dst, f.finished_at, f.aborted) for f in flows]


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# Multicast planner (tests/test_multicast.py)
# ---------------------------------------------------------------------------


@scenario
def plan_mixed_roles(m):
    """Sources of both roles; prefill sources (busy egress) are pruned."""
    topo = _cluster(m, 4, 4)
    accel = [d.id for d in topo.devices if not d.is_host]
    for i, role in zip(accel[:6], [m.tp.Role.PREFILL, m.tp.Role.DECODE] * 3):
        topo.device(i).role = role
        topo.device(i).model = "m"
    spares = [d.id for d in topo.spares()]
    plan = m.mc.plan_multicast(topo, accel[:6], spares, len(spares))
    out = _plan_data(m, topo, plan)
    assert out["errors"] == [] and len(plan.covered) == len(spares)
    return out


@scenario
def plan_multi_chain_per_leaf(m):
    topo = _cluster(m, 4, 4, hosts_per_leaf=1)
    for i in (0, 8):
        topo.device(i).model = "m"
        topo.device(i).role = m.tp.Role.DECODE
    spares = [d.id for d in topo.spares()]
    plan = m.mc.plan_multicast(topo, [0, 8], spares, len(spares))
    assert len(plan.chains) >= 2
    return _plan_data(m, topo, plan)


@scenario
def plan_sharded_group(m):
    topo = _cluster(m, 2, 4)
    for i in range(4):
        topo.device(i).model = "m"
        topo.device(i).role = m.tp.Role.DECODE
    spares = [d.id for d in topo.spares()][:4]
    plan = m.mc.plan_multicast(topo, list(range(4)), spares, 4)
    assert plan.all_edges()[0].sharded_ways == 4
    return _plan_data(m, topo, plan)


@scenario
def plan_fastest_first_with_latency(m):
    """Heterogeneous NICs, planned against a FlowSim's hop latencies, as the
    disagg runtime plans its live-scales."""
    topo = m.tp.add_host_sources(m.tp.make_cluster(3, 2, bw_gbps=100.0))
    for d in topo.devices:
        if d.host == 2:
            d.bw_gbps = 400.0
    topo.device(0).model = "m"
    topo.device(0).role = m.tp.Role.DECODE
    sim = m.net.FlowSim(topo, link_latency_s=2e-6, switch_latency_s=1e-6)
    spares = [d.id for d in topo.spares()]
    plan = m.mc.plan_multicast(topo, [0], spares, len(spares), net=sim, model_bytes=int(2e9))
    return _plan_data(m, topo, plan, int(2e9))


@scenario
def chain_time_model(m):
    return [m.mc.chain_time_model(16_000_000_000, bw, n, pipelined=p)
            for bw in (25.0, 100.0, 400.0) for n in (1, 3, 8) for p in (True, False)]


@scenario
def select_live_pairs(m):
    """tests/test_live_scaling.py:69-80."""
    topo = m.tp.add_host_sources(m.tp.make_cluster(3, 4))
    topo.device(0).model = "m"
    topo.device(0).role = m.tp.Role.DECODE
    spares = [d.id for d in topo.spares()]
    plan = m.mc.plan_multicast(topo, [0], spares, len(spares))
    pairs = m.live.select_live_pairs(plan, overloaded=[0, 5])
    assert pairs
    return pairs, m.live.select_live_pairs(plan, [0], slo_requires_live=False)


# ---------------------------------------------------------------------------
# Flow-level network (tests/test_net.py)
# ---------------------------------------------------------------------------


@scenario
def net_incast_and_staggered_arrivals(m):
    sim = m.net.FlowSim(_flat(m, 8, hosts_per_leaf=8))
    log = m.net.FlowEventLog()
    sim.subscribe(log)
    K = m.net.FlowKind
    flows = [sim.start(m.net.Flow(K.KV_MIGRATION, src, 7, GB), 0.0) for src in range(4)]
    rates = [f.rate for f in flows]
    flows.append(sim.start(m.net.Flow(K.COLD_START, 5, 7, 0.5 * GB), 0.7))
    flows.append(sim.start(m.net.Flow(K.KV_MIGRATION, 6, 3, 2 * GB), 1.3))
    t = 0.0
    for _ in range(40):
        t += 0.173
        sim.advance_to(t)
    sim.advance_to(100.0)
    assert all(f.done for f in flows)
    return rates, _finish(flows), log.lines()


@scenario
def net_contention_degrade_and_oversubscription(m):
    K = m.net.FlowKind
    topo = _flat(m, 6, hosts_per_leaf=2)
    out = []
    for oversub in (1.0, 4.0):
        sim = m.net.FlowSim(topo, spine_oversub=oversub)
        fs = [sim.start(m.net.Flow(K.COLD_START, 0, 2, GB), 0.0),
              sim.start(m.net.Flow(K.COLD_START, 1, 3, GB), 0.0),
              sim.start(m.net.Flow(K.SERVING, 4, 3, math.inf), 0.2),
              sim.start(m.net.Flow(K.KV_MIGRATION, 5, 0, 3 * GB), 0.1)]
        sim.degrade_link((m.net.DEV_OUT, 5), 0.5, 0.6)
        sim.degrade_link((m.net.DEV_IN, 2), 0.25, 0.9)
        est = sim.estimate_transfer_time(1, 2, GB)
        sim.advance_to(100.0)
        out.append((est, _finish(fs), fs[2].rate))
    return out


@scenario
def net_failures(m):
    """A device failure aborts, a spine-plane failure reroutes, and a link
    failure on a one-plane network aborts; events in order."""
    K = m.net.FlowKind
    topo = _flat(m, 4, hosts_per_leaf=2)
    sim = m.net.FlowSim(topo, spine_planes=2)
    log = m.net.FlowEventLog()
    sim.subscribe(log)
    hits = []
    a = sim.start(m.net.Flow(K.COLD_START, 0, 1, GB, on_abort=lambda f, t: hits.append(t)), 0.0)
    b = sim.start(m.net.Flow(K.MULTICAST_HOP, 0, 3, GB), 0.0)
    up = next(link.key for link in b.path if link.key[0] == m.net.LEAF_UP)
    rerouted = sim.fail_link(up, 0.25)
    aborted = sim.fail_device(1, 0.5)
    sim.advance_to(100.0)
    sim1 = m.net.FlowSim(topo, spine_planes=1)
    g = sim1.start(m.net.Flow(K.MULTICAST_HOP, 0, 3, GB), 0.0)
    up1 = next(link.key for link in g.path if link.key[0] == m.net.LEAF_UP)
    one_plane = sim1.fail_link(up1, 0.25)
    assert aborted == [a] and rerouted == [] and one_plane == [g]
    return hits, _finish([a, b, g]), sorted(sim.dead_devices()), log.lines()


@scenario
def net_multicast_execution(m):
    """Dedicated links, a contended ingress and an abort on failure."""
    K = m.net.FlowKind
    out = []
    for case in ("dedicated", "contended", "failed"):
        topo = m.tp.add_host_sources(_flat(m, 4))
        topo.device(0).model = "m"
        topo.device(0).role = m.tp.Role.DECODE
        spares = [d.id for d in topo.spares()]
        plan = m.mc.plan_multicast(topo, [0], spares, len(spares))
        sim = m.net.FlowSim(topo)
        events = []
        ex = m.net.MulticastExecution(plan, int(GB), on_done=lambda e, t: events.append(("done", t)),
                                      on_abort=lambda e, t: events.append(("abort", t)))
        if case == "contended":
            sim.start(m.net.Flow(K.KV_MIGRATION, 0, spares[0], 2 * GB), 0.0)
        ex.start(sim, 0.0)
        if case == "failed":
            sim.fail_device(spares[0], 0.1)
        progress = []
        for t in (0.3, 0.9, 1.7):
            sim.advance_to(t)
            progress.append([ex.bytes_into(s) for s in spares])
        sim.advance_to(100.0)
        ready = sorted((n.device_ids, t) for n, t in ex.node_ready_at.items())
        out.append((case, ex.done, ex.aborted, ex.done_at, ready, progress, events))
    return out


# ---------------------------------------------------------------------------
# Autoscaler (tests/test_autoscaler.py): decisions on a seeded load sequence
# ---------------------------------------------------------------------------


@scenario
def autoscaler_seeded_load(m):
    out = []
    for prescale in (True, False):
        sc = m.auto.Autoscaler(
            m.auto.PolicyConfig(scale_down_timeout_s=0.5, monitor_window_s=1.0, kv_upper=0.8,
                                decode_prescale=prescale, max_instances=6),
            prefill_capacity_tps=100.0, decode_capacity_tps=80.0)
        rng = np.random.default_rng(7)
        n_p, n_d, t = 1, 1, 0.0
        for _ in range(120):
            t += float(rng.uniform(0.02, 0.3))
            burst = rng.random() < 0.2
            sc.prefill_mon.record(m.auto.LoadSample(
                t, float(rng.uniform(0, 900 if burst else 120)), 0.0, int(rng.integers(0, 9))))
            sc.decode_mon.record(m.auto.LoadSample(
                t, float(rng.uniform(0, 300)), float(rng.uniform(0, 1)), 0))
            d = sc.decide(t, n_p, n_d)
            out.append((d.prefill_delta, d.decode_delta, d.prescaled, d.reason,
                        sc.slo_pressure(n_p, n_d)))
            n_p = max(1, n_p + d.prefill_delta)
            n_d = max(1, n_d + d.decode_delta)
    return out


# ---------------------------------------------------------------------------
# Parameter pool (tests/test_parameter_pool.py)
# ---------------------------------------------------------------------------


@scenario
def parameter_pool_seeded_ops(m):
    topo = m.tp.make_cluster(4, 4)
    pool = m.pool.ParameterPool(topo)
    accel = [d.id for d in topo.devices]
    rng = np.random.default_rng(11)
    failed, trace = set(), []
    for _ in range(120):
        op = ["reg", "dep", "rec", "deact", "fail", "recover"][int(rng.integers(0, 6))]
        arg = int(rng.integers(0, 8))
        if op == "reg":
            pool.register(f"m{arg}", (arg + 1) << 28)
        elif op == "dep" and pool.models:
            name = sorted(pool.models)[arg % len(pool.models)]
            pool.deploy(name, [accel[(arg * 5 + len(trace)) % len(accel)]])
        elif op == "rec" and pool.models:
            name = sorted(pool.models)[arg % len(pool.models)]
            pool.reclaim(name, sorted(pool.models[name].gpu_devices)[:1])
        elif op == "deact" and pool.models:
            pool.deactivate(sorted(pool.models)[arg % len(pool.models)])
        elif op == "fail" and len(failed) < 3:
            failed.add(arg % 4)
            pool.fail_host(arg % 4)
        elif op == "recover" and failed:
            h = sorted(failed)[arg % len(failed)]
            failed.discard(h)
            pool.recover_host(h)
        assert pool.invariant_ok()
        trace.append((op, arg, {n: (pool.sources(n), pool.n_copies(n)) for n in sorted(pool.models)},
                      sorted(pool.host_cache_bytes().items()),
                      [(d.id, d.role.value, d.model) for d in topo.devices]))
    return trace


# ---------------------------------------------------------------------------
# Router (tests/test_engine_router.py): SLO and handoff reports
# ---------------------------------------------------------------------------


@scenario
def router_slo_and_handoffs(m):
    router = m.router.Router()
    rng = np.random.default_rng(5)
    t = 0.0
    rids = [router.submit(int(rng.integers(4, 64)), 8, t + 0.01 * i) for i in range(10)]
    pinned = rids[:4]
    for rid in pinned:
        router.begin_handoff(rid, src=0, dst=1, tokens_frozen=1, now=0.2)
        router.mark_migrating(rid)
    dispatched = [rec.rid for rec, _ in router.dispatch([types.SimpleNamespace(queue=[], active={})])]
    for i, rid in enumerate(rids):
        t = 0.05 + 0.013 * i + float(rng.uniform(0, 0.2))
        router.note_first_token(rid, t)
        for _ in range(int(rng.integers(1, 8))):
            t += float(rng.uniform(0.005, 0.09))
            router.note_token(rid, t)
        router.note_done(rid)
    oks = [router.complete_handoff(rid, 1 if i != 2 else 0, 0.5) for i, rid in enumerate(pinned)]
    router.reject(rids[-1], 0.9)
    return (dispatched, oks, router.handoff_report(), router.dropped, router.rejections,
            dataclasses.asdict(router.slo_report()), dataclasses.asdict(router.slo_report(2.0)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_copy_equals_jax(name):
    want = SCENARIOS[name](JAX)
    got = SCENARIOS[name](PORT)
    assert got == want


def test_copies_are_the_ports_own():
    """The port's modules are its own objects, not re-exports of the JAX
    package's (an isinstance check across the two would always fail)."""
    assert PORT.tp.Topology is not JAX.tp.Topology
    assert PORT.net.FlowSim is not JAX.net.FlowSim
    assert PORT.mc.plan_multicast.__module__ == "repro_torch.core.multicast"
