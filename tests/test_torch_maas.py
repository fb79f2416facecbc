"""The port's MaaS fleet on torch engines against the JAX fleet on JAX engines,
exactly, on a simulated clock (granite-8b REDUCED, and minicpm3-4b REDUCED
for the mixed scenario, in f32, where token ids must agree exactly).

Both sides get the same weights (made by JAX, carried over through the
bridge) and the same clock.  Each scenario of tests/test_maas.py is written
once against a namespace of modules and must give, on both sides, the same
tokens for every request, the same ``FleetStats``, each tenant's
``TenantStats`` and ``RuntimeStats``, the same tenant states and the same
``ParameterPool`` invariant on every tick.  Ledger totals are compared with
``total()``, never the built-in ``sum()`` (ROADMAP C).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.autoscaler as j_autoscaler  # noqa: E402
import repro.core.topology as j_tp  # noqa: E402
import repro.obs.ledger as j_ledger  # noqa: E402
import repro.obs.slo as j_slo  # noqa: E402
import repro.serving.disagg.pools as j_pools  # noqa: E402
import repro.serving.maas as j_maas  # noqa: E402
import repro.workloads.traces as j_traces  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
import repro_torch.core.autoscaler as t_autoscaler  # noqa: E402
import repro_torch.core.topology as t_tp  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
import repro_torch.serving.disagg.pools as t_pools  # noqa: E402
import repro_torch.serving.maas as t_maas  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.serving import traces as t_serving_traces  # noqa: E402
from repro_torch.workloads import traces as t_traces  # noqa: E402

ARCHS = {"dense": "granite-8b", "mla": "minicpm3-4b"}


def _bridged(arch, seed):
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, reduced=True).replace(dtype=torch.float32)
    jparams = JTF.init_params(jax.random.PRNGKey(seed), jcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jcfg, jparams), (cfg, params)


@pytest.fixture(scope="module")
def sides():
    models = {kind: _bridged(arch, i) for i, (kind, arch) in enumerate(ARCHS.items())}
    jax_side = types.SimpleNamespace(
        models={k: v[0] for k, v in models.items()}, tp=j_tp, auto=j_autoscaler,
        maas=j_maas, P=j_pools, ledger=j_ledger, slo=j_slo)
    port_side = types.SimpleNamespace(
        models={k: v[1] for k, v in models.items()}, tp=t_tp, auto=t_autoscaler,
        maas=t_maas, P=t_pools, ledger=t_obs, slo=t_obs)
    return jax_side, port_side


def _model(s, name, kind="dense"):
    cfg, params = s.models[kind]
    return cfg.replace(name=name), params


def _add(s, fleet, name, kind="dense", **kw):
    """tests/test_maas.py::_fleet's seat for one model."""
    cfg, params = _model(s, name, kind)
    kw.setdefault("n_prefill", 1)
    kw.setdefault("n_decode", 1)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 48)
    kw.setdefault("model_bytes", int(50e6))
    kw.setdefault("prefill_capacity_tps", 200.0)
    kw.setdefault("decode_capacity_tps", 50.0)
    return fleet.add_model(cfg, params, **kw)


def _fleet(s, n_hosts=2, devs=4, fleet_policy=None, kinds=("dense", "dense"), **fleet_kw):
    topo = s.tp.add_host_sources(s.tp.make_cluster(n_hosts, devs, bw_gbps=100.0))
    fleet = s.maas.FleetScheduler(
        topo, policy=fleet_policy or s.maas.FleetPolicy(idle_to_zero_s=0.5), **fleet_kw)
    for name, kind in zip(("maas-a", "maas-b"), kinds):
        _add(s, fleet, name, kind,
             policy=s.auto.PolicyConfig(max_instances=3, kv_upper=0.5, scale_down_timeout_s=0.4))
    return topo, fleet


def _prompt(rng, s, size, kind="dense"):
    return rng.integers(0, s.models[kind][0].vocab_size, size=size).astype(np.int32)


def _tick(fleet, t, log):
    fleet.tick(t)
    ok = fleet.param_pool.invariant_ok()
    log.append(ok)
    assert ok


def _drain(fleet, t, log, *, tick=0.01, max_ticks=2000):
    for _ in range(max_ticks):
        if fleet.n_outstanding == 0:
            return t
        t += tick
        _tick(fleet, t, log)
    raise AssertionError(f"{fleet.n_outstanding} requests still outstanding")


def _result(fleet, log=(), **extra):
    """Everything the fleet decided, as plain data."""
    tenants = {}
    for name, t in sorted(fleet.tenants.items()):
        rt = t.runtime
        tenants[name] = {
            "state": t.state,
            "stats": dataclasses.asdict(t.stats),
            "runtime": dataclasses.asdict(rt.stats),
            "tokens": {rid: list(r.out_tokens) for rid, r in sorted(rt.completed.items())},
            "rejected": sorted(rt.rejected),
            "handoffs": rt.router.handoff_report(),
            "pool": sorted((pe.device_id, pe.phase, pe.state) for pe in rt.pool.all()),
            "allowed": sorted(rt.allowed_devices or ()),
        }
    return {
        "fleet": dataclasses.asdict(fleet.stats),
        "tenants": tenants,
        "free": sorted(fleet.free_devices()),
        "host_cache": fleet.param_pool.host_cache_bytes(),
        "invariant": list(log),
        **extra,
    }


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def lifecycle_serve_zero_cold_start(s):
    """tests/test_maas.py:60: serve, park both models at zero, cold-start one
    from the O(1) host copy."""
    topo, fleet = _fleet(s)
    log = []
    rng = np.random.default_rng(3)
    prompts_b = [_prompt(rng, s, 7) for _ in range(2)]
    t = 0.0
    for _ in range(4):
        fleet.submit("maas-a", _prompt(rng, s, 7), 5, t)
    for p in prompts_b:
        fleet.submit("maas-b", p, 5, t)
    t = _drain(fleet, t, log)
    for _ in range(300):
        t += 0.05
        _tick(fleet, t, log)
        if all(x.state == s.maas.ZERO for x in fleet.tenants.values()):
            break
    at_zero = _result(fleet, spares=len(topo.spares()))
    assert all(x.state == s.maas.ZERO for x in fleet.tenants.values())
    fleet.submit("maas-b", prompts_b[0], 5, t)
    t = _drain(fleet, t, log)
    tb = fleet.tenants["maas-b"]
    assert tb.state == s.maas.ACTIVE and tb.runtime.stats.cold_starts_from_host >= 1
    return _result(fleet, log, at_zero=at_zero, t=t)


@scenario
def starved_model_preempts_idle_one(s):
    """tests/test_maas.py:115."""
    policy = s.maas.FleetPolicy(idle_to_zero_s=1e9)
    _, fleet = _fleet(s, n_hosts=1, devs=4, fleet_policy=policy)
    assert fleet.free_devices() == []
    log, engines_a = [], []
    rng = np.random.default_rng(5)
    t = 0.0
    for _ in range(10):
        fleet.submit("maas-a", _prompt(rng, s, 16), 6, t)
    for _ in range(2000):
        if fleet.n_outstanding == 0:
            break
        t += 0.01
        _tick(fleet, t, log)
        engines_a.append(fleet.tenants["maas-a"].runtime.n_engines)
    assert fleet.n_outstanding == 0 and fleet.stats.preemptions >= 1
    assert max(engines_a) > 2
    return _result(fleet, log, engines_a=engines_a)


@scenario
def half_seated_cold_start_recovers(s):
    """tests/test_maas.py:142."""
    topo = s.tp.add_host_sources(s.tp.make_cluster(1, 3, bw_gbps=100.0))
    fleet = s.maas.FleetScheduler(topo, policy=s.maas.FleetPolicy(idle_to_zero_s=0.3))
    _add(s, fleet, "maas-a",
         policy=s.auto.PolicyConfig(max_instances=2, kv_upper=0.5, scale_down_timeout_s=0.4))
    log = []
    rng = np.random.default_rng(9)
    t = 0.0
    fleet.submit("maas-a", _prompt(rng, s, 7), 4, t)
    t = _drain(fleet, t, log)
    while fleet.tenants["maas-a"].state != s.maas.ZERO:
        t += 0.05
        _tick(fleet, t, log)
    taken = [d.id for d in topo.spares()][1:]
    for i in taken:
        topo.device(i).role = s.tp.Role.PREFILL
    fleet.submit("maas-a", _prompt(rng, s, 7), 4, t)
    for _ in range(20):
        t += 0.01
        _tick(fleet, t, log)
    half = _result(fleet)
    assert fleet.tenants["maas-a"].runtime.n_engines == 1 and fleet.n_outstanding == 1
    for i in taken:
        topo.device(i).role = s.tp.Role.FREE
    t = _drain(fleet, t, log)
    return _result(fleet, log, half=half)


@scenario
def slo_class_weights_arbitration_priority(s):
    """tests/test_maas.py:189."""
    topo = s.tp.add_host_sources(s.tp.make_cluster(2, 4, bw_gbps=100.0))
    fleet = s.maas.FleetScheduler(topo)
    t_lat = _add(s, fleet, "maas-a", slo_class=s.maas.LATENCY)
    t_thr = _add(s, fleet, "maas-b", slo_class=s.maas.THROUGHPUT)
    rng = np.random.default_rng(2)
    for m in ("maas-a", "maas-b"):
        for _ in range(3):
            fleet.submit(m, _prompt(rng, s, 8), 4, 0.0)
    fleet.tick(0.05)
    fleet.tick(0.10)
    assert t_lat.priority() > t_thr.priority()
    return _result(fleet, weights=[t_lat.class_weight, t_thr.class_weight],
                   priorities=[t_lat.priority(), t_thr.priority()],
                   pressures=[t_lat.runtime.slo_pressure(), t_thr.runtime.slo_pressure()])


@scenario
def admission_control_sheds_lowest_class(s):
    """tests/test_maas.py:229."""
    topo = s.tp.add_host_sources(s.tp.make_cluster(1, 2, bw_gbps=100.0))
    fleet = s.maas.FleetScheduler(topo, policy=s.maas.FleetPolicy(
        idle_to_zero_s=1e9, saturation_pressure=0.0, shed_queue_depth=2))
    _add(s, fleet, "maas-a", slo_class=s.maas.THROUGHPUT,
         policy=s.auto.PolicyConfig(max_instances=1, kv_upper=0.5))
    log = []
    rng = np.random.default_rng(7)
    rids = [fleet.submit("maas-a", _prompt(rng, s, 8), 4, 0.0) for _ in range(10)]
    _drain(fleet, 0.0, log)
    rt = fleet.tenants["maas-a"].runtime
    assert fleet.stats.rejections >= 1
    assert sum(r in rt.completed for r in rids) + sum(r in rt.rejected for r in rids) == 10
    recs = {r: (rt.router.records[r].rejected, rt.router.records[r].rejected_at) for r in rids}
    return _result(fleet, log, records=recs)


@scenario
def placement_affinity_prefers_gpu_copy_leaves(s):
    """tests/test_maas.py:273."""
    topo = s.tp.add_host_sources(s.tp.make_cluster(2, 2, hosts_per_leaf=1, bw_gbps=100.0))
    fleet = s.maas.FleetScheduler(topo)
    t = _add(s, fleet, "maas-a", n_decode=0)
    first = fleet._rank_free_for(t, set(fleet.free_devices()))
    fleet.net.degrade_link(("dev_in", 2), 0.1)
    second = fleet._rank_free_for(t, set(fleet.free_devices()))
    assert first[0] == 1 and second == [1, 3, 2]
    return _result(fleet, ranked=[first, second])


def _inflight_scale(s, seed):
    """tests/test_maas.py::_fleet_with_inflight_scale."""
    topo = s.tp.add_host_sources(s.tp.make_cluster(3, 2, hosts_per_leaf=1, bw_gbps=100.0))
    fleet = s.maas.FleetScheduler(topo, policy=s.maas.FleetPolicy(idle_to_zero_s=1e9))
    _add(s, fleet, "maas-a", model_bytes=int(2e9), prefill_capacity_tps=50.0,
         decode_capacity_tps=20.0, policy=s.auto.PolicyConfig(max_instances=3, kv_upper=0.5))
    rt = fleet.tenants["maas-a"].runtime
    rng = np.random.default_rng(seed)
    now = 0.0
    for _ in range(12):
        fleet.submit("maas-a", _prompt(rng, s, 16), 6, now)
    loading = []
    for _ in range(400):
        now += 0.02
        fleet.tick(now)
        loading = [pe for pe in rt.pool.all() if pe.state == s.P.LOADING]
        if loading:
            break
    assert loading
    return topo, fleet, rt, loading, now


@scenario
def leaf_failure_mid_cold_start_regrants(s):
    """tests/test_maas.py:325."""
    topo, fleet, rt, loading, now = _inflight_scale(s, seed=1)
    doomed = sorted(pe.device_id for pe in loading)
    dead_leaf = topo.leaf_of(loading[0].device_id)
    fleet.net.fail_leaf(dead_leaf, now)
    after_event = _result(fleet)
    assert rt.stats.cancelled_scales == len(doomed) == fleet.stats.failure_regrants
    log = []
    for _ in range(6000):
        if fleet.n_outstanding == 0:
            break
        now += 0.02
        _tick(fleet, now, log)
    assert fleet.n_outstanding == 0 and rt.router.handoff_report()[1] == 0
    return _result(fleet, log, doomed=doomed, dead_leaf=dead_leaf, after_event=after_event)


@scenario
def failure_not_double_handled(s):
    """tests/test_maas.py:360."""
    topo, fleet, rt, loading, now = _inflight_scale(s, seed=2)
    doomed = sorted(pe.device_id for pe in loading)
    fleet.net.fail_leaf(topo.leaf_of(loading[0].device_id), now)
    after_event = _result(fleet)
    for _ in range(3):
        now += 0.02
        fleet.tick(now)
    before = _result(fleet)
    fleet.net.fail_device(doomed[0], now)
    assert _result(fleet) == before  # a repeated failure is a no-op
    assert fleet.stats.failure_regrants == rt.stats.cancelled_scales == len(doomed)
    return _result(fleet, doomed=doomed, after_event=after_event)


@scenario
def fleet_rejects_overcommitted_seating(s):
    """tests/test_maas.py:407."""
    topo = s.tp.add_host_sources(s.tp.make_cluster(1, 2, bw_gbps=100.0))
    fleet = s.maas.FleetScheduler(topo)
    _add(s, fleet, "maas-a")
    with pytest.raises(ValueError, match="free") as err:
        _add(s, fleet, "maas-b")
    return _result(fleet, error=str(err.value))


@scenario
def ledger_and_slo_monitor_attached(s):
    """tests/test_ledger.py::fleet_ledger_run: a DeviceTimeLedger and an
    SLOMonitor on the fleet; the SLO-aware tie-break reads the monitor."""
    led = s.ledger.DeviceTimeLedger()
    slo = s.slo.SLOMonitor(ttft_slo_s=2.0, tbt_slo_s=1.0)
    _, fleet = _fleet(s, ledger=led, slo_monitor=slo)
    log = []
    rng = np.random.default_rng(3)
    t = 0.0
    for _ in range(4):
        fleet.submit("maas-a", _prompt(rng, s, 7), 5, t)
    fleet.submit("maas-b", _prompt(rng, s, 7), 5, t)
    t = _drain(fleet, t, log)
    for _ in range(100):
        t += 0.05
        _tick(fleet, t, log)
    assert led.breakdown()["draining"] > 0
    return _result(
        fleet, log, total=led.total(), breakdown=led.breakdown(), owners=led.owners(),
        owner_totals={o: led.owner_breakdown(o) for o in led.owners()},
        utilization=led.utilization(), health=fleet.fleet_health())


@scenario
def mixed_dense_and_mla_tenants(s):
    """A dense GQA tenant and an MLA tenant on one fleet, through a full
    serve -> zero -> cold start cycle of the MLA tenant."""
    _, fleet = _fleet(s, kinds=("dense", "mla"))
    log = []
    rng = np.random.default_rng(11)
    t = 0.0
    for i in range(3):
        fleet.submit("maas-a", _prompt(rng, s, 7 + i), 5, t)
        fleet.submit("maas-b", _prompt(rng, s, 6 + i, "mla"), 4, t)
    t = _drain(fleet, t, log)
    while fleet.tenants["maas-b"].state != s.maas.ZERO:
        t += 0.05
        _tick(fleet, t, log)
    fleet.submit("maas-b", _prompt(rng, s, 9, "mla"), 5, t)
    t = _drain(fleet, t, log)
    assert fleet.tenants["maas-b"].runtime.stats.cold_starts >= 1
    return _result(fleet, log, t=t)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_fleet_equals_jax_fleet(sides, name):
    jax_side, port_side = sides
    want = SCENARIOS[name](jax_side)
    got = SCENARIOS[name](port_side)
    assert got == want


# ---------------------------------------------------------------------------
# Traces: the same mixes for the same seed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [None, {"a": "burstgpt", "b": "azure_conv", "c": "azure_code"}],
                         ids=["default", "mixed"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_multi_model_mix_equals_jax(seed, kind):
    kw = dict(duration=60.0, total_rate=3.0, seed=seed)
    if kind is not None:
        kw["kind"] = kind
    want = j_traces.multi_model_mix(["a", "b", "c"], **kw)
    got = t_traces.multi_model_mix(["a", "b", "c"], **kw)
    assert got == want
    assert t_serving_traces.multi_model_mix is t_traces.multi_model_mix


@pytest.mark.parametrize("n,alpha", [(1, 1.2), (3, 1.2), (4, 0.8), (6, 2.0)])
def test_zipf_weights_equal_jax(n, alpha):
    np.testing.assert_array_equal(t_traces.zipf_weights(n, alpha=alpha),
                                  j_traces.zipf_weights(n, alpha=alpha))


@pytest.mark.parametrize("name", ["burstgpt", "azure_code", "azure_conv"])
def test_single_traces_equal_jax(name):
    want = getattr(j_traces, name)(duration=120.0, seed=4)
    got = getattr(t_traces, name)(duration=120.0, seed=4)
    assert got == want
    assert t_traces.kv_volumes(got, 4096) == j_traces.kv_volumes(want, 4096)
