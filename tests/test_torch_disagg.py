"""The port's PD-disaggregated runtime on torch engines against the JAX
runtime on JAX engines (granite-8b REDUCED in f32, where token ids must agree
exactly).

Both sides get the same weights (made by JAX, carried over through the
bridge) and the same simulated clock (``t += 0.01`` per tick, as in
tests/test_disagg.py).  Each scenario of tests/test_disagg.py is written once
against a namespace of modules and must give, on both sides, the same tokens
for every request, the same ``RuntimeStats`` and the same handoff report.
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
import repro.serving.disagg as j_disagg  # noqa: E402
import repro.serving.disagg.pools as j_pools  # noqa: E402
import repro.serving.engine as j_engine  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
import repro_torch.core.autoscaler as t_autoscaler  # noqa: E402
import repro_torch.core.topology as t_tp  # noqa: E402
import repro_torch.serving.disagg as t_disagg  # noqa: E402
import repro_torch.serving.disagg.pools as t_pools  # noqa: E402
import repro_torch.serving.engine as t_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

JCFG = jax_get_config("granite-8b", reduced=True).replace(dtype=jnp.float32)
CFG = get_config("granite-8b", reduced=True).replace(dtype=torch.float32)


@pytest.fixture(scope="module")
def sides():
    jparams = JTF.init_params(jax.random.PRNGKey(0), JCFG)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jax_side = types.SimpleNamespace(
        cfg=JCFG, params=jparams, tp=j_tp, auto=j_autoscaler, disagg=j_disagg, P=j_pools,
        engine=j_engine)
    port_side = types.SimpleNamespace(
        cfg=CFG, params=params, tp=t_tp, auto=t_autoscaler, disagg=t_disagg, P=t_pools,
        engine=t_engine)
    return jax_side, port_side


def _runtime(s, **kw):
    """tests/test_disagg.py::_runtime."""
    kw.setdefault("topo", s.tp.add_host_sources(s.tp.make_cluster(2, 4, bw_gbps=100.0)))
    kw.setdefault(
        "policy", s.auto.PolicyConfig(max_instances=4, kv_upper=0.5, scale_down_timeout_s=0.4))
    kw.setdefault("n_prefill", 2)
    kw.setdefault("n_decode", 1)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 48)
    kw.setdefault("prefill_capacity_tps", 200.0)
    kw.setdefault("decode_capacity_tps", 50.0)
    kw.setdefault("model_bytes", int(50e6))
    return s.disagg.ClusterRuntime(s.cfg, s.params, **kw)


def _run(rt, t=0.0, max_ticks=800, on_tick=None):
    for _ in range(max_ticks):
        if rt.n_outstanding == 0:
            break
        t += 0.01
        rt.tick(t)
        if on_tick is not None:
            on_tick(rt)
    assert rt.n_outstanding == 0
    return t


def _result(rt, **extra):
    return {
        "tokens": {rid: list(r.out_tokens) for rid, r in sorted(rt.completed.items())},
        "stats": dataclasses.asdict(rt.stats),
        "handoffs": rt.router.handoff_report(),
        "pool": sorted((pe.device_id, pe.phase, pe.state) for pe in rt.pool.all()),
        **extra,
    }


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def tokens_match_colocated_reference(s):
    """tests/test_disagg.py:64: every request's tokens equal a lone engine's."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, s.cfg.vocab_size, size=7).astype(np.int32) for _ in range(4)]
    rt = _runtime(s)
    rids = [rt.submit(p, 5, 0.0) for p in prompts]
    _run(rt, max_ticks=500)
    ref_eng = s.engine.InstanceEngine(s.cfg, s.params, n_slots=1, max_seq=32)
    refs = []
    for rid, prompt in zip(rids, prompts):
        ref_eng.submit(s.engine.ServeRequest(100 + rid, prompt, 5))
        (ref,) = ref_eng.run_until_done()
        assert rt.completed[rid].out_tokens == ref.out_tokens
        refs.append(list(ref.out_tokens))
    return _result(rt, refs=refs)


@scenario
def no_dropped_or_gapped_tokens(s):
    """tests/test_disagg.py:87."""
    rt = _runtime(s)
    rng = np.random.default_rng(1)
    n = 6
    for _ in range(n):
        rt.submit(rng.integers(0, s.cfg.vocab_size, size=8).astype(np.int32), 4, 0.0)
    _run(rt, max_ticks=500)
    handoffs, gapped = rt.router.handoff_report()
    assert handoffs == rt.stats.migrations == n and gapped == 0
    assert all(len(r.out_tokens) == r.max_new_tokens for r in rt.completed.values())
    return _result(rt)


@scenario
def decode_pressure_mutates_prefill(s):
    """tests/test_disagg.py:174: decode pressure mutates a prefill instance
    and live-scales a replacement, which goes through the loading ramp."""
    rt = _runtime(s, n_slots=2)
    rng = np.random.default_rng(2)
    for _ in range(8):
        rt.submit(rng.integers(0, s.cfg.vocab_size, size=16).astype(np.int32), 6, 0.0)
    seen = []

    def watch(rt):
        seen.append(any(pe.state == s.P.LOADING and pe.phase == s.P.PREFILL
                        for pe in rt.pool.all()))
        # every pooled engine computes with the runtime's own parameters
        assert all(pe.engine.params is rt.params for pe in rt.pool.all())

    _run(rt, on_tick=watch)
    assert rt.stats.mutations >= 1 and rt.stats.mutation_param_bytes == 0
    assert rt.stats.live_scaled_prefill >= 1 and any(seen)
    assert rt.router.handoff_report()[1] == 0
    return _result(rt, loading_ticks=[i for i, v in enumerate(seen) if v])


@scenario
def failed_nic_replans_elsewhere(s):
    """tests/test_disagg.py:219: a NIC failure mid-live-scale is torn down
    and re-planned inside the failure event."""
    rt = _runtime(s, topo=s.tp.add_host_sources(s.tp.make_cluster(5, 1, bw_gbps=100.0)),
                  model_bytes=int(500e6))
    t = 0.01
    rt.tick(t)
    pe = rt._live_scale(s.P.PREFILL, t)
    assert pe is not None and pe.state == s.P.LOADING
    target = pe.device_id
    assert rt.net.flows_into(target)
    rt.net.fail_device(target, t + 0.01)
    after_event = _result(rt)
    assert rt.stats.aborted_param_streams == 1 and rt.stats.cancelled_scales == 1
    assert rt.stats.failure_replans == 1
    repl = [p for p in rt.pool.all() if p.state == s.P.LOADING]
    assert len(repl) == 1 and repl[0].device_id != target
    rt.tick(t + 0.02)
    return _result(rt, target=target, after_event=after_event,
                   dead=sorted(rt.net.dead_devices()))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_runtime_equals_jax_runtime(sides, name):
    jax_side, port_side = sides
    want = SCENARIOS[name](jax_side)
    got = SCENARIOS[name](port_side)
    assert got == want


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_payload_bytes_equal_jax(dt):
    """The port's 1-slot cache has the JAX cache's leaves (k, v, int32
    lengths), so the migrated volume is the same count."""
    jcfg = JCFG.replace(dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dt])
    cfg = CFG.replace(dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dt])
    jone = JTF.init_caches(jcfg, 1, 32)
    one = TF.init_caches(cfg, 1, 32, device="cpu")
    for prompt_len in (8, 16):
        got = t_disagg.payload_bytes(one, prompt_len, 32)
        assert got == j_disagg.payload_bytes(jone, prompt_len, 32) > 0
    assert t_disagg.payload_bytes(one, 16, 32) == 2 * t_disagg.payload_bytes(one, 8, 32)


def test_payload_of_a_prefill_is_its_cache(sides):
    """make_payload on the engine's own 1-slot cache counts its tensors."""
    _, s = sides
    eng = s.engine.InstanceEngine(s.cfg, s.params, n_slots=2, max_seq=32)
    req = s.engine.ServeRequest(1, np.arange(9, dtype=np.int32), 4)
    first, one = eng.prefill_only(req)
    p = t_disagg.kv_migration.make_payload(req, first, one, max_seq=32, src_dev=0, dst_dev=1)
    total = sum(t.numel() * t.element_size() for t in one["layers"].values())
    assert p.total_bytes == int(total * 9 / 32) and p.n_pages == 1
    assert p.tokens_at_freeze == [first] and p.tokens_at_freeze is not req.out_tokens


def test_every_engine_shares_the_runtimes_params(sides):
    """One parameter dict for the whole pool, live-scaled engines included:
    at full width a copy per engine would not fit on the card."""
    _, s = sides
    rt = _runtime(s, n_slots=2)
    assert rt.params is s.params
    rng = np.random.default_rng(2)
    for _ in range(8):
        rt.submit(rng.integers(0, s.cfg.vocab_size, size=16).astype(np.int32), 6, 0.0)
    engines = set()

    def collect(rt):
        engines.update(id(pe.engine) for pe in rt.pool.all())
        assert all(pe.engine.params is s.params for pe in rt.pool.all())

    _run(rt, on_tick=collect)
    assert len(engines) > 3  # the live-scaled engines were checked too
