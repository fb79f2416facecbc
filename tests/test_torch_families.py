"""The port's MoE, SSM and hybrid families (olmoe-1b-7b, mamba2-370m,
zamba2-2.7b) and the two largest reference archs (grok-1-314b, MoE with 8
SwiGLU experts top-2 in dispatch groups of 512; nemotron-4-340b, dense with
a squared-ReLU MLP, n_rep 3 at REDUCED), all REDUCED, against the JAX
package, in f32 where token ids must agree exactly.

Weights are made by the JAX init and carried over through the bridge.  Per
arch: prefill + decode token ids and caches (1e-4 of each tensor's scale,
sums in another order) equal to JAX's, through the direct ``decode_step``
(olmoe and zamba2 keep their ``uniform_decode``); prefill(S) + decode equal
to prefill(S + 1) (tests/test_models.py:48); the split forward against JAX's at every k
(2e-2, tests/test_live_scaling.py:18-33) and bit-equal to the port's own
monolithic forward; the engine with slots that live and die against the JAX
engine, exactly (the MoE archs' free slots compete for expert capacity with
their stale tokens, as in the reference); a disagg runtime scenario for the SSM
archs against the JAX runtime.  Also the lockstep appends against JAX's and
the migrated payload of SSM and hybrid caches.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.autoscaler as j_autoscaler  # noqa: E402
import repro.core.topology as j_tp  # noqa: E402
import repro.serving.disagg as j_disagg  # noqa: E402
import repro.serving.engine as j_engine  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.live_scaling import cooperative_forward as jax_coop  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
import repro_torch.core.autoscaler as t_autoscaler  # noqa: E402
import repro_torch.core.topology as t_tp  # noqa: E402
import repro_torch.serving.disagg as t_disagg  # noqa: E402
import repro_torch.serving.engine as t_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.live_scaling import cooperative_forward  # noqa: E402
from repro_torch.models import bridge, kvcache  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

ARCHS = ["olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b", "grok-1-314b", "nemotron-4-340b"]
F32_TOL = dict(atol=1e-4, rtol=1e-4)
SPLIT_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_live_scaling.py:29-33


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, reduced=True).replace(dtype=torch.float32)
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _flat(tree, path=()):
    """A nested dict's leaves by key path."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
    elif np.asarray(want).dtype.kind == "i":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)
    else:
        # 1e-4 of the tensor's scale: with the reference's init law the SSM
        # state h of a 2-layer cut reaches ~2.5e3, where sums in another
        # order differ by ~3e-6 of that
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=path,
                                   atol=F32_TOL["atol"] * scale, rtol=F32_TOL["rtol"])


# ---------------------------------------------------------------------------
# Templates and caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_templates_and_caches_match_jax(arch):
    """Parameter tree, cache tree (shapes and dtypes) and the number of
    live-scaling blocks equal the JAX ones, full and REDUCED."""
    for reduced in (True, False):
        jcfg, cfg = jax_get_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
        jt, tt = _flat(JTF.param_template(jcfg)), _flat(TF.param_template(cfg))
        assert jt.keys() == tt.keys()
        for key, spec in jt.items():
            assert tt[key].shape == spec.shape and tt[key].init == spec.init, key
        assert TF.n_layer_blocks(cfg) == JTF.n_layer_blocks(jcfg)
    jcfg, _, cfg, _ = _models(arch)
    flat_j = _flat(JTF.init_caches(jcfg, 2, 24))
    flat_t = _flat(TF.init_caches(cfg, 2, 24, device="cpu"))
    assert flat_j.keys() == flat_t.keys()
    for key, a in flat_j.items():
        assert tuple(flat_t[key].shape) == a.shape, key
        assert str(flat_t[key].dtype).split(".")[-1] == str(a.dtype), key


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_f32(arch):
    """Token ids equal over a 10-token prompt and 6 steps (two sequences);
    caches equal after the prefill and after every step."""
    jcfg, jparams, cfg, params = _models(arch)
    b, s, max_seq = 2, 10, 24
    toks = _tokens(cfg, b, s)
    jc = JTF.init_caches(jcfg, b, max_seq)
    caches = TF.init_caches(cfg, b, max_seq, device="cpu")
    jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), jc)
    nxt, caches = TF.prefill(cfg, params, torch.from_numpy(toks), caches)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    _assert_tree_close(caches, jc)
    for _ in range(6):
        jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
        nxt, caches = TF.decode_step(cfg, params, nxt, caches)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        _assert_tree_close(caches, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill(arch):
    """prefill(S) then one decode step of token S gives the token that
    prefill(S + 1) gives (tests/test_models.py:48, which runs the SSM and
    hybrid archs), and both sides equal JAX's.  The MoE archs are held to
    JAX only: their expert capacity scales with the tokens routed together,
    so a one-token step drops other choices than a prefill of S + 1 tokens."""
    jcfg, jparams, cfg, params = _models(arch)
    b, s = 2, 12
    toks = _tokens(cfg, b, s + 1, seed=2)
    caches = TF.init_caches(cfg, b, s + 8, device="cpu")
    _, caches = TF.prefill(cfg, params, torch.from_numpy(toks[:, :s]), caches)
    inc, _ = TF.decode_step(cfg, params, torch.from_numpy(toks[:, s]), caches)
    full, _ = TF.prefill(cfg, params, torch.from_numpy(toks), TF.init_caches(cfg, b, s + 8, device="cpu"))
    _, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks[:, :s]), JTF.init_caches(jcfg, b, s + 8))
    jinc, _ = JTF.decode_step(jcfg, jparams, jnp.asarray(toks[:, s]), jc)
    jfull, _ = JTF.prefill(jcfg, jparams, jnp.asarray(toks), JTF.init_caches(jcfg, b, s + 8))
    np.testing.assert_array_equal(inc.numpy(), np.asarray(jinc))
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    if cfg.family != "moe":
        np.testing.assert_array_equal(inc.numpy(), full.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_live_split_matches_jax_at_every_k(arch):
    """cooperative_forward at every k in [0, L]: equal to JAX's at 2e-2, and
    bit-equal to the port's monolithic forward (the hybrid's shared block
    runs on both sides of the split).  The MoE aux loss comes back too."""
    jcfg, jparams, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, 9, seed=3)
    full, aux = TF.train_forward(cfg, params, torch.from_numpy(toks))
    jfull, jaux = JTF.train_forward(jcfg, jparams, jnp.asarray(toks))
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    for k in range(cfg.n_layers + 1):
        got = cooperative_forward(cfg, params, torch.from_numpy(toks), k)
        assert torch.equal(got, full), k
        want = jax_coop(jcfg, jparams, jnp.asarray(toks), k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SPLIT_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfull), **SPLIT_TOL)


def test_hybrid_shared_block_runs_at_its_sites():
    """Without the shared block the split forward differs; with it, each
    site uses the one shared parameter set and its own cache."""
    _, _, cfg, params = _models("zamba2-2.7b")
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=4))
    x = TF._embed(cfg, params, toks)
    pos = TF._positions(toks)
    with_shared = TF.forward_layers_range(cfg, params["layers"], x, 0, cfg.n_layers, pos,
                                          params["shared"])
    without = TF.forward_layers_range(cfg, params["layers"], x, 0, cfg.n_layers, pos)
    assert not torch.allclose(with_shared, without)
    caches = TF.init_caches(cfg, 1, 16, device="cpu")
    assert caches["shared"]["k"].shape[0] == cfg.n_layers // cfg.attn_every == 2
    TF.prefill(cfg, params, toks, caches)
    assert caches["shared"]["lengths"].tolist() == [[6], [6]]
    assert not torch.equal(caches["shared"]["k"][0], caches["shared"]["k"][1])


# ---------------------------------------------------------------------------
# Engine and runtimes
# ---------------------------------------------------------------------------


def _serve(engine, req_cls, prompts, new_tokens):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(i, p, new_tokens[i]))
    done = engine.run_until_done()
    assert len(done) == len(prompts)
    return {r.rid: r.out_tokens for r in done}


@pytest.mark.parametrize("new", [[3, 5, 7, 3, 5], [1, 10, 10, 1, 1]],
                         ids=["staggered", "free_slots_first"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, new):
    """Five requests on three slots: queueing, slot reuse, two prompt
    lengths and staggered finishes, so slots live and die.  For olmoe each
    decode step routes 3 rows x top-2 into experts of capacity 1, and the
    earlier row wins a contested slot, so a free slot ahead of the live ones
    ("free_slots_first": slot 0 frees after one token) takes capacity from
    them with its stale token, as in the JAX engine.  (A port that left the
    free rows out of the append and the attention gives other tokens here.)"""
    jcfg, jparams, cfg, params = _models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=6 + 2 * (i % 2)).astype(np.int32)
               for i in range(5)]
    want = _serve(j_engine.InstanceEngine(jcfg, jparams, n_slots=3, max_seq=32),
                  j_engine.ServeRequest, prompts, new)
    got = _serve(t_engine.InstanceEngine(cfg, params, n_slots=3, max_seq=32),
                 t_engine.ServeRequest, prompts, new)
    assert got == want


def test_moe_free_slots_keep_their_lengths():
    """olmoe's free rows append and attend like live ones (they compete for
    capacity), then get their lengths back; of their K/V rows only the entry
    at that length changes, and the next step rewrites it before reading it,
    so their stale tokens stay as they were."""
    _, _, cfg, params = _models("olmoe-1b-7b")
    eng = t_engine.InstanceEngine(cfg, params, n_slots=3, max_seq=32)
    eng.submit(t_engine.ServeRequest(0, np.arange(5, dtype=np.int32), 4))
    eng.step()
    free = [s for s in range(3) if s not in eng.active]
    layers = eng.caches["layers"]
    before = {k: v[:, free].clone() for k, v in layers.items()}
    tokens = eng.last_tokens[free].clone()
    for _ in range(2):
        eng.step()
        assert torch.equal(layers["lengths"][:, free], before["lengths"])
        assert torch.equal(eng.last_tokens[free], tokens)
        for j, slot in enumerate(free):
            for name in ("k", "v"):
                pos = before["lengths"][:, j].long()  # (L,)
                other = torch.ones(layers[name].shape[3], dtype=torch.bool)
                other[pos.unique()] = False
                assert torch.equal(layers[name][:, slot, :, other],
                                   before[name][:, j, :, other]), name


def _runtime(s):
    """tests/test_disagg.py::_runtime."""
    return s.disagg.ClusterRuntime(
        s.cfg, s.params, topo=s.tp.add_host_sources(s.tp.make_cluster(2, 4, bw_gbps=100.0)),
        policy=s.auto.PolicyConfig(max_instances=4, kv_upper=0.5, scale_down_timeout_s=0.4),
        n_prefill=2, n_decode=1, n_slots=2, max_seq=48, prefill_capacity_tps=200.0,
        decode_capacity_tps=50.0, model_bytes=int(50e6))


def _disagg_run(s):
    """Eight 16-token requests of 6 tokens (tests/test_disagg.py:174's load):
    decode pressure mutates a prefill instance; every request is migrated."""
    rt = _runtime(s)
    rng = np.random.default_rng(2)
    for _ in range(8):
        rt.submit(rng.integers(0, s.cfg.vocab_size, size=16).astype(np.int32), 6, 0.0)
    t = 0.0
    for _ in range(800):
        if rt.n_outstanding == 0:
            break
        t += 0.01
        rt.tick(t)
    assert rt.n_outstanding == 0
    return {
        "tokens": {rid: list(r.out_tokens) for rid, r in sorted(rt.completed.items())},
        "stats": dataclasses.asdict(rt.stats),
        "handoffs": rt.router.handoff_report(),
        "pool": sorted((pe.device_id, pe.phase, pe.state) for pe in rt.pool.all()),
    }


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_disagg_runtime_matches_jax(arch):
    """The SSM state (and the hybrid's shared caches) migrate prefill ->
    decode: tokens, RuntimeStats (migrated bytes included), handoffs and
    the pool equal the JAX runtime's."""
    jcfg, jparams, cfg, params = _models(arch)
    jax_side = types.SimpleNamespace(cfg=jcfg, params=jparams, tp=j_tp, auto=j_autoscaler,
                                     disagg=j_disagg)
    port_side = types.SimpleNamespace(cfg=cfg, params=params, tp=t_tp, auto=t_autoscaler,
                                      disagg=t_disagg)
    want = _disagg_run(jax_side)
    got = _disagg_run(port_side)
    assert got == want
    handoffs, gapped = got["handoffs"]
    assert handoffs == got["stats"]["migrations"] == 8 and gapped == 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b", "olmoe-1b-7b"])
def test_payload_bytes_equal_jax(arch, dt):
    """payload_bytes walks the whole cache tree: an SSM state (conv, f32 h)
    and a hybrid's per-site shared caches count as the JAX ones do."""
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jd)
    cfg = get_config(arch, reduced=True).replace(dtype=td)
    jone, one = JTF.init_caches(jcfg, 1, 32), TF.init_caches(cfg, 1, 32, device="cpu")
    for prompt_len in (8, 16):
        assert t_disagg.payload_bytes(one, prompt_len, 32) == j_disagg.payload_bytes(jone, prompt_len, 32) > 0


# ---------------------------------------------------------------------------
# Lockstep appends
# ---------------------------------------------------------------------------


def _kv_cache(lengths, smax=8):
    rng = np.random.default_rng(9)
    b = len(lengths)
    k = rng.standard_normal((b, 2, smax, 4)).astype(np.float32)
    v = rng.standard_normal((b, 2, smax, 4)).astype(np.float32)
    kn = rng.standard_normal((b, 2, 4)).astype(np.float32)
    vn = rng.standard_normal((b, 2, 4)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "lengths": jnp.asarray(ln)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "lengths": torch.from_numpy(ln.copy())}
    return jc, tc, kn, vn


def _mla_cache(lengths, smax=8):
    rng = np.random.default_rng(10)
    b = len(lengths)
    c = rng.standard_normal((b, smax, 6)).astype(np.float32)
    r = rng.standard_normal((b, smax, 2)).astype(np.float32)
    cn = rng.standard_normal((b, 6)).astype(np.float32)
    rn = rng.standard_normal((b, 2)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    jc = {"ckv": jnp.asarray(c), "krope": jnp.asarray(r), "lengths": jnp.asarray(ln)}
    tc = {"ckv": torch.from_numpy(c.copy()), "krope": torch.from_numpy(r.copy()),
          "lengths": torch.from_numpy(ln.copy())}
    return jc, tc, cn, rn


def _assert_same(got: dict, want: dict):
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("lengths", [[5, 3, 7], [8, 2, 1], [0, 0, 0]],
                         ids=["stragglers", "full_max_clamped", "empty"])
def test_append_kv_uniform_matches_jax(lengths):
    """Every row writes at the largest length (clamped into the cache as
    dynamic_update_slice clamps it), every length grows by one."""
    jc, tc, kn, vn = _kv_cache(lengths)
    want = JKV.append_kv_uniform(jc, jnp.asarray(kn), jnp.asarray(vn))
    got = kvcache.append_kv_uniform(tc, torch.from_numpy(kn), torch.from_numpy(vn))
    _assert_same(got, want)


@pytest.mark.parametrize("lengths", [[5, 3, 7], [8, 2, 1]], ids=["stragglers", "full_max_clamped"])
def test_append_mla_uniform_matches_jax(lengths):
    jc, tc, cn, rn = _mla_cache(lengths)
    want = JKV.append_mla_uniform(jc, jnp.asarray(cn), jnp.asarray(rn))
    got = kvcache.append_mla_uniform(tc, torch.from_numpy(cn), torch.from_numpy(rn))
    _assert_same(got, want)


def test_uniform_appends_equal_masked_appends_at_equal_lengths():
    """tests/test_moe_dispatch.py:125: with equal lengths the lockstep and
    the per-row appends are bit-identical (GQA and MLA)."""
    _, a, kn, vn = _kv_cache([5, 5, 5])
    _, b, _, _ = _kv_cache([5, 5, 5])
    kvcache.append_kv(a, torch.from_numpy(kn), torch.from_numpy(vn))
    kvcache.append_kv_uniform(b, torch.from_numpy(kn), torch.from_numpy(vn))
    for name in a:
        assert torch.equal(a[name], b[name]), name
    _, a, cn, rn = _mla_cache([4, 4])
    _, b, _, _ = _mla_cache([4, 4])
    kvcache.append_mla(a, torch.from_numpy(cn), torch.from_numpy(rn))
    kvcache.append_mla_uniform(b, torch.from_numpy(cn), torch.from_numpy(rn))
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_uniform_append_leaves_rows_that_are_not_live():
    _, tc, kn, vn = _kv_cache([5, 3, 7])
    before = {k: v.clone() for k, v in tc.items()}
    live = torch.tensor([True, False, True])
    kvcache.append_kv_uniform(tc, torch.from_numpy(kn), torch.from_numpy(vn), live)
    assert tc["lengths"].tolist() == [6, 3, 8]
    assert torch.equal(tc["k"][1], before["k"][1]) and torch.equal(tc["v"][1], before["v"][1])
    assert torch.equal(tc["k"][0, :, 7], torch.from_numpy(kn[0]))
