"""The port's MLA path (minicpm3-4b) against the JAX package, on minicpm3-4b
REDUCED (2 layers, qk head dim 24).

Weights are made by the JAX package and carried over through the bridge.
f32: token ids equal exactly, activations, logits and caches at 1e-4 (sums
taken in another order); bf16: logits at 2e-2 against the JAX model run op by
op (``jax.disable_jit()``; see tests/test_torch_model.py).  Prefill reaches
the flash kernel's plain version through ``ops.flash_attention`` at head dim
24 with V zero-padded from 16, as ``mla_prefill`` calls it on the card.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.live_scaling import cooperative_forward as jax_coop  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.layers import vocab_mask_logits as jax_vocab_mask  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving.disagg import kv_migration as jax_kvm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.live_scaling import cooperative_forward  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import bridge, kvcache  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serving.disagg import kv_migration as kvm  # noqa: E402
from repro_torch.serving.engine import InstanceEngine, ServeRequest  # noqa: E402

CPU = "cpu"
ARCH = "minicpm3-4b"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_live_scaling.py:29-33


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(dt, seed=0):
    jd, td = DTYPES[dt]
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype=jd)
    cfg = get_config(ARCH, reduced=True).replace(dtype=td)
    jparams = JTF.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, cfg, bridge.params_from_numpy(_np_tree(jparams), device=CPU)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _op_by_op(dt):
    return jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _assert_caches_close(got: dict, want: dict, tol=F32_TOL):
    assert got.keys() == want.keys()
    for name in got:
        if name == "lengths":
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        else:
            np.testing.assert_allclose(_f32(got[name]), _f32(want[name]), **tol)


# ---------------------------------------------------------------------------
# Config and template
# ---------------------------------------------------------------------------


def test_mla_template_matches_jax():
    jcfg, _, cfg, _ = _models("f32")
    tt = TF.init_params(cfg, 0, device=CPU)

    def shapes(tree, conv):
        if isinstance(tree, dict):
            return {k: shapes(v, conv) for k, v in tree.items()}
        return conv(tree)

    want = shapes(JTF.param_template(jcfg), lambda spec: tuple(spec.shape))
    assert shapes(tt, lambda t: tuple(t.shape)) == want
    assert set(tt["layers"]["attn"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv", "wo"}
    # the reference's init law with its stacked fan-in: std 1/sqrt(n_layers)
    full = get_config(ARCH).replace(n_layers=62)
    spec = TF.param_template(full)["layers"]["attn"]["w_dq"]
    assert spec.shape == (62, 2560, 768)
    w = TF.init_params(cfg.replace(n_layers=16), 0, device=CPU)["layers"]["attn"]["w_uq"]
    assert abs(w.std().item() - 1 / np.sqrt(16)) < 0.02
    assert torch.equal(tt["layers"]["attn"]["q_norm"], torch.ones_like(tt["layers"]["attn"]["q_norm"]))


def test_bridge_carries_the_mla_leaves_unchanged():
    _, jparams, _, params = _models("bf16")
    for name, leaf in jparams["layers"]["attn"].items():
        got = params["layers"]["attn"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(_f32(got), np.asarray(leaf, np.float32))


# ---------------------------------------------------------------------------
# The attention functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_prefill_and_decode_match_jax(dt):
    """One layer's ``mla_prefill`` then two ``mla_decode`` steps against
    ``repro.models.attention``, outputs and caches compared leaf by leaf."""
    jcfg, jparams, cfg, params = _models(dt, seed=2)
    jlp, lp = _layer0(jparams["layers"]["attn"]), TF.layer_slice(params["layers"]["attn"], 0)
    rng = np.random.default_rng(3)
    b, s, max_seq = 2, 9, 16
    jd, td = DTYPES[dt]
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    tol = F32_TOL if dt == "f32" else BF16_TOL

    jcache = JKV.init_mla_cache(b, max_seq, jcfg.kv_lora_rank, jcfg.qk_rope_dim, jd)
    cache = kvcache.init_mla_cache(b, max_seq, cfg.kv_lora_rank, cfg.qk_rope_dim, td, device=CPU)
    with _op_by_op(dt):
        jout, jcache = JA.mla_prefill(jlp, jnp.asarray(x, jd), jnp.asarray(pos), jcfg, cache=jcache)
    out, cache = TA.mla_prefill(lp, torch.from_numpy(x).to(td), torch.from_numpy(pos.copy()), cfg,
                                cache=cache)
    np.testing.assert_allclose(_f32(out), _f32(jout), **tol)
    _assert_caches_close(cache, jcache, tol)

    for step in range(2):
        xd = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        with _op_by_op(dt):
            jout, jcache = JA.mla_decode(jlp, jnp.asarray(xd, jd), jcfg, jcache)
        out, cache = TA.mla_decode(lp, torch.from_numpy(xd).to(td), cfg, cache)
        np.testing.assert_allclose(_f32(out), _f32(jout), **tol)
        _assert_caches_close(cache, jcache, tol)
    assert cache["lengths"].tolist() == [s + 2] * b


def test_append_mla_never_writes_a_free_or_full_slot():
    """Row 0 is full, row 1 live, row 2 free: only row 1 is written, and its
    result equals the reference's masked ``where``."""
    cache = kvcache.init_mla_cache(3, 4, 6, 2, torch.float32, device=CPU)
    cache["lengths"].copy_(torch.tensor([4, 1, 2], dtype=torch.int32))
    jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}  # no aliasing
    c_new = np.arange(18, dtype=np.float32).reshape(3, 6) + 1
    kr_new = -np.arange(6, dtype=np.float32).reshape(3, 2) - 1
    kvcache.append_mla(cache, torch.from_numpy(c_new), torch.from_numpy(kr_new),
                       live=torch.tensor([True, True, False]))
    assert cache["lengths"].tolist() == [5, 2, 2]  # live rows grow, as in the reference
    assert float(cache["ckv"][0].abs().sum()) == 0.0  # full: nothing written
    assert float(cache["krope"][0].abs().sum()) == 0.0
    assert float(cache["ckv"][2].abs().sum()) == 0.0  # free: nothing written
    assert float(cache["krope"][2].abs().sum()) == 0.0
    want = JKV.append_mla(jcache, jnp.asarray(c_new), jnp.asarray(kr_new))
    for name in ("ckv", "krope"):
        np.testing.assert_array_equal(cache[name][:2].numpy(), np.asarray(want[name])[:2])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-8b"])  # MLA and GQA decode
def test_uniform_decode_matches_jax(arch):
    """The lockstep append of a ``uniform_decode`` config (MLA and GQA):
    with a straggler row (lengths 10 and 7), 4 direct decode steps give
    JAX's token ids and caches (f32, 1e-4).  Every row writes at the batch's
    largest length, so the straggler's tokens land past its own length, as
    in the reference."""
    jd, td = DTYPES["f32"]
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jd, uniform_decode=True)
    cfg = get_config(arch, reduced=True).replace(dtype=td, uniform_decode=True)
    jparams = JTF.init_params(jax.random.PRNGKey(3), jcfg)
    params = bridge.params_from_numpy(_np_tree(jparams), device=CPU)
    toks = _tokens(cfg, 2, 10)
    jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), JTF.init_caches(jcfg, 2, 16))
    jc["layers"]["lengths"] = jc["layers"]["lengths"].at[:, 1].set(7)
    caches = bridge.caches_from_numpy(_np_tree(jc), device=CPU)
    nxt = torch.from_numpy(np.array(jnxt))
    for _ in range(4):
        jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
        nxt, caches = TF.decode_step(cfg, params, nxt, caches)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        _assert_caches_close(caches["layers"], jc["layers"])
    np.testing.assert_array_equal(caches["layers"]["lengths"][0].numpy(), [14, 11])


def _jax_logits(jcfg, jparams, toks, dt):
    with _op_by_op(dt):
        logits, _ = JTF.train_forward(jcfg, jparams, jnp.asarray(toks))
    return _f32(jax_vocab_mask(logits.astype(jnp.float32), jcfg))


def test_prefill_and_8_decode_steps_match_jax_f32():
    """Token ids equal over a prompt plus 8 steps; logits and caches at 1e-4."""
    jcfg, jparams, cfg, params = _models("f32")
    b, s, max_seq, steps = 2, 10, 32, 8
    toks = _tokens(cfg, b, s)
    jc = JTF.init_caches(jcfg, b, max_seq)
    caches = bridge.caches_from_numpy(_np_tree(jc), device=CPU)
    assert caches["layers"].keys() == TF.init_caches(cfg, b, max_seq, device=CPU)["layers"].keys()

    jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), jc)
    logits, caches = TF.prefill_logits(cfg, params, torch.from_numpy(toks), caches)
    nxt = logits.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    got, seq = [logits], toks
    for _ in range(steps):
        _assert_caches_close(caches["layers"], jc["layers"])
        seq = np.concatenate([seq, np.asarray(jnxt)[:, None]], axis=1)
        jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
        logits, caches = TF.decode_logits(cfg, params, nxt, caches)
        nxt = logits.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        got.append(logits)
    want = _jax_logits(jcfg, jparams, seq, "f32")[:, s - 1:]
    np.testing.assert_allclose(_f32(torch.stack(got, 1)), want, **F32_TOL)


def _jax_decode_logits(jcfg, jparams, last, jcaches):
    """JAX's decode_step up to its logits, layer by layer (op by op in bf16):
    the absorbed MLA decode rounds at other places than the expanded
    full-sequence form, so a decode step is held against JAX's decode."""
    from repro.models import layers as JL

    x = JL.embed_tokens(jparams["embed"], jnp.asarray(last)[:, None], jcfg)
    for i in range(jcfg.n_layers):
        x, _ = JTF._attn_layer_decode(jcfg, _layer_i(jparams["layers"], i), x,
                                      _layer_i(jcaches["layers"], i))
    x = JL.rmsnorm(x, jparams["final_norm"], jcfg.norm_eps)
    logits = JL.unembed(jparams["embed"], x, jcfg)[:, 0]
    return _f32(jax_vocab_mask(logits.astype(jnp.float32), jcfg))


def _layer_i(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_prefill_and_decode_logits_match_jax_bf16():
    """bf16 prefill logits against JAX's forward and one decode step's logits
    against JAX's decode, both op by op, at 2e-2."""
    jcfg, jparams, cfg, params = _models("bf16", seed=4)
    b, s, max_seq = 2, 11, 24
    toks = _tokens(cfg, b, s, seed=2)
    jc = JTF.init_caches(jcfg, b, max_seq)
    with jax.disable_jit():
        jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), jc)
        want1 = _jax_decode_logits(jcfg, jparams, jnxt, jc)
    logits0, caches = TF.prefill_logits(
        cfg, params, torch.from_numpy(toks), TF.init_caches(cfg, b, max_seq, device=CPU))
    np.testing.assert_allclose(_f32(logits0), _jax_logits(jcfg, jparams, toks, "bf16")[:, -1],
                               **BF16_TOL)
    nxt = torch.from_numpy(np.array(jnxt))
    logits1, _ = TF.decode_logits(cfg, params, nxt, caches)
    np.testing.assert_allclose(_f32(logits1), want1, **BF16_TOL)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_live_split_equals_monolithic_and_jax(k):
    """forward_layers_range split at k (cooperative_forward) equals the port's
    monolithic forward and JAX's own split at k (f32)."""
    jcfg, jparams, cfg, params = _models("f32", seed=3)
    toks = _tokens(cfg, 2, 12, seed=4)
    full, _ = TF.train_forward(cfg, params, torch.from_numpy(toks))
    coop = cooperative_forward(cfg, params, torch.from_numpy(toks), k)
    np.testing.assert_allclose(_f32(coop), _f32(full), **BF16_TOL)
    np.testing.assert_allclose(_f32(coop), _f32(jax_coop(jcfg, jparams, jnp.asarray(toks), k)),
                               **F32_TOL)


def test_prefill_reaches_flash_at_the_qk_head_dim(monkeypatch):
    """mla_prefill calls ops.flash_attention with q, k and V padded to the qk
    head dim and the explicit scale 1/sqrt(qk dim)."""
    _, _, cfg, params = _models("f32")
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    TF.train_forward(cfg, params, torch.from_numpy(_tokens(cfg, 1, 5)))
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    assert len(seen) == cfg.n_layers
    for q, k, v, kw in seen:
        assert q == k == v == (1, 5, cfg.n_heads, qk)
        assert kw == {"causal": True, "softmax_scale": 1.0 / np.sqrt(qk)}


# ---------------------------------------------------------------------------
# The engine and the migration payload
# ---------------------------------------------------------------------------


def test_engine_matches_jax_engine():
    """4 requests through 3 slots (queueing and slot reuse): the port's
    engine gives the JAX engine's tokens (f32)."""
    jcfg, jparams, cfg, params = _models("f32", seed=5)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=6 + 2 * (i % 2)).astype(np.int32)
               for i in range(4)]
    new = [4, 6, 5, 4]

    def serve(engine, req_cls):
        for i, p in enumerate(prompts):
            engine.submit(req_cls(i, p, new[i]))
        done = engine.run_until_done()
        assert len(done) == len(prompts)
        return {r.rid: r.out_tokens for r in done}

    want = serve(jax_engine.InstanceEngine(jcfg, jparams, n_slots=3, max_seq=48),
                 jax_engine.ServeRequest)
    got = serve(InstanceEngine(cfg, params, n_slots=3, max_seq=48), ServeRequest)
    assert got == want
    assert all(len(got[i]) == new[i] for i in got)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-8b"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_payload_bytes_equal_jax(arch, reduced):
    """The migrated bytes of a 1-slot cache equal the JAX count (shapes only:
    the full-size caches are built abstractly on the JAX side and on the meta
    device here)."""
    jcfg = jax_get_config(arch, reduced=reduced)
    cfg = get_config(arch, reduced=reduced)
    max_seq, prompt = 552, 512
    jc = JTF.init_caches(jcfg, 1, max_seq, abstract=True)
    one = TF.init_caches(cfg, 1, max_seq, device="meta")
    assert {k: tuple(v.shape) for k, v in one["layers"].items()} == {
        k: tuple(v.shape) for k, v in jc["layers"].items()}
    assert kvm.payload_bytes(one, prompt, max_seq) == jax_kvm.payload_bytes(jc, prompt, max_seq)

