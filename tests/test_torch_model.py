"""The port's model against the JAX model: config, bridge, prefill, decode and
the cooperative (layer-split) forward, on granite-8b REDUCED.

Weights are made by the JAX package and carried over through the bridge.
f32: token ids equal exactly, logits and caches at 1e-4 (sums taken in
another order); bf16: logits at 2e-2 (tests/test_live_scaling.py).

In bf16 the JAX side runs op by op (``jax.disable_jit()``): compiled, XLA
fuses chains of bf16 ops and keeps their intermediates in f32 (excess
precision), which rounds at other places than the source says.  Op by op,
each reference op rounds where the source rounds, as the port does.
"""

import contextlib

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.live_scaling import cooperative_forward as jax_coop  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.layers import vocab_mask_logits as jax_vocab_mask  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.live_scaling import cooperative_forward  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

CPU = "cpu"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(dt):
    jd, td = DTYPES[dt]
    return (
        jax_get_config("granite-8b", reduced=True).replace(dtype=jd),
        get_config("granite-8b", reduced=True).replace(dtype=td),
    )


def _models(dt, seed=0):
    jcfg, cfg = _cfgs(dt)
    jparams = JTF.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, cfg, bridge.params_from_numpy(_np_tree(jparams), device=CPU)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Config, template, bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_granite_config_fields_equal_jax(reduced):
    jcfg = jax_get_config("granite-8b", reduced=reduced)
    cfg = get_config("granite-8b", reduced=reduced)
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    assert jf.keys() == tf.keys()
    assert jcfg.dtype == jnp.bfloat16 and cfg.dtype == torch.bfloat16
    jf.pop("dtype"), tf.pop("dtype")
    assert jf == tf
    assert cfg.padded_vocab_size == jcfg.padded_vocab_size
    assert cfg.approx_params() == jcfg.approx_params()


def test_unported_arch_raises():
    """Every arch id of the JAX registry (ARCH_IDS and the paper's models)
    resolves, full and REDUCED, in the dash and the underscore form, to the
    config of that name; only an id the JAX package lacks raises."""
    from repro.configs import ARCH_IDS, PAPER_IDS

    for arch in ARCH_IDS + PAPER_IDS:
        for reduced in (False, True):
            for name in (arch, arch.replace("-", "_").replace(".", "_")):
                cfg = get_config(name, reduced=reduced)
                assert cfg.name == jax_get_config(arch, reduced=reduced).name
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


def test_param_template_matches_jax():
    jcfg, cfg = _cfgs("f32")
    tt = TF.init_params(cfg, 0, device=CPU)

    def shapes(tree, conv):
        if isinstance(tree, dict):
            return {k: shapes(v, conv) for k, v in tree.items()}
        return conv(tree)

    want = shapes(JTF.param_template(jcfg), lambda spec: tuple(spec.shape))
    assert shapes(tt, lambda t: tuple(t.shape)) == want
    # the reference's init law: stacked layer leaves draw with std 1/sqrt(n_layers)
    w = tt["layers"]["mlp"]["w_up"]
    assert abs(w.std().item() - 1 / np.sqrt(cfg.n_layers)) < 0.02
    assert torch.equal(tt["layers"]["norm1"], torch.ones_like(tt["layers"]["norm1"]))


def test_bridge_is_lossless_for_bf16():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((3, 5, 7)) * 100).astype(ml_dtypes.bfloat16)
    tree = {"x": {"y": a}, "n": np.arange(4, dtype=np.int32)}
    got = bridge.params_from_numpy(tree, device=CPU)
    assert got["x"]["y"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"]["y"].float().numpy(), a.astype(np.float32))
    assert got["n"].dtype == torch.int32
    assert torch.equal(got["n"], torch.arange(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def _op_by_op(dt):
    return jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()


def _jax_logits(jcfg, jparams, toks, dt):
    """Masked f32 logits of every position of ``toks`` (B, S, V).  By
    causality, position t is the next-token logits after ``toks[:, :t+1]``:
    what prefill gives at the prompt's end and each decode step after it."""
    with _op_by_op(dt):
        logits, _ = JTF.train_forward(jcfg, jparams, jnp.asarray(toks))
    return _f32(jax_vocab_mask(logits.astype(jnp.float32), jcfg))


def test_prefill_and_decode_match_jax_f32():
    jcfg, jparams, cfg, params = _models("f32")
    b, s, max_seq, steps = 2, 10, 32, 3
    toks = _tokens(cfg, b, s)
    jc = JTF.init_caches(jcfg, b, max_seq)
    caches = bridge.caches_from_numpy(_np_tree(jc), device=CPU)

    jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), jc)
    logits, caches = TF.prefill_logits(cfg, params, torch.from_numpy(toks), caches)
    nxt = logits.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    assert torch.equal(TF.prefill(cfg, params, torch.from_numpy(toks),
                                  TF.init_caches(cfg, b, max_seq, device=CPU))[0], nxt)
    got, seq = [logits], toks
    for _ in range(steps):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _f32(caches["layers"][name]), _f32(jc["layers"][name]), atol=1e-4, rtol=1e-4
            )
        np.testing.assert_array_equal(
            caches["layers"]["lengths"].numpy(), np.asarray(jc["layers"]["lengths"])
        )
        seq = np.concatenate([seq, np.asarray(jnxt)[:, None]], axis=1)
        jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
        logits, caches = TF.decode_logits(cfg, params, nxt, caches)
        nxt = logits.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        got.append(logits)
    want = _jax_logits(jcfg, jparams, seq, "f32")[:, s - 1:]
    np.testing.assert_allclose(_f32(torch.stack(got, 1)), want, atol=1e-4, rtol=1e-4)


def test_prefill_and_decode_logits_match_jax_bf16():
    jcfg, jparams, cfg, params = _models("bf16")
    b, s, max_seq = 2, 11, 24  # seq (2, 12): the shapes of the cooperative test
    toks = _tokens(cfg, b, s, seed=2)
    logits0, caches = TF.prefill_logits(
        cfg, params, torch.from_numpy(toks), TF.init_caches(cfg, b, max_seq, device=CPU)
    )
    nxt = logits0.argmax(-1).to(torch.int32)
    logits1, _ = TF.decode_logits(cfg, params, nxt, caches)
    seq = np.concatenate([toks, nxt.numpy()[:, None]], axis=1)
    want = _jax_logits(jcfg, jparams, seq, "bf16")[:, s - 1:]
    got = _f32(torch.stack([logits0, logits1], 1))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# Cooperative (layer-split) forward: the live-scaling contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cooperative_forward_equals_monolithic_and_jax(dt):
    """Every split k equals the port's monolithic forward and the JAX one (in
    f32 JAX's own cooperative_forward at each k; in bf16, to keep the op-by-op
    reference short, JAX's monolithic forward, which its own contract equates
    with every split)."""
    jcfg, jparams, cfg, params = _models(dt, seed=3)
    toks = _tokens(cfg, 2, 12, seed=4)
    full, aux = TF.train_forward(cfg, params, torch.from_numpy(toks))
    assert full.shape == (2, 12, cfg.padded_vocab_size) and float(aux) == 0.0
    if dt == "bf16":
        with _op_by_op(dt):
            jfull = _f32(JTF.train_forward(jcfg, jparams, jnp.asarray(toks))[0].astype(jnp.float32))
    tol = dict(atol=1e-4, rtol=1e-4) if dt == "f32" else dict(atol=2e-2, rtol=2e-2)
    for k in range(cfg.n_layers + 1):
        coop = cooperative_forward(cfg, params, torch.from_numpy(toks), k)
        np.testing.assert_allclose(_f32(coop), _f32(full), atol=2e-2, rtol=2e-2)
        if dt == "f32":
            want = _f32(jax_coop(jcfg, jparams, jnp.asarray(toks), k))
        else:
            want = jfull
        np.testing.assert_allclose(_f32(coop), want, **tol)


# ---------------------------------------------------------------------------
# The port's own copies of the live-scaling state machine
# ---------------------------------------------------------------------------


def test_live_session_and_multiplier_match_jax():
    from repro.core import live_scaling as JLS
    from repro.core.zigzag import live_throughput_multiplier as jax_mult
    from repro_torch.core import live_scaling as TLS
    from repro_torch.core.zigzag import live_throughput_multiplier

    for n in (1, 8, 36):
        for k in range(-1, n + 2):
            assert live_throughput_multiplier(k, n) == jax_mult(k, n)
    kw = dict(n_layers=8, layer_bytes=100, link_bytes_per_s=100.0, started_at=0.0)
    js, ts = JLS.LiveSession(**kw), TLS.LiveSession(**kw)
    for now in (0.0, 1.5, 4.0, 7.9, 8.0, 9.0):
        assert ts.layers_loaded(now) == js.layers_loaded(now)
        assert ts.throughput_multiplier(now) == js.throughput_multiplier(now)
        assert ts.phase.value == js.phase.value
    assert ts.done_at() == js.done_at()
    delivered = [250.0]
    ts = TLS.LiveSession(**kw, progress_bytes=lambda: delivered[0])
    assert ts.layers_loaded(0.0) == 2
    delivered[0] = 1e9
    assert ts.throughput_multiplier(0.0) == 2.0 and ts.phase is TLS.Phase.REBALANCED


def test_other_families_raise():
    """A family with attention blocks and attn='none' raises, and so does an
    unknown family; the int8 cache builds on every family, and the MoE, SSM,
    hybrid, enc-dec and VLM families build."""
    cfg = get_config("granite-8b", reduced=True)
    for arch in ("granite-8b", "whisper-large-v3", "pixtral-12b"):
        quant = get_config(arch, reduced=True).replace(kv_quant=True)
        TF.param_template(quant)
        assert TF.init_caches(quant, 1, 8, device=CPU)["layers"]["k"].dtype == torch.int8
    for arch in ("granite-8b", "olmoe-1b-7b", "zamba2-2.7b", "whisper-large-v3"):
        with pytest.raises(ValueError, match="attn 'gqa' or 'mla'"):
            TF.param_template(get_config(arch, reduced=True).replace(attn="none"))
    with pytest.raises(ValueError, match="unknown family"):
        TF.param_template(cfg.replace(family="retnet"))
    assert "k_scale" in TF.init_caches(cfg.replace(kv_quant=True), 1, 8, device=CPU)["layers"]
    for arch in ("olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b", "whisper-large-v3", "pixtral-12b"):
        TF.param_template(get_config(arch, reduced=True))
    for family in ("encdec", "vlm"):
        TF.init_caches(cfg.replace(family=family, n_enc_layers=1, n_frontend_tokens=4), 1, 8,
                       device=CPU)
