"""The port's enc-dec (whisper-large-v3) and VLM (pixtral-12b) families at
REDUCED size against the JAX package.

Weights are made by the JAX init and carried over through the bridge; the
stub frames (B, n_frontend_tokens, d_model) are drawn with numpy from a
seed, scaled by 0.02 as the JAX package's data pipeline draws them, and
handed to both sides.  f32: token ids equal exactly, the encoder output and
the cross-attention cache within 3e-5 (tests/test_kernels.py's f32
tolerance), logits and caches within 1e-4 (sums in another order); the
split forward within 2e-2 of JAX's (tests/test_live_scaling.py:29-33) and
bit-equal to the port's own monolithic forward.  bf16: the JAX side runs op
by op (``jax.disable_jit()``; compiled XLA keeps bf16 chains in f32) and
the logits agree within 2e-2.

The enc-dec quirk kept from the reference: ``forward_layers_range`` (and so
the live split) runs the decoder layers without their cross-attention.
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.live_scaling import cooperative_forward as jax_coop  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.layers import vocab_mask_logits as jax_vocab_mask  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.live_scaling import cooperative_forward  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import bridge, layers  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

ARCHS = ["whisper-large-v3", "pixtral-12b"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_F32_TOL = dict(atol=3e-5, rtol=3e-5)  # tests/test_kernels.py:16
SPLIT_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_live_scaling.py:29-33


@functools.lru_cache(maxsize=None)
def _models(arch, dt="f32"):
    jd, td = DTYPES[dt]
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jd)
    cfg = get_config(arch, reduced=True).replace(dtype=td)
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _frames(cfg, b, dt="f32", seed=7):
    """The same stub frames for both sides: (JAX array, torch tensor)."""
    jd, td = DTYPES[dt]
    a = (np.random.default_rng(seed).standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
         * 0.02).astype(np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


def _assert_caches_close(got, want):
    """Leaf by leaf: integer lengths exactly, the cross cache within 3e-5 and
    the self-attention K/V within 1e-4, each of the tensor's scale: with the
    reference's init law (std 1/sqrt(2) for a 2-layer cut) the keys reach
    ~10, where an encoder output within 3e-5 of JAX's moves them by ~2e-4."""
    flat_g, flat_w = _flat(got), _flat(want)
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        w = np.asarray(w)
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(flat_g[key].numpy(), w, err_msg=str(key))
        else:
            tol = KERNEL_F32_TOL if key[0] == "cross" else F32_TOL
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(_f32(flat_g[key]), w, err_msg=str(key),
                                       atol=tol["atol"] * scale, rtol=tol["rtol"])


def _jax_decode_logits(jcfg, jparams, last, jcaches):
    """JAX's decode_step up to its logits, layer by layer (op by op in
    bf16): the decode rounds its probabilities to bf16 where the
    full-sequence forward does not, so a bf16 step is held against JAX's
    decode."""
    from repro.models import layers as JL

    x = JL.embed_tokens(jparams["embed"], jnp.asarray(last)[:, None], jcfg)
    for i in range(jcfg.n_layers):
        lp, cache = (jax.tree.map(lambda a: a[i], t) for t in (jparams["layers"], jcaches["layers"]))
        cross = None
        if jcfg.family == "encdec":
            xc = jcaches["cross"]
            cross = {"k": xc["k"][i], "v": xc["v"][i], "lengths": xc["lengths"]}
        x, _ = JTF._attn_layer_decode(jcfg, lp, x, cache, cross_cache=cross)
    x = JL.rmsnorm(x, jparams["final_norm"], jcfg.norm_eps)
    logits = JL.unembed(jparams["embed"], x, jcfg)[:, 0]
    return _f32(jax_vocab_mask(logits.astype(jnp.float32), jcfg))


def _jax_logits(jcfg, jparams, toks, jframes, dt="f32"):
    """Masked f32 logits at every position (B, S, V): by causality, what the
    prefill gives at the prompt's end and each decode step after it."""
    ctx = jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()
    with ctx:
        logits, _ = JTF.train_forward(jcfg, jparams, jnp.asarray(toks), jframes)
        return _f32(jax_vocab_mask(logits.astype(jnp.float32), jcfg))


# ---------------------------------------------------------------------------
# Templates, caches, frontends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_templates_and_caches_match_jax(arch):
    """Parameter tree (the encoder, enc_norm, norm_x and xattn of whisper),
    the number of live-scaling blocks (encoder layers included) and the
    cache tree (whisper's stacked seq-major cross cache) equal the JAX ones,
    full and REDUCED; the bridge carries every new leaf over unchanged."""
    for reduced in (True, False):
        jcfg, cfg = jax_get_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
        jt, tt = _flat(JTF.param_template(jcfg)), _flat(TF.param_template(cfg))
        assert jt.keys() == tt.keys()
        for key, spec in jt.items():
            assert tt[key].shape == spec.shape and tt[key].init == spec.init, key
        assert TF.n_layer_blocks(cfg) == JTF.n_layer_blocks(jcfg)
    jcfg, jparams, cfg, params = _models(arch)
    if cfg.family == "encdec":
        assert {"encoder", "enc_norm"} <= params.keys()
        assert {"norm_x", "xattn"} <= params["layers"].keys()
        assert TF.n_layer_blocks(cfg) == cfg.n_layers + cfg.n_enc_layers
    for key, a in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_array_equal(_flat(params)[key].numpy(), a, err_msg=str(key))
    flat_j = _flat(JTF.init_caches(jcfg, 2, 24))
    flat_t = _flat(TF.init_caches(cfg, 2, 24, device="cpu"))
    assert flat_j.keys() == flat_t.keys()
    for key, a in flat_j.items():
        assert tuple(flat_t[key].shape) == a.shape, key
        assert str(flat_t[key].dtype).split(".")[-1] == str(a.dtype), key


def test_vlm_embed_overwrites_the_first_positions():
    """pixtral's patch frames replace the embeddings of the first Sf token
    positions and leave the rest; as JAX's ``_embed``, in f32 and bf16."""
    for dt in ("f32", "bf16"):
        jcfg, jparams, cfg, params = _models("pixtral-12b", dt)
        toks = _tokens(cfg, 2, 13)
        jframes, frames = _frames(cfg, 2, dt)
        got = TF._embed(cfg, params, torch.from_numpy(toks), frames)
        want = JTF._embed(jcfg, jparams, jnp.asarray(toks), jframes)
        np.testing.assert_array_equal(_f32(got), _f32(want))
        sf = cfg.n_frontend_tokens
        assert torch.equal(got[:, :sf], frames)
        assert torch.equal(got[:, sf:], TF._embed(cfg, params, torch.from_numpy(toks))[:, sf:])


def test_encoder_output_and_cross_cache_match_jax():
    """whisper's encoder (non-causal blocks with RoPE at 0..Sf-1, then
    enc_norm) within 3e-5 of JAX's; from JAX's encoder output the port's
    prefill writes every layer's cross K/V (seq-major, no bias, no RoPE)
    within 3e-5 of JAX's prefill; without frames it raises."""
    jcfg, jparams, cfg, params = _models("whisper-large-v3")
    jframes, frames = _frames(cfg, 2)
    got = TF._run_encoder(cfg, params, frames)
    want = JTF._run_encoder(jcfg, jparams, jframes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_F32_TOL)
    toks = _tokens(cfg, 2, 6)
    _, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), JTF.init_caches(jcfg, 2, 8), jframes)
    caches = TF.init_caches(cfg, 2, 8, device="cpu")
    TF._forward(cfg, params["layers"], TF._embed(cfg, params, torch.from_numpy(toks)),
                TF._positions(torch.from_numpy(toks)), 0, cfg.n_layers, caches=caches,
                enc_out=torch.from_numpy(np.array(want)))
    for name in ("k", "v"):
        np.testing.assert_allclose(caches["cross"][name].numpy(), np.asarray(jc["cross"][name]),
                                   **KERNEL_F32_TOL)
    np.testing.assert_array_equal(caches["cross"]["lengths"].numpy(), np.asarray(jc["cross"]["lengths"]))
    with pytest.raises(ValueError, match="needs frames"):
        TF.prefill(cfg, params, torch.from_numpy(_tokens(cfg, 2, 4)),
                   TF.init_caches(cfg, 2, 8, device="cpu"))


def test_cross_cache_needs_the_configured_frame_count():
    _, _, cfg, params = _models("whisper-large-v3")
    frames = torch.zeros(1, cfg.n_frontend_tokens + 1, cfg.d_model)
    with pytest.raises(ValueError, match="frames"):
        TF.prefill(cfg, params, torch.from_numpy(_tokens(cfg, 1, 4)),
                   TF.init_caches(cfg, 1, 8, device="cpu"), frames)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_f32(arch):
    """A 10-token prompt of two sequences with frames, then 8 steps: token
    ids equal JAX's every time, caches (whisper's cross cache included) after
    the prefill and every step, and the logits of every step equal JAX's
    forward over the grown sequence."""
    jcfg, jparams, cfg, params = _models(arch)
    b, s, max_seq, steps = 2, 10, 24, 8
    toks = _tokens(cfg, b, s)
    jframes, frames = _frames(cfg, b)
    jc = JTF.init_caches(jcfg, b, max_seq)
    caches = TF.init_caches(cfg, b, max_seq, device="cpu")
    jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), jc, jframes)
    logits, caches = TF.prefill_logits(cfg, params, torch.from_numpy(toks), caches, frames)
    nxt = logits.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    _assert_caches_close(caches, jc)
    if cfg.family == "encdec":
        assert caches["cross"]["lengths"].tolist() == [cfg.n_frontend_tokens] * b
    got, seq = [logits], toks
    for _ in range(steps):
        seq = np.concatenate([seq, np.asarray(jnxt)[:, None]], axis=1)
        jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
        logits, caches = TF.decode_logits(cfg, params, nxt, caches)
        nxt = logits.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        _assert_caches_close(caches, jc)
        got.append(logits)
    want = _jax_logits(jcfg, jparams, seq, jframes)[:, s - 1:]
    np.testing.assert_allclose(_f32(torch.stack(got, 1)), want, **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_frames_change_the_output(arch):
    """The frames reach the model: other frames give other logits."""
    _, _, cfg, params = _models(arch)
    toks = torch.from_numpy(_tokens(cfg, 2, 10))
    a, _ = TF.train_forward(cfg, params, toks, _frames(cfg, 2, seed=1)[1])
    b, _ = TF.train_forward(cfg, params, toks, _frames(cfg, 2, seed=2)[1])
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax_bf16(arch):
    """bf16 with frames, the JAX side op by op, within 2e-2: the prefill's
    logits against JAX's forward, one decode step's against JAX's decode
    (over JAX's own prefilled caches)."""
    jcfg, jparams, cfg, params = _models(arch, "bf16")
    b, s = 2, 10
    toks = _tokens(cfg, b, s, seed=2)
    jframes, frames = _frames(cfg, b, "bf16")
    with jax.disable_jit():
        jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), JTF.init_caches(jcfg, b, 16),
                               jframes)
        want1 = _jax_decode_logits(jcfg, jparams, jnxt, jc)
    logits0, caches = TF.prefill_logits(cfg, params, torch.from_numpy(toks),
                                        TF.init_caches(cfg, b, 16, device="cpu"), frames)
    want0 = _jax_logits(jcfg, jparams, toks, jframes, "bf16")[:, -1]
    np.testing.assert_allclose(_f32(logits0), want0, **SPLIT_TOL)
    logits1, _ = TF.decode_logits(cfg, params, torch.from_numpy(np.array(jnxt)), caches)
    np.testing.assert_allclose(_f32(logits1), want1, **SPLIT_TOL)


# ---------------------------------------------------------------------------
# Live split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cooperative_forward_matches_jax(arch):
    """The split at k in {0, 1, L} with frames: equal to JAX's
    cooperative_forward (2e-2, and 1e-4 in f32) and bit-equal across k.  For
    pixtral that is the monolithic forward; whisper's split runs the decoder
    layers without cross-attention, as JAX's does, so it equals the
    decoder-only forward and not ``train_forward``."""
    jcfg, jparams, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, 12, seed=4)
    jframes, frames = _frames(cfg, 2)
    full, _ = TF.train_forward(cfg, params, torch.from_numpy(toks), frames)
    if cfg.family == "encdec":
        x = TF._embed(cfg, params, torch.from_numpy(toks))
        x = TF.forward_layers_range(cfg, params["layers"], x, 0, cfg.n_layers,
                                    TF._positions(torch.from_numpy(toks)))
        x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
        mono = layers.unembed(params["embed"], x, cfg)
        assert not torch.allclose(mono, full, **SPLIT_TOL)  # the quirk: no cross-attention
    else:
        mono = full
    for k in (0, 1, cfg.n_layers):
        got = cooperative_forward(cfg, params, torch.from_numpy(toks), k, frames)
        assert torch.equal(got, mono), k
        want = np.asarray(jax_coop(jcfg, jparams, jnp.asarray(toks), k, jframes))
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
