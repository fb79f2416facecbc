"""Port layers (repro_torch.models.layers) against the JAX reference layers.

The same numpy inputs go through both; tolerances are the reference's own
(tests/test_kernels.py): f32 3e-5, bf16 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=3e-5, rtol=3e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


def _pair(a: np.ndarray, dt: str):
    jd, td = DTYPES[dt]
    return jnp.asarray(a, dtype=jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _close(got, want, dt):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dt]
    )


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 7, 64), (3, 5, 16)])
def test_rmsnorm_matches_jax(shape, dt):
    rng = np.random.default_rng(0)
    xj, xt = _pair(_randn(rng, *shape), dt)
    wj, wt = _pair(_randn(rng, shape[-1]), dt)
    _close(TL.rmsnorm(xt, wt, 1e-5), JL.rmsnorm(xj, wj, 1e-5), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_matches_jax(dt):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    cj, sj = JL.rope_for(jnp.asarray(pos), 16, 1e7)
    ct, st = TL.rope_for(torch.from_numpy(pos), 16, 1e7)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=3e-5, rtol=3e-5)
    xj, xt = _pair(_randn(rng, 2, 9, 3, 16), dt)
    _close(TL.apply_rope(xt, ct, st), JL.apply_rope(xj, cj, sj), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset,with_len", [(0, False), (5, True)])
def test_attention_reference_matches_jax(causal, q_offset, with_len, dt):
    rng = np.random.default_rng(2)
    b, sq, sk, h, kv, d = 2, 7, 12, 4, 2, 16
    qj, qt = _pair(_randn(rng, b, sq, h, d), dt)
    kj, kt = _pair(_randn(rng, b, sk, kv, d), dt)
    vj, vt = _pair(_randn(rng, b, sk, kv, d), dt)
    lens = np.array([12, 9], np.int32) if with_len else None
    want = JL.attention_reference(
        qj, kj, vj, causal=causal, q_offset=q_offset,
        kv_len=None if lens is None else jnp.asarray(lens),
    )
    got = TL.attention_reference(
        qt, kt, vt, causal=causal, q_offset=q_offset,
        kv_len=None if lens is None else torch.from_numpy(lens),
    )
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(causal, dt):
    """Ragged chunking (sq=13 over 4-row chunks, sk=21 over 8-key chunks)
    with a q offset and per-row kv lengths."""
    rng = np.random.default_rng(3)
    b, sq, sk, h, kv, d = 2, 13, 21, 4, 1, 32
    qj, qt = _pair(_randn(rng, b, sq, h, d), dt)
    kj, kt = _pair(_randn(rng, b, sk, kv, d), dt)
    vj, vt = _pair(_randn(rng, b, sk, kv, d), dt)
    lens = np.array([21, 17], np.int32)
    kw = dict(causal=causal, q_offset=8, q_chunk=4, kv_chunk=8)
    want = JL.chunked_attention(qj, kj, vj, kv_len=jnp.asarray(lens), **kw)
    got = TL.chunked_attention(qt, kt, vt, kv_len=torch.from_numpy(lens), **kw)
    _close(got, want, dt)
    # and the chunked form equals the naive one
    naive = TL.attention_reference(
        qt, kt, vt, causal=causal, q_offset=8, kv_len=torch.from_numpy(lens)
    )
    _close(got, jnp.asarray(naive.float().numpy()), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_reference_matches_jax(dt):
    rng = np.random.default_rng(4)
    b, h, kv, s, d = 3, 8, 2, 40, 32
    qj, qt = _pair(_randn(rng, b, h, d), dt)
    kj, kt = _pair(_randn(rng, b, kv, s, d), dt)
    vj, vt = _pair(_randn(rng, b, kv, s, d), dt)
    lens = np.array([1, 17, 40], np.int32)
    want = JL.decode_attention_reference(qj, kj, vj, jnp.asarray(lens))
    got = TL.decode_attention_reference(qt, kt, vt, torch.from_numpy(lens))
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_swiglu_mlp_matches_jax(dt):
    rng = np.random.default_rng(5)
    jcfg = jax_get_config("granite-8b", reduced=True)
    cfg = get_config("granite-8b", reduced=True)
    d, f = cfg.d_model, cfg.d_ff
    pj, pt = {}, {}
    for name, shape in (("w_up", (d, f)), ("w_gate", (d, f)), ("w_down", (f, d))):
        pj[name], pt[name] = _pair(_randn(rng, *shape) / np.sqrt(shape[0]), dt)
    xj, xt = _pair(_randn(rng, 2, 5, d), dt)
    _close(TL.mlp_forward(pt, xt, cfg), JL.mlp_forward(pj, xj, jcfg), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["nemotron-4-340b", "whisper-large-v3"], ids=["relu2", "gelu"])
def test_relu2_and_gelu_mlp_match_jax(arch, dt):
    """nemotron's squared ReLU (in the input dtype: a bf16 square rounds to
    bf16) and whisper's f32 gelu, which is jax.nn.gelu's tanh form: in f32
    the exact erf form misses the reference by more than 3e-5."""
    rng = np.random.default_rng(6)
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    d, f = cfg.d_model, cfg.d_ff
    pj, pt = {}, {}
    for name, shape in (("w_up", (d, f)), ("w_down", (f, d))):
        pj[name], pt[name] = _pair(_randn(rng, *shape) * 2 / np.sqrt(shape[0]), dt)
    assert TL.mlp_template(cfg).keys() == JL.mlp_template(jcfg).keys() == pt.keys()
    xj, xt = _pair(_randn(rng, 2, 5, d), dt)
    want = JL.mlp_forward(pj, xj, jcfg)
    _close(TL.mlp_forward(pt, xt, cfg), want, dt)
    if arch == "whisper-large-v3" and dt == "f32":
        up = xt @ pt["w_up"]
        erf = torch.nn.functional.gelu(up) @ pt["w_down"]
        assert np.abs(erf.numpy() - np.asarray(want)).max() > 3e-5


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_embed_unembed_and_vocab_mask_match_jax(dt):
    rng = np.random.default_rng(6)
    jcfg = jax_get_config("granite-8b", reduced=True)
    cfg = get_config("granite-8b", reduced=True)
    pv, d = cfg.padded_vocab_size, cfg.d_model
    assert pv > cfg.vocab_size  # the mask has a tail to hide
    tj, tt = _pair(_randn(rng, pv, d), dt)
    uj, ut = _pair(_randn(rng, d, pv) / 8.0, dt)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    ej = JL.embed_tokens({"tok": tj}, jnp.asarray(toks), jcfg)
    et = TL.embed_tokens({"tok": tt}, torch.from_numpy(toks), cfg)
    _close(et, ej, dt)
    lj = JL.unembed({"tok": tj, "unembed": uj}, ej, jcfg)
    lt = TL.unembed({"tok": tt, "unembed": ut}, et, cfg)
    _close(lt, lj, dt)
    mj = JL.vocab_mask_logits(lj.astype(jnp.float32), jcfg)
    mt = TL.vocab_mask_logits(lt.float(), cfg)
    _close(mt, mj, dt)
    assert bool((mt[..., cfg.vocab_size:] == TL.NEG_INF).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gqa_qkv_with_bias_matches_jax(dt):
    from repro.models import attention as JA
    from repro_torch.models import attention as TA

    rng = np.random.default_rng(7)
    jcfg = jax_get_config("granite-8b", reduced=True).replace(qkv_bias=True)
    cfg = get_config("granite-8b", reduced=True).replace(qkv_bias=True)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert set(TA.gqa_template(cfg)) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)}
    pj, pt = {}, {}
    for name, shape in shapes.items():
        pj[name], pt[name] = _pair(_randn(rng, *shape) / 8.0, dt)
    xj, xt = _pair(_randn(rng, 2, 5, d), dt)
    for got, want in zip(TA._gqa_qkv(pt, xt, cfg), JA._gqa_qkv(pj, xj, jcfg)):
        _close(got, want, dt)
