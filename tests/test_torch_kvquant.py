"""The port's int8 KV cache (``kv_quant``) against the JAX package's.

``quantize_kv``, the cache's init, prompt write and both appends (under a
live mask and at a full row), the plain decode with the scales, the whole
model's prefill and decode on the families with GQA caches (granite, the
hybrid zamba2's shared caches, whisper's self caches beside its unquantized
cross cache, pixtral), minicpm3 (MLA: ``kv_quant`` builds the ordinary
latent cache), the engine, and the migrated bytes of a one-slot cache.

Inputs are drawn with numpy from a seed and weights made by the JAX init
and carried over through the bridge.  Tolerances: f32 3e-5 and bf16 2e-2
(tests/test_kernels.py:16-17); token ids equal in f32; the model's bf16
logits at 2e-2, the JAX side op by op (``jax.disable_jit()``).  The int8
values are compared exactly where the two sides quantize the same f32
input; from the model's K/V, which differ in the last bits of f32, an entry
may differ by 1 where its input lies within rounding of a .5 boundary
(``_count_int8`` counts them).
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving.disagg import kv_migration as jax_kvm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import bridge, kvcache, layers  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serving.disagg import kv_migration  # noqa: E402
from repro_torch.serving.engine import InstanceEngine, ServeRequest  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=3e-5, rtol=3e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
MODEL_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_live_scaling.py:29-33
ARCHS = ["granite-8b", "zamba2-2.7b", "whisper-large-v3", "pixtral-12b"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) and x.is_floating_point() else np.asarray(x)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _int8_close(got, want):
    """int8 arrays quantized from the same f32 inputs: equal."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert int((got != want).sum()) == 0, f"{int((got != want).sum())} int8 entries differ"


def _count_int8(got, want):
    """int8 caches quantized from the model's K/V, which the two sides
    compute in another order and so agree only to the last bits of f32:
    apart by at most 1 (an input within rounding of a .5 boundary rounds
    either way).  Returns how many entries differ."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max(initial=0) <= 1
    return int((diff > 0).sum())


# ---------------------------------------------------------------------------
# quantize_kv and the cache's writers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_kv_matches_jax(dt):
    """Equal int8 values and equal scales, on normal values, a row of zeros
    (the 1e-8 floor), halves that round to even, and an absmax row."""
    jd, td = DTYPES[dt]
    x = _normal((3, 4, 37, 16), 0, 3.0)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = np.arange(16) * 0.5 - 4.0  # halves: round half to even
    x[0, 0, 2, 3] = -127.0
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    jq, js = JKV.quantize_kv(xj)
    tq, ts = kvcache.quantize_kv(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == x.shape[:-1]
    _int8_close(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_init_kv_cache_quant_matches_jax():
    got = kvcache.init_kv_cache(2, 24, 3, 16, torch.bfloat16, quant=True, device="cpu")
    want = JKV.init_kv_cache(2, 24, 3, 16, jnp.bfloat16, quant=True)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        assert not got[name].any(), name


def _jax_select(new, old, live):
    """The JAX engine's select of the live rows of a (B, ...) cache."""
    if live is None:
        return new
    return {k: jnp.where(jnp.asarray(live).reshape((-1,) + (1,) * (v.ndim - 1)), v, old[k])
            for k, v in new.items()}


def _filled(b, s, kv, d, seed):
    """A quant cache with a 12-token prompt written, on both sides, lengths
    (12, s, 5, 12): row 1 full, row 2 shorter."""
    k, v = _normal((b, 12, kv, d), seed, 2.0), _normal((b, 12, kv, d), seed + 1, 2.0)
    lengths = np.asarray([12, s, 5, 12][:b], np.int32)
    jc = JKV.write_prompt_kv(JKV.init_kv_cache(b, s, kv, d, jnp.float32, quant=True),
                             jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    tc = kvcache.write_prompt_kv(
        kvcache.init_kv_cache(b, s, kv, d, torch.float32, quant=True, device="cpu"),
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lengths))
    return jc, tc


def _assert_cache_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in ("k", "v"):
        _int8_close(got[name].numpy(), want[name])
    for name in ("k_scale", "v_scale", "lengths"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_write_prompt_kv_quant_matches_jax():
    jc, tc = _filled(4, 16, 2, 16, 1)
    _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("uniform", [False, True], ids=["per_row", "lockstep"])
@pytest.mark.parametrize("live", [None, (True, True, False, True)], ids=["all_live", "live_mask"])
def test_append_kv_quant_matches_jax(uniform, live):
    """Three appends into a cache with a full row (1) and, under the mask, a
    row that is not live (2): each leaf equal to the JAX append followed by
    the JAX engine's select of the live rows."""
    b, s, kv, d = 4, 16, 2, 16
    jc, tc = _filled(b, s, kv, d, 2)
    jfn = JKV.append_kv_uniform if uniform else JKV.append_kv
    tfn = kvcache.append_kv_uniform if uniform else kvcache.append_kv
    mask = None if live is None else torch.tensor(live)
    for step in range(3):
        kn, vn = _normal((b, kv, d), 10 + step, 2.0), _normal((b, kv, d), 20 + step, 2.0)
        jc = _jax_select(jfn(jc, jnp.asarray(kn), jnp.asarray(vn)), jc, live)
        tc = tfn(tc, torch.from_numpy(kn), torch.from_numpy(vn), mask)
        _assert_cache_equal(tc, jc)


# ---------------------------------------------------------------------------
# The plain decode with the scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_decode_reference_with_scales_matches_jax(n_rep, dt):
    """layers.decode_attention_reference and ref.decode_attention_ref on an
    int8 cache with its scales, against the JAX reference, lengths 1, S and
    ragged."""
    jd, td = DTYPES[dt]
    b, kv, s, d = 3, 2, 40, 16
    q = _normal((b, kv * n_rep, d), 3)
    (kq, ks), (vq, vs) = (JKV.quantize_kv(jnp.asarray(_normal((b, kv, s, d), i, 2.0)))
                          for i in (4, 5))
    lengths = np.asarray([1, s, 23], np.int32)
    want = JL.decode_attention_reference(jnp.asarray(q, jd), kq, vq, jnp.asarray(lengths),
                                         k_scale=ks, v_scale=vs)
    args = [torch.from_numpy(q).to(td)] + [torch.from_numpy(np.array(a))
                                           for a in (kq, vq, lengths)]
    kw = dict(k_scale=torch.from_numpy(np.array(ks)), v_scale=torch.from_numpy(np.array(vs)))
    for fn in (layers.decode_attention_reference, ref.decode_attention_ref):
        got = fn(*args, **kw)
        assert got.dtype == td
        np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)), **TOL[dt])


def test_decode_int8_bf16_granite_heads_match_jax_op_by_op():
    """The port's plain int8 decode under a bf16 q at granite's heads (32 q
    heads over 8 KV heads, D = 128), ragged lengths (1, 15, 17, 63, 65,
    S): the probabilities times v_scale rounded to bf16 before PV, the
    reference's rounding point (the tensor-core kernel's too), against
    JAX's decode_attention_reference run op by op (``jax.disable_jit()``)
    at bf16's 2e-2; the port's f32 step-by-step oracle (no such rounding)
    stays within it as well."""
    b, h, kv, s, d = 6, 32, 8, 80, 128
    q = _normal((b, h, d), 6)
    (kq, ks), (vq, vs) = (JKV.quantize_kv(jnp.asarray(_normal((b, kv, s, d), i))) for i in (7, 8))
    lengths = np.asarray([1, 15, 17, 63, 65, s], np.int32)
    with jax.disable_jit():
        want = JL.decode_attention_reference(jnp.asarray(q, jnp.bfloat16), kq, vq,
                                             jnp.asarray(lengths), k_scale=ks, v_scale=vs)
    args = [torch.from_numpy(q).to(torch.bfloat16)] + [torch.from_numpy(np.array(a))
                                                       for a in (kq, vq, lengths)]
    kw = dict(k_scale=torch.from_numpy(np.array(ks)), v_scale=torch.from_numpy(np.array(vs)))
    got = ref.decode_attention_ref(*args, **kw)
    assert got.dtype == torch.bfloat16
    want = _np(want.astype(jnp.float32))
    np.testing.assert_allclose(_np(got), want, **TOL["bf16"])
    oracle, _ = ref.decode_attention_ref(*args, return_lse=True, **kw)
    np.testing.assert_allclose(_np(oracle), want, **TOL["bf16"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch, dt):
    jd, td = DTYPES[dt]
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jd, kv_quant=True)
    cfg = get_config(arch, reduced=True).replace(dtype=td, kv_quant=True)
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _frames(cfg, b, dt):
    if cfg.family not in ("encdec", "vlm"):
        return None, None
    a = _normal((b, cfg.n_frontend_tokens, cfg.d_model), 7, 0.02)
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


@contextlib.contextmanager
def _jax_logits_recorded(monkeypatch):
    """Record every logits array the JAX model masks (its prefill's and each
    decode step's), op by op."""
    seen = []
    mask = JL.vocab_mask_logits

    def recording(logits, cfg):
        out = mask(logits, cfg)
        seen.append(np.asarray(out.astype(jnp.float32)))
        return out

    monkeypatch.setattr(JL, "vocab_mask_logits", recording)
    with jax.disable_jit():
        yield seen


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_f32(arch):
    """Prefill of 3 prompts and 4 decode steps: token ids equal, every cache
    leaf after each step within the int8 rule (values) or 1e-4 of its scale
    (the f32 leaves: scales, SSM states, the cross cache), lengths equal.
    The caches are built by each side's own init_caches and hold the same
    leaves; with kv_quant only the GQA caches are int8."""
    jcfg, jparams, cfg, params = _models(arch, "f32")
    b, s, max_seq = 3, 10, 24
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jf, tf = _frames(cfg, b, "f32")
    jc = JTF.init_caches(jcfg, b, max_seq)
    caches = TF.init_caches(cfg, b, max_seq, device="cpu")
    jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), jc, jf)
    nxt, caches = TF.prefill(cfg, params, torch.from_numpy(toks), caches, tf)
    near_half = 0
    for step in range(5):
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt), err_msg=f"step {step}")
        fg, fw = _flat(caches), _flat(jax.tree.map(np.asarray, jc))
        assert fg.keys() == fw.keys()
        for key, w in fw.items():
            g = fg[key]
            if key[-1] in ("k", "v") and key[0] != "cross":
                assert g.dtype == torch.int8, key
                near_half += _count_int8(g.numpy(), w)
            elif w.dtype.kind in "iu":
                np.testing.assert_array_equal(g.numpy(), w, err_msg=str(key))
            else:
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(_np(g), w, atol=1e-4 * scale, rtol=1e-4, err_msg=str(key))
        if step == 4:
            break
        jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
        nxt, caches = TF.decode_step(cfg, params, nxt, caches)
    assert near_half <= 8, near_half



@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax_bf16(arch, monkeypatch):
    """The same run in bf16: the logits of the prefill and of 4 decode
    steps within 2e-2, each side fed its own tokens (equal here), the JAX
    side op by op."""
    jcfg, jparams, cfg, params = _models(arch, "bf16")
    b, s, max_seq = 2, 10, 24
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jf, tf = _frames(cfg, b, "bf16")
    with _jax_logits_recorded(monkeypatch) as want:
        jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), JTF.init_caches(jcfg, b, max_seq), jf)
        for _ in range(4):
            jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
    caches = TF.init_caches(cfg, b, max_seq, device="cpu")
    logits, caches = TF.prefill_logits(cfg, params, torch.from_numpy(toks), caches, tf)
    got = [logits]
    for _ in range(4):
        logits, caches = TF.decode_logits(cfg, params, logits.argmax(-1).to(torch.int32), caches)
        got.append(logits)
    assert len(want) == len(got) == 5
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), w, **MODEL_TOL, err_msg=f"pass {t}")


def test_mla_with_kv_quant_builds_the_latent_cache_and_matches_jax():
    """minicpm3 with kv_quant: the reference's mla() cache (no int8, no
    scales), and prefill plus 4 decode steps with equal token ids in f32."""
    jcfg, jparams, cfg, params = _models("minicpm3-4b", "f32")
    b, s, max_seq = 2, 9, 20
    caches = TF.init_caches(cfg, b, max_seq, device="cpu")
    jc = JTF.init_caches(jcfg, b, max_seq)
    assert sorted(caches["layers"]) == sorted(jc["layers"]) == ["ckv", "krope", "lengths"]
    assert caches["layers"]["ckv"].dtype == torch.float32
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jnxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks), jc)
    nxt, caches = TF.prefill(cfg, params, torch.from_numpy(toks), caches)
    for _ in range(4):
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        jnxt, jc = JTF.decode_step(jcfg, jparams, jnxt, jc)
        nxt, caches = TF.decode_step(cfg, params, nxt, caches)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_engine_with_kv_quant_matches_jax_engine(arch):
    """The port's engine against the JAX engine with kv_quant (f32): more
    requests than slots, two prompt lengths, staggered finishes; olmoe's
    free slots also append and attend with the int8 cache."""
    jcfg, jparams, cfg, params = _models(arch, "f32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6 + 2 * (i % 2)).astype(np.int32) for i in range(5)]
    new = [4 + (i % 3) for i in range(5)]

    def serve(engine, req_cls):
        for i, p in enumerate(prompts):
            engine.submit(req_cls(i, p, new[i]))
        done = engine.run_until_done()
        assert len(done) == len(prompts)
        return {r.rid: r.out_tokens for r in done}

    want = serve(jax_engine.InstanceEngine(jcfg, jparams, n_slots=3, max_seq=40),
                 jax_engine.ServeRequest)
    eng = InstanceEngine(cfg, params, n_slots=3, max_seq=40)
    assert eng.caches["layers"]["k"].dtype == torch.int8
    assert serve(eng, ServeRequest) == want


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b", "whisper-large-v3"])
def test_payload_bytes_of_an_int8_cache_match_jax(arch):
    """The migrated bytes of a one-slot int8 cache (values, scales, lengths;
    the hybrid's SSM states; whisper's unquantized cross cache) equal the
    JAX package's count."""
    jcfg, _, cfg, _ = _models(arch, "bf16")
    for prompt_len, max_seq in ((7, 40), (512, 552)):
        want = jax_kvm.payload_bytes(JTF.init_caches(jcfg, 1, max_seq, abstract=True), prompt_len,
                                     max_seq)
        got = kv_migration.payload_bytes(TF.init_caches(cfg, 1, max_seq, device="cpu"), prompt_len,
                                         max_seq)
        assert got == want
