"""Sequence-sharded attention in the port, piece by piece, against the JAX
package on the CPU: the plain decode with its log-sum-exp over cache slices
merged by ``ops.merge_partials`` (flash-decoding), MLA's absorbed decode
over latent cache blocks merged the same way, the plain flash forward and
backward with a query offset row block by row block, the kernel path's
dispatch at an offset, the dry-run's gathers and FLOPs, and the SSD scan
on blocks of heads (the sharded SSM mixer's).

Inputs come from numpy seeds and go to both sides.  Tolerances are the
reference's (tests/test_kernels.py:16-17): f32 3e-5, bf16 2e-2.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as _flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import bridge, kvcache  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = {"f32": dict(atol=3e-5, rtol=3e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# cuts of a 40-row cache into slices: even, uneven, with empty slices (a
# block start past every length, and a zero-row tail as a ceil split of 40
# over 6 gives no such thing but a hand cut does)
CUTS = {"even4": [0, 10, 20, 30, 40], "uneven": [0, 7, 19, 20, 33, 40],
        "empty": [0, 5, 5, 12, 40, 40]}
LENGTHS = [40, 12, 5, 0, 1, 33]  # the last rows: one of length 0, one ending in the first slice


def _decode_inputs(seed, dt, quant, b=6, h=8, kv=2, s=40, d=32):
    """(torch q, k, v, k_scale, v_scale, lengths) and the same for JAX."""
    rng = np.random.default_rng(seed)
    td, jd = DTYPES[dt]
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kf = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    vf = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    lens = np.asarray(LENGTHS[:b], np.int32)
    tq = torch.from_numpy(q).to(td)
    if quant:
        k, ks = kvcache.quantize_kv(torch.from_numpy(kf))
        v, vs = kvcache.quantize_kv(torch.from_numpy(vf))
        tk, tv, tks, tvs = k, v, ks, vs
    else:
        tk, tv, tks, tvs = torch.from_numpy(kf).to(td), torch.from_numpy(vf).to(td), None, None
    jx = [jnp.asarray(q, jd)] + [jnp.asarray(t.numpy()) if t.dtype == torch.int8 else
                                  jnp.asarray(t.float().numpy(), jd) for t in (tk, tv)]
    jscales = {} if not quant else {"k_scale": jnp.asarray(tks.numpy()), "v_scale": jnp.asarray(tvs.numpy())}
    return (tq, tk, tv, tks, tvs, torch.from_numpy(lens)), (jx, jscales, jnp.asarray(lens))


def _merged_decode(q, k, v, ks, vs, lens, cuts):
    """The plain decode with lse over each slice [a, b) of the cache, its
    lengths cut to the slice, merged."""
    outs, lses = [], []
    for a, b in zip(cuts, cuts[1:]):
        sl = (slice(None), slice(None), slice(a, b))
        scales = {} if ks is None else {"k_scale": ks[sl].contiguous(), "v_scale": vs[sl].contiguous()}
        part = (lens - a).clamp(0, b - a).to(torch.int32)
        o, lse = ops._decode_slice(q, k[sl].contiguous(), v[sl].contiguous(), part, "ref", **scales)
        outs.append(o)
        lses.append(lse)
    return ops.merge_partials(torch.stack(outs), torch.stack(lses))


def _lse_f64(q, k, ks, lens):
    """Each head's log2-sum-exp of the scaled scores over its valid rows, in
    f64 with numpy (-inf for a row of length 0)."""
    qf, kf = q.double().numpy(), k.double().numpy()
    b, h, d = qf.shape
    kv = kf.shape[1]
    s = np.einsum("bgrd,bgsd->bgrs", qf.reshape(b, kv, h // kv, d), kf) / math.sqrt(d)
    if ks is not None:
        s = s * ks.double().numpy()[:, :, None, :]
    out = np.full((b, h), -np.inf)
    for i, n in enumerate(lens.tolist()):
        if n:
            row = s[i, :, :, :n].reshape(h, n)
            m = row.max(-1, keepdims=True)
            out[i] = (m[:, 0] + np.log(np.exp(row - m).sum(-1))) / math.log(2)
    return out


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("dt,quant", [("f32", False), ("bf16", False), ("f32", True), ("bf16", True)])
def test_decode_slices_merged_match_jax(dt, quant, cut):
    """Slices merged = JAX's decode_attention_reference over the whole
    cache (int8 with its scales too); rows of length 0 give out 0 and lse
    -inf, as the kernel does (the reference averages V there); the merged
    lse is the whole cache's, against numpy in f64."""
    (q, k, v, ks, vs, lens), (jx, jscales, jlens) = _decode_inputs(1, dt, quant)
    out, lse = _merged_decode(q, k, v, ks, vs, lens, CUTS[cut])
    want = np.asarray(JL.decode_attention_reference(*jx, jlens, **jscales).astype(jnp.float32))
    live = lens.numpy() > 0
    np.testing.assert_allclose(out.numpy()[live], want[live], **TOL[dt])
    assert torch.equal(out[~torch.from_numpy(live)], torch.zeros_like(out[~torch.from_numpy(live)]))
    want_lse = _lse_f64(q, k, ks, lens)
    assert np.array_equal(np.isinf(lse.numpy()), ~live[:, None].repeat(q.shape[1], 1))
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live], **TOL["f32"])


@pytest.mark.parametrize("quant", [False, True])
def test_decode_lse_of_the_whole_cache(quant):
    """The plain decode's (out, lse) over the whole cache: out is the
    model's oracle's (where the length is not 0), lse the f64 one, and one
    slice merged alone gives both back."""
    (q, k, v, ks, vs, lens), _ = _decode_inputs(2, "f32", quant)
    scales = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True, **scales)
    live = lens > 0
    torch.testing.assert_close(out[live], ref.decode_attention_ref(q, k, v, lens, **scales)[live],
                               **TOL["f32"])
    np.testing.assert_allclose(lse.numpy()[live.numpy()], _lse_f64(q, k, ks, lens)[live.numpy()],
                               **TOL["f32"])
    one, one_lse = ops.merge_partials(out[None], lse[None])
    torch.testing.assert_close(one[live], out[live], atol=1e-6, rtol=1e-6)
    assert torch.equal(one_lse.isinf(), lse.isinf())


def test_decode_lse_is_the_flash_lse():
    """A decode head's lse is flash_attention_lse_ref's for the same query
    as one non-causal row over the valid keys: one convention (log2 of the
    scaled scores) for both kernels where a row has keys."""
    (q, k, v, _, _, lens), _ = _decode_inputs(3, "f32", False)
    _, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    for i, n in enumerate(lens.tolist()):
        if n:
            want = ref.flash_attention_lse_ref(q[i:i + 1, None], k[i:i + 1, :, :n].transpose(1, 2),
                                               causal=False)
            torch.testing.assert_close(lse[i], want[0, :, 0], **TOL["f32"])


def test_merge_partials_is_exact_and_deterministic():
    """The merge of two slices' partials equals the softmax over their union
    in f32, and the same partials give the same bits every time; a row with
    no key in any slice gives out 0 and lse -inf."""
    rng = np.random.default_rng(4)
    outs = torch.from_numpy(rng.standard_normal((3, 2, 4, 8)).astype(np.float32))
    lses = torch.from_numpy(rng.standard_normal((3, 2, 4)).astype(np.float32) * 5)
    lses[1, 0, 0] = float("-inf")
    lses[:, 1, 3] = float("-inf")
    out, lse = ops.merge_partials(outs, lses)
    w = torch.exp2(lses.double() - lses.double().amax(0).nan_to_num(neginf=0.0))
    want = (w[..., None] * outs.double()).sum(0) / w.sum(0).clamp_min(1e-300)[..., None]
    torch.testing.assert_close(out.double(), want, atol=1e-6, rtol=1e-6)
    assert torch.equal(out[1, 3], torch.zeros(8)) and lse[1, 3].item() == float("-inf")
    again = ops.merge_partials(outs.clone(), lses.clone())
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


# MLA's latent cache of 40 rows cut into blocks: one (the unsharded bits),
# two, even, uneven and with empty blocks (zero rows, and blocks past a
# row's length)
MLA_CUTS = {"one": [0, 40], "two": [0, 20, 40], **CUTS}
MLA_LENGTHS = [39, 11, 4, 0]  # before the step's append: 40, 12, 5 and 1 after it


def _mla_step_inputs(dt, seed):
    """minicpm3-4b REDUCED's layer-0 attention on both sides (JAX's init,
    bridged), a latent cache of 40 rows filled from numpy to MLA_LENGTHS,
    and one token's x: (JAX's (cfg, layer params, cache, x), the port's)."""
    jd, td = DTYPES[dt][1], DTYPES[dt][0]
    jcfg = jax_get_config("minicpm3-4b", reduced=True).replace(dtype=jd)
    cfg = get_config("minicpm3-4b", reduced=True).replace(dtype=td)
    jparams = JTF.init_params(jax.random.PRNGKey(seed), jcfg)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    lp = TF.layer_slice(params["layers"]["attn"], 0)
    rng = np.random.default_rng(seed)
    b, s = len(MLA_LENGTHS), MLA_CUTS["one"][-1]
    cache = {"ckv": torch.from_numpy(rng.standard_normal((b, s, cfg.kv_lora_rank)).astype(np.float32)),
             "krope": torch.from_numpy(rng.standard_normal((b, s, cfg.qk_rope_dim)).astype(np.float32))}
    cache = {k: v.to(td) for k, v in cache.items()}
    cache["lengths"] = torch.tensor(MLA_LENGTHS, dtype=torch.int32)
    jcache = {k: jnp.asarray(v.float().numpy(), jd) if v.is_floating_point() else jnp.asarray(v.numpy())
              for k, v in cache.items()}
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    return (jcfg, jlp, jcache, jnp.asarray(x, jd)), (cfg, lp, cache, torch.from_numpy(x).to(td))


def _mla_merged_core(cuts):
    """``ops.mla_decode_attention`` as the sharded path computes it: the
    block function over each block [a, e) of the latent cache from its
    start a, the blocks' (ctx, lse) merged."""
    def core(q_abs, q_rope, ckv, krope, lengths, *, softmax_scale):
        parts = [ops.mla_decode_block(q_abs, q_rope, ckv[:, a:e], krope[:, a:e], lengths,
                                      softmax_scale=softmax_scale, start=a, return_lse=True)
                 for a, e in zip(cuts, cuts[1:])]
        ctx, _ = ops.merge_partials(torch.stack([c for c, _ in parts]),
                                    torch.stack([x for _, x in parts]))
        return ctx
    return core


@pytest.mark.parametrize("cut", list(MLA_CUTS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_decode_blocks_merged_match_jax(monkeypatch, dt, cut):
    """One ``mla_decode`` step of minicpm3-4b REDUCED with its core run as
    the sequence-sharded path runs it (the block function over each block,
    merged) against JAX's ``mla_decode`` on the same bridged parameters,
    latent cache and token, at the reference's tolerance; one block is
    bit-equal to the port's unsharded step, and the caches are the
    unsharded step's."""
    (jcfg, jlp, jcache, jx), (cfg, lp, cache, x) = _mla_step_inputs(dt, 9)
    with jax.disable_jit():  # op by op, as tests/test_torch_mla.py runs bf16
        jout, _ = JA.mla_decode(jlp, jx, jcfg, jcache)
    plain_cache = {k: v.clone() for k, v in cache.items()}
    plain, plain_cache = TA.mla_decode(lp, x, cfg, plain_cache)
    monkeypatch.setattr(ops, "mla_decode_attention", _mla_merged_core(MLA_CUTS[cut]))
    out, cache = TA.mla_decode(lp, x, cfg, cache)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)), **TOL[dt])
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(), **TOL[dt])
    if cut == "one":
        assert torch.equal(out, plain)
    for k in cache:
        assert torch.equal(cache[k], plain_cache[k]), k


def _lse2_f64(s, n):
    """Each row's log2-sum-exp of its first n scores, in f64 with numpy."""
    row = s[..., :n].astype(np.float64)
    m = row.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(row - m).sum(-1))) / math.log(2)


def test_mla_decode_block_lse_and_keyless_blocks():
    """The block function's lse is the log2-sum-exp of the block's scaled
    scores over its valid rows (numpy, f64), -inf where the block holds no
    key of the row (a row past its length, a block of no rows, whose ctx
    is 0 too); without ``return_lse`` ctx has the same bits; merged over
    every cut, ctx and lse are the whole cache's, and a row of length 0
    gives ctx 0 and lse -inf (every block keyless)."""
    rng = np.random.default_rng(11)
    b, h, r, rope, s = 5, 4, 16, 8, 40
    q_abs, ckv = (torch.from_numpy(rng.standard_normal(x).astype(np.float32))
                  for x in ((b, h, r), (b, s, r)))
    q_rope, krope = (torch.from_numpy(rng.standard_normal(x).astype(np.float32))
                     for x in ((b, h, rope), (b, s, rope)))
    lens = torch.tensor([40, 12, 5, 0, 1], dtype=torch.int32)
    scale = 1.0 / math.sqrt(24)
    kw = dict(softmax_scale=scale)
    ctx, lse = ops.mla_decode_block(q_abs, q_rope, ckv, krope, lens, return_lse=True, **kw)
    assert torch.equal(ops.mla_decode_block(q_abs, q_rope, ckv, krope, lens, **kw), ctx)
    scores = (np.einsum("bhr,bsr->bhs", q_abs.double().numpy(), ckv.double().numpy())
              + np.einsum("bhk,bsk->bhs", q_rope.double().numpy(), krope.double().numpy())) * scale
    for i, n in enumerate(lens.tolist()):
        if n:
            np.testing.assert_allclose(lse[i].numpy(), _lse2_f64(scores[i], n), **TOL["f32"])
        else:
            assert lse[i].isinf().all() and (lse[i] < 0).all()
    late, late_lse = ops.mla_decode_block(q_abs, q_rope, ckv[:, 20:], krope[:, 20:], lens,
                                          start=20, return_lse=True, **kw)
    assert torch.isfinite(late_lse[0]).all() and late_lse[1:].isinf().all()
    assert torch.isfinite(late).all()
    none, none_lse = ops.mla_decode_block(q_abs, q_rope, ckv[:, 40:], krope[:, 40:], lens,
                                          start=40, return_lse=True, **kw)
    assert none.shape == (b, h, r) and not none.any() and none_lse.isinf().all()
    live = lens > 0
    for cut in MLA_CUTS.values():
        parts = [ops.mla_decode_block(q_abs, q_rope, ckv[:, a:e], krope[:, a:e], lens,
                                      start=a, return_lse=True, **kw) for a, e in zip(cut, cut[1:])]
        merged, merged_lse = ops.merge_partials(torch.stack([c for c, _ in parts]),
                                                torch.stack([x for _, x in parts]))
        torch.testing.assert_close(merged[live], ctx[live], **TOL["f32"])
        torch.testing.assert_close(merged_lse[live], lse[live], **TOL["f32"])
        assert not merged[~live].any() and merged_lse[~live].isinf().all()


FLASH_CASES = {  # name -> (b, s, h, kv, d, v_dim, row cuts)
    "gqa4": (2, 48, 8, 2, 32, 32, [0, 12, 24, 36, 48]),
    "gqa4-uneven": (1, 37, 8, 2, 64, 64, [0, 10, 20, 30, 37]),
    "mla96": (1, 40, 4, 4, 96, 64, [0, 5, 17, 40]),
    "gqa4-long": (1, 200, 8, 2, 16, 16, [0, 70, 131, 200]),  # offsets past 64, not multiples of it
}


def _flash_inputs(case, seed):
    """numpy q, k, v and dO of a FLASH_CASES case: V zero past v_dim (as
    mla_prefill pads it), and dO too (the padded columns are sliced off
    the output, so their gradient is 0)."""
    b, s, h, kv, d, vd, _ = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal(sh).astype(np.float32) for sh in ((b, s, h, d), (b, s, kv, d)))
    v = np.zeros((b, s, kv, d), np.float32)
    v[..., :vd] = rng.standard_normal((b, s, kv, vd))
    do = np.zeros((b, s, h, d), np.float32)
    do[..., :vd] = rng.standard_normal((b, s, h, vd))
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_q_offset_blocks_match_jax(case, causal):
    """The plain flash forward over q's row blocks, each at its offset, then
    concatenated = JAX's chunked_attention over the whole q (GQA n_rep 4;
    MLA's D = 96 with V zero-padded from 64 and the scale 1/sqrt(96), as
    mla_prefill calls it), in f32; each block's lse = the whole q's lse rows."""
    b, s, h, kv, d, vd, cuts = FLASH_CASES[case]
    q, k, v, _ = _flash_inputs(case, 5)
    scale = 1.0 / math.sqrt(d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = torch.cat([ops.flash_attention(tq[:, a:e], tk, tv, causal=causal, softmax_scale=scale,
                                         q_offset=a) for a, e in zip(cuts, cuts[1:])], dim=1)
    want = JL.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                q_chunk=16, kv_chunk=16, softmax_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])
    assert not got[..., vd:].any()
    whole = ref.flash_attention_lse_ref(tq, tk, causal=causal, softmax_scale=scale)
    for a, e in zip(cuts, cuts[1:]):
        part = ref.flash_attention_lse_ref(tq[:, a:e], tk, causal=causal, softmax_scale=scale,
                                           q_offset=a)
        torch.testing.assert_close(part, whole[..., a:e], **TOL["f32"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_bwd_q_offset_blocks_match_jax(case, causal):
    """The plain backward (``flash_attention_bwd_ref``, P rebuilt from the
    block's lse as the kernels do) over q's row blocks, each at its offset,
    against ``jax.vjp`` of chunked_attention over the whole q with a
    cotangent that is zero outside the block's rows: the block's dq is that
    dq's rows, its dk and dv that dk and dv, in f32; under causal the keys
    past the block's last row get dk = dv = 0 exactly; the blocks' dq
    concatenated and their dk and dv summed are the whole vjp."""
    b, s, h, kv, d, vd, cuts = FLASH_CASES[case]
    q, k, v, do = _flash_inputs(case, 7)
    scale = 1.0 / math.sqrt(d)

    def attn(q, k, v):
        return JL.chunked_attention(q, k, v, causal=causal, q_chunk=16, kv_chunk=16,
                                    softmax_scale=scale)

    _, vjp = jax.vjp(attn, *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=causal, softmax_scale=scale)
    dqs, dk_sum, dv_sum = [], torch.zeros_like(tk), torch.zeros_like(tv)
    for a, e in zip(cuts, cuts[1:]):
        ct = np.zeros_like(do)
        ct[:, a:e] = do[:, a:e]
        jdq, jdk, jdv = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
        qb = tq[:, a:e]
        o = ref.flash_attention_ref(qb, tk, tv, q_offset=a, **kw)
        lse = ref.flash_attention_lse_ref(qb, tk, q_offset=a, **kw)
        dq, dk, dv = ref.flash_attention_bwd_ref(qb, tk, tv, o, tdo[:, a:e], lse, q_offset=a, **kw)
        np.testing.assert_allclose(dq.numpy(), jdq[:, a:e], **TOL["f32"], err_msg=f"dq [{a}, {e})")
        np.testing.assert_allclose(dk.numpy(), jdk, **TOL["f32"], err_msg=f"dk [{a}, {e})")
        np.testing.assert_allclose(dv.numpy(), jdv, **TOL["f32"], err_msg=f"dv [{a}, {e})")
        if causal:
            assert not dk[:, e:].any() and not dv[:, e:].any(), f"keys past row {e - 1} of [{a}, {e})"
        dqs.append(dq)
        dk_sum += dk
        dv_sum += dv
    jdq, jdk, jdv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    np.testing.assert_allclose(torch.cat(dqs, dim=1).numpy(), jdq, **TOL["f32"])
    np.testing.assert_allclose(dk_sum.numpy(), jdk, **TOL["f32"])
    np.testing.assert_allclose(dv_sum.numpy(), jdv, **TOL["f32"])
    assert not dv_sum[..., vd:].any()


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_path_takes_the_offset_forward_and_backward(monkeypatch, causal):
    """The kernel path's dispatch on the CPU (``_use_kernel`` forced on, each
    wrapper swapped for its plain version): a call at an offset that needs
    a gradient goes through ``_FlashAttention``, whose forward asks for the
    lse at that offset and whose backward is the backward wrapper at the
    same offset; its gradients are autograd's of the plain version at it."""
    seen = []

    def fwd(q, k, v, *, causal, softmax_scale, return_lse, q_offset):
        seen.append(("fwd", return_lse, q_offset))
        o = ref.flash_attention_ref(q, k, v, causal=causal, softmax_scale=softmax_scale,
                                    q_offset=q_offset)
        return o, ref.flash_attention_lse_ref(q, k, causal=causal, softmax_scale=softmax_scale,
                                              q_offset=q_offset)

    def bwd(q, k, v, o, do, lse, *, causal, softmax_scale, q_offset):
        seen.append(("bwd", q_offset))
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                           softmax_scale=softmax_scale, q_offset=q_offset)

    monkeypatch.setattr(ops, "_use_kernel", lambda impl, t: True)
    monkeypatch.setattr(_flash, "flash_attention", fwd)
    monkeypatch.setattr(_flash, "flash_attention_bwd", bwd)
    q, k, v, do = (torch.from_numpy(a) for a in _flash_inputs("gqa4-long", 8))
    a, e = 70, 131
    grads = {}
    for path in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q[:, a:e], k, v)]
        fn = ops.flash_attention if path == "kernel" else ref.flash_attention_ref
        out = fn(*leaves, causal=causal, q_offset=a)
        out.backward(do[:, a:e])
        grads[path] = [t.grad for t in leaves]
    assert seen == [("fwd", True, a), ("bwd", a)]
    for g, w in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(g, w, **TOL["f32"])


def test_flash_bwd_rejects_a_negative_offset():
    """The backward wrapper refuses q_offset < 0, as the forward does,
    before it looks at the device."""
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="q_offset >= 0"):
        _flash.flash_attention_bwd(x, x, x, x, x, causal=True, q_offset=-1)


def test_flash_q_offset_past_the_keys():
    """Causal rows whose offset puts them past every key (a cross-length
    call) see all keys; a non-causal call ignores the offset."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 4, 2, 16), (1, 6, 2, 16), (1, 6, 2, 16)))
    full = ops.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=True, q_offset=5), full)
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=False, q_offset=3), full)


def _dryrun(tmp_path, arch: str, shape: str) -> dict:
    """One dry-run cell on the single-pod mesh (256 fake ranks), in a
    subprocess: its record."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "single", "--out", str(tmp_path), "--force"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return json.loads((tmp_path / f"{arch}__{shape}__single.json").read_text())


DRYRUN_GATHER_BEFORE = 2_415_968_256  # granite-8b decode_32k, single mesh, per device, gathering the cache


def test_dryrun_granite_decode_32k_gathers_no_cache(tmp_path):
    """The dry-run of granite-8b ``decode_32k`` on the single-pod mesh (256
    fake ranks, in a subprocess): its all-gathers move under 1% of the
    2,415,968,256 bytes a device that gathering each layer's cache shard
    moved; the cell is ok."""
    rec = _dryrun(tmp_path, "granite-8b", "decode_32k")
    assert rec["ok"]
    assert rec["coll_by_op"]["all_gather_into_tensor"] < 0.01 * DRYRUN_GATHER_BEFORE, rec["coll_by_op"]


# minicpm3-4b decode_32k, single mesh, a device: all-gather bytes while each
# layer gathered its (B, H, S_loc) scores, and temp bytes then
DRYRUN_MLA_GATHER_BEFORE = 162_603_008
DRYRUN_MLA_TEMP_BEFORE = 2_752_002_560


def test_dryrun_minicpm3_decode_32k_keeps_the_latent_cache(tmp_path):
    """The dry-run of minicpm3-4b ``decode_32k`` on the single-pod mesh (256
    fake ranks, in a subprocess): with the latent cache's sequence shard
    kept (each layer gathers its (ctx, lse) partials, not its scores), its
    all-gathers move under 20% of the 162,603,008 bytes a device of the
    gathered scores, and its temp bytes are no more than they were then;
    the cell is ok."""
    rec = _dryrun(tmp_path, "minicpm3-4b", "decode_32k")
    assert rec["ok"]
    assert rec["coll_by_op"]["all_gather_into_tensor"] < 0.2 * DRYRUN_MLA_GATHER_BEFORE, rec["coll_by_op"]
    assert rec["temp_bytes_per_dev"] <= DRYRUN_MLA_TEMP_BEFORE


DRYRUN_FLOPS_BEFORE = 6.764e14  # qwen1.5-4b train_4k, single mesh, dot FLOPs a device, q gathered under autograd


def test_dryrun_qwen_train_4k_keeps_q_local(tmp_path):
    """The dry-run of qwen1.5-4b ``train_4k`` on the single-pod mesh (256
    fake ranks, in a subprocess; "seq" over the 16-way "model" axis): with q
    a local sequence shard in the forward and backward, a device's dot
    FLOPs are at most 1.6e14, not the 6.764e14 of every rank computing the
    whole sequence's attention; the cell is ok."""
    rec = _dryrun(tmp_path, "qwen1.5-4b", "train_4k")
    assert rec["ok"]
    assert rec["dot_flops_per_dev"] <= 1.6e14 < DRYRUN_FLOPS_BEFORE, rec["dot_flops_per_dev"]


def test_variant_counts_reset_with_the_kernels():
    """The variants' counters (decode with lse, the flash forward and
    backward with a query offset) reset with the kernels' and stay out of
    ``launch_counts``."""
    ops.reset_launch_counts()
    assert ops.variant_counts() == {"decode_attention_lse": 0, "flash_attention_q_offset": 0,
                                    "flash_attention_bwd_q_offset": 0}
    assert set(ops.launch_counts()) == set(ops.KERNELS)
    with ops.uncounted():
        from repro_torch.kernels import decode_attention as dk
        dk.lse_launches += 3
    assert ops.variant_counts()["decode_attention_lse"] == 0


# The SSD scan's heads cut by hand into the blocks a mesh gives each rank
# (B and C of one group whole beside each block): (first head of each block, end)
SSD_CUTS = {"whole": [0, 8], "four": [0, 2, 4, 6, 8], "uneven": [0, 3, 8]}


@pytest.mark.parametrize("h_init", [False, True])
@pytest.mark.parametrize("cut", list(SSD_CUTS))
def test_ssd_head_blocks_match_jax(cut, h_init):
    """``mamba2.ssd_chunked`` on each block of heads (x, dt, A and the
    initial state cut, B and C of the one group whole: what a rank of the
    sharded mixer runs) against JAX's ``ssd_chunked`` on all heads: each
    block's y and final state within 1e-5 (f32) of JAX's rows of those
    heads, with and without an initial state."""
    from repro.models import mamba2 as JM
    from repro_torch.models import mamba2 as TM

    rng = np.random.default_rng(29)
    b, s, h, p, n, chunk = 2, 32, 8, 4, 6, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus'd
    a = -np.exp(rng.uniform(0, np.log(16.0), h)).astype(np.float32)
    bc = [rng.standard_normal((b, s, 1, n)).astype(np.float32) for _ in range(2)]
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if h_init else None
    want_y, want_h = JM.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, *bc)), chunk,
                                    None if h0 is None else jnp.asarray(h0))
    starts = SSD_CUTS[cut]
    for lo, hi in zip(starts, starts[1:]):
        y, hf = TM.ssd_chunked(torch.from_numpy(x[:, :, lo:hi]), torch.from_numpy(dt[..., lo:hi]),
                               torch.from_numpy(a[lo:hi]), *map(torch.from_numpy, bc), chunk,
                               None if h0 is None else torch.from_numpy(h0[:, lo:hi]))
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y)[:, :, lo:hi], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h)[:, lo:hi], rtol=1e-5, atol=1e-5)
