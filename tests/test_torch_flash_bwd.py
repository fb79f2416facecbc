"""The flash backward's plain pieces against JAX, f32 on the CPU: each row's
log-sum-exp in the kernels' convention (``ref.flash_attention_lse_ref``)
and the backward rebuilt from it (``ref.flash_attention_bwd_ref(..., lse)``,
the formulas the kernels use), and the CPU dispatch of ``ops.flash_attention``.

Inputs are drawn with numpy from a seed and handed to both sides.  The
log-sum-exp is held against ``jax.scipy.special.logsumexp`` of the scaled
scores JAX computes, the gradients against ``jax.vjp`` of the reference's
``chunked_attention`` (src/repro/models/layers.py:118), both at 3e-5 of the
tensor's largest magnitude (tests/test_kernels.py's f32 tolerance, as
tests/test_torch_training.py holds the backward without the log-sum-exp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.scipy.special import logsumexp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import flash_attention as _flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 3e-5  # of each tensor's largest magnitude

# b, sq, sk, h, kv, d, causal, scale: causal and not, Sq != Sk, n_rep 1, 4
# and 12, head dims 16, 80 (zamba2), 96 (MLA) and 192 (nemotron)
SHAPES = [
    (2, 24, 24, 4, 4, 16, True, None),
    (1, 20, 36, 8, 2, 80, False, None),
    (1, 24, 24, 12, 1, 192, True, None),
    (2, 20, 33, 12, 1, 96, False, 0.05),
    (1, 40, 40, 8, 2, 96, True, 0.3),
    (1, 30, 18, 4, 1, 80, True, None),
    (1, 17, 45, 12, 1, 16, False, 0.3),
    (2, 33, 33, 4, 1, 192, True, 0.05),
]
IDS = ["causal-nrep1-d16", "cross-nrep4-d80", "causal-nrep12-d192", "cross-nrep12-d96-scale",
       "causal-nrep4-d96-scale", "causal-sq>sk-nrep4-d80", "cross-nrep12-d16-scale",
       "causal-nrep4-d192-scale"]


def _close(got, want, what=""):
    """|got - want| <= TOL * max|want| everywhere."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()), err_msg=what)


def _inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, kv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,scale", SHAPES, ids=IDS)
def test_flash_attention_lse_ref_matches_jax_logsumexp(b, sq, sk, h, kv, d, causal, scale):
    """log2-domain log-sum-exp of the scaled scores: logsumexp(s) log2(e)."""
    q, k, _, _ = _inputs(3, b, sq, sk, h, kv, d)
    sc = scale if scale is not None else 1.0 / np.sqrt(d)
    kr = jnp.repeat(jnp.asarray(k), h // kv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kr) * sc
    if causal:
        s = jnp.where(jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :], s, -jnp.inf)
    want = logsumexp(s, axis=-1) * np.log2(np.e)
    got = ref.flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                                      softmax_scale=scale)
    assert got.dtype == torch.float32
    _close(got, want, "lse")


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,scale", SHAPES, ids=IDS)
def test_flash_attention_bwd_ref_with_lse_matches_jax_vjp(b, sq, sk, h, kv, d, causal, scale):
    """P rebuilt from the forward's log-sum-exp, as the kernels do it."""
    q, k, v, do = _inputs(4, b, sq, sk, h, kv, d)

    def attn(q, k, v):
        return JL.chunked_attention(q, k, v, causal=causal, softmax_scale=scale,
                                    q_chunk=16, kv_chunk=16)

    jo, vjp = jax.vjp(attn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, softmax_scale=scale)
    _close(o, jo, "o")
    lse = ref.flash_attention_lse_ref(tq, tk, causal=causal, softmax_scale=scale)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, torch.from_numpy(do), lse, causal=causal,
                                      softmax_scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


def test_ops_flash_attention_on_the_cpu_differentiates_the_plain_path(monkeypatch):
    """On CPU tensors ops.flash_attention takes the plain version even with
    grad required: no kernel wrapper is called (so no log-sum-exp is asked
    for), no launch is counted, and the gradients are autograd's of the
    plain version."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called on the CPU")

    monkeypatch.setattr(_flash, "flash_attention", refuse)
    monkeypatch.setattr(_flash, "flash_attention_bwd", refuse)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 1, 12, 12, 4, 2, 16))
    grads = {}
    for fn in (ops.flash_attention, ref.flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = ops.launch_counts()
        out = fn(*leaves)
        assert type(out.grad_fn).__name__ != "_FlashAttentionBackward"
        out.backward(do)
        assert ops.launch_counts() == before
        grads[fn] = [t.grad for t in leaves]
    for g, w in zip(grads[ops.flash_attention], grads[ref.flash_attention_ref]):
        assert torch.equal(g, w)
