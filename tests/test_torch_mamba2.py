"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against the JAX
package's ``models/mamba2.py``, at 1e-4 (the reference's own tolerance,
tests/test_models.py:90-91), in f32.

``ssd_chunked`` and ``ssd_reference`` on inputs drawn with numpy;
``mamba2_prefill`` (output and state) and ``mamba2_decode`` on layer 0 of
mamba2-370m REDUCED, carried over by the bridge.
The port's ``init_params`` is held to the reference's ``ssm_a`` / ``ssm_dt``
laws, with ``a_log`` holding A itself.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import bridge, kvcache, layers, mamba2  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _ssd_inputs(seed, b=2, s=64, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a = -np.exp(rng.uniform(size=(h,))).astype(np.float32)
    b_in = rng.standard_normal((b, s, g, n)).astype(np.float32)
    c_in = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, b_in, c_in, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    arrs = _ssd_inputs(0)
    h0 = arrs[5] if with_h0 else None
    jy, jh = JM.ssd_chunked(*map(jnp.asarray, arrs[:5]), chunk,
                            None if h0 is None else jnp.asarray(h0))
    y, h = mamba2.ssd_chunked(*map(torch.from_numpy, arrs[:5]), chunk,
                              None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_ssd_reference_matches_jax_and_the_chunked_form():
    arrs = _ssd_inputs(1, s=32)
    jy, jh = JM.ssd_reference(*map(jnp.asarray, arrs[:5]), h_init=jnp.asarray(arrs[5]))
    y, h = mamba2.ssd_reference(*map(torch.from_numpy, arrs[:5]), h_init=torch.from_numpy(arrs[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    yc, hc = mamba2.ssd_chunked(*map(torch.from_numpy, arrs[:5]), 8, torch.from_numpy(arrs[5]))
    np.testing.assert_allclose(yc.numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(hc.numpy(), h.numpy(), **TOL)


def _layer0():
    """Layer 0's mixer: A, dt_bias, the skip and the norm from the JAX init;
    the three matrices redrawn with numpy at std 1/sqrt(fan-in), so that
    activations are of order one (the stacked init law gives a 2-layer cut
    std 1/sqrt(2), where f32 sums in another order alone exceed 1e-4)."""
    jcfg = jax_get_config("mamba2-370m", reduced=True).replace(dtype=jnp.float32)
    cfg = get_config("mamba2-370m", reduced=True).replace(dtype=torch.float32)
    mixer = JTF.init_params(jax.random.PRNGKey(4), jcfg)["layers"]["mixer"]
    tree = jax.tree.map(lambda a: np.asarray(a[0]), mixer)
    rng = np.random.default_rng(7)
    for name in ("in_proj", "conv_w", "out_proj"):
        shape = tree[name].shape
        tree[name] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    return jcfg, jp, cfg, bridge.params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("s", [2, 20, 32], ids=["shorter_than_conv", "padded", "chunk_multiple"])
def test_mamba2_prefill_output_and_state_match_jax(s):
    """Output, conv tail and final h; 20 tokens pad to 32 with dt = 0, and 2
    tokens left-pad the conv tail."""
    jcfg, jp, cfg, p = _layer0()
    u = np.random.default_rng(5).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jout, jst = JM.mamba2_prefill(jp, jnp.asarray(u), jcfg, JKV.init_ssm_state(2, jcfg))
    out, st = mamba2.mamba2_prefill(p, torch.from_numpy(u), cfg,
                                    kvcache.init_ssm_state(2, cfg, device="cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name in ("conv", "h"):
        assert st[name].dtype == (cfg.dtype if name == "conv" else torch.float32)
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]), **TOL)
    fwd = mamba2.mamba2_forward(p, torch.from_numpy(u), cfg)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(JM.mamba2_forward(jp, jnp.asarray(u), jcfg)), **TOL)


def test_mamba2_decode_matches_jax_over_steps():
    """Three recurrent steps from a prefill state: outputs and states."""
    jcfg, jp, cfg, p = _layer0()
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    _, jst = JM.mamba2_prefill(jp, jnp.asarray(u), jcfg, JKV.init_ssm_state(2, jcfg))
    st = bridge.caches_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    for _ in range(3):
        step = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = JM.mamba2_decode(jp, jnp.asarray(step), jcfg, jst)
        out, st = mamba2.mamba2_decode(p, torch.from_numpy(step), cfg, st)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for name in ("conv", "h"):
            np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]), **TOL)


def test_ssm_state_layout_and_live_mask():
    """init_ssm_state's shapes and dtypes are the JAX ones; write_ssm_state
    keeps the rows that are not live."""
    cfg = get_config("zamba2-2.7b", reduced=True)
    jst = JKV.init_ssm_state(3, jax_get_config("zamba2-2.7b", reduced=True))
    st = kvcache.init_ssm_state(3, cfg, device="cpu")
    for name in ("conv", "h"):
        assert tuple(st[name].shape) == jst[name].shape
    assert st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    new = {k: torch.ones_like(v) for k, v in st.items()}
    kvcache.write_ssm_state(st, new, torch.tensor([True, False, True]))
    for v in st.values():
        assert v[0].eq(1).all() and v[1].eq(0).all() and v[2].eq(1).all()


def test_init_params_follows_the_ssm_laws():
    """a_log holds A = -exp(u log 16) in [-16, -1]; softplus(dt_bias) lies in
    [1e-3, 1e-1], as the reference's ssm_a and ssm_dt laws draw them."""
    cfg = get_config("mamba2-370m", reduced=True)
    mixer = TF.init_params(cfg, 0, device="cpu")["layers"]["mixer"]
    a = mixer["a_log"]
    assert a.dtype == torch.float32 and a.shape == (cfg.n_layers, cfg.ssm_nheads)
    assert bool((a <= -1.0).all()) and bool((a >= -16.0).all())
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool((dt >= 1e-3 * (1 - 1e-5)).all()) and bool((dt <= 1e-1 * (1 + 1e-5)).all())
    u = torch.tensor([0.0, 0.5, 0.999])
    np.testing.assert_allclose(layers.ssm_a_from_uniform(u).numpy(),
                               -np.exp(u.numpy() * np.log(16.0)), rtol=1e-6)
    dt = np.exp(u.numpy() * np.log(100.0) + np.log(1e-3))
    np.testing.assert_allclose(layers.ssm_dt_from_uniform(u).numpy(), dt + np.log(-np.expm1(-dt)),
                               rtol=1e-5)
