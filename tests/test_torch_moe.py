"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``moe.moe_forward``, on olmoe-1b-7b REDUCED (8 experts, top-2).

Weights and inputs are drawn with numpy from a seed, each weight with std
1/sqrt(its fan-in) so that outputs are of order one (the reference's stacked
init law gives a 2-layer cut std 1/sqrt(2) and outputs in the hundreds, where
an f32 sum in another order alone exceeds 3e-5), and handed to both sides.
f32: output and aux loss at 3e-5 (tests/test_kernels.py's f32 tolerance;
the products sum in another order), in a drop-heavy case
(capacity_factor 0.25) and a drop-free one (8.0) as in
tests/test_moe_dispatch.py, with ``moe_group_size`` honoured, and with a
forced routing tie that must pick the lower expert index as ``lax.top_k``
does.  The non-gated experts of an MoE config whose ``mlp`` is not swiglu
(gelu, and gelu too for relu2, as the reference has it) in f32 and bf16.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import bridge, moe  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)


def _layer0(cf: float, dt: str = "f32", seed: int = 0, arch: str = "olmoe-1b-7b", **fields):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jcfg = jax_get_config(arch, reduced=True).replace(capacity_factor=cf, dtype=jd, **fields)
    cfg = get_config(arch, reduced=True).replace(capacity_factor=cf, dtype=td, **fields)
    rng = np.random.default_rng(seed)
    tree = {}
    for name, spec in JMOE.moe_template(jcfg).items():
        fan_in = spec.shape[-2]
        tree[name] = (rng.standard_normal(spec.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name != "router":
            tree[name] = np.asarray(jnp.asarray(tree[name], jd))
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    return jcfg, jp, cfg, bridge.params_from_numpy(tree, device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(jcfg, jp, cfg, p, x, **kw):
    jout, jaux = JMOE.moe_forward(jp, jnp.asarray(x, jcfg.dtype), jcfg, **kw)
    out, aux = moe.moe_forward(p, torch.from_numpy(x).to(cfg.dtype), cfg, **kw)
    return (np.asarray(jout.astype(jnp.float32)), float(jaux)), (out.float().numpy(), float(aux))


@pytest.mark.parametrize("cf", [0.25, 8.0], ids=["drop_heavy", "drop_free"])
@pytest.mark.parametrize("group_size", [None, 8, 5], ids=["cfg_group", "group8", "group5_padded"])
def test_moe_forward_matches_jax_f32(cf, group_size):
    """Output and aux loss at 3e-5.  group_size None uses cfg.moe_group_size
    (one group here); 5 leaves a padded tail group."""
    jcfg, jp, cfg, p = _layer0(cf)
    x = _x((2, 12, cfg.d_model), 1)
    (jout, jaux), (out, aux) = _both(jcfg, jp, cfg, p, x, group_size=group_size)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)


@pytest.mark.parametrize("s", [12, 300], ids=["one_group", "two_groups"])
def test_grok_moe_in_groups_of_512_matches_jax_f32(s):
    """grok-1's layer (REDUCED: 4 SwiGLU experts, top-2, moe_group_size 512
    as in the full config): 24 tokens form one group of 24 (capacity
    ceil(1.25 * 24 * 2 / 4) = 15), 600 tokens a group of 512 (capacity 320)
    and a padded one; output and aux loss at 3e-5."""
    jcfg, jp, cfg, p = _layer0(1.25, arch="grok-1-314b")
    assert cfg.moe_group_size == jcfg.moe_group_size == 512 and cfg.gated_mlp
    x = _x((2, s, cfg.d_model), 4)
    (jout, jaux), (out, aux) = _both(jcfg, jp, cfg, p, x)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)


def test_moe_drops_happen_in_the_drop_heavy_case():
    """capacity_factor 0.25 drops choices (output differs from the drop-free
    run), and the group size is honoured: another grouping drops others."""
    _, _, cfg_heavy, p = _layer0(0.25)
    cfg_free = cfg_heavy.replace(capacity_factor=8.0)
    x = torch.from_numpy(_x((2, 12, cfg_heavy.d_model), 1))
    heavy, _ = moe.moe_forward(p, x, cfg_heavy)
    free, _ = moe.moe_forward(p, x, cfg_free)
    assert not torch.allclose(heavy, free)
    grouped, _ = moe.moe_forward(p, x, cfg_heavy, group_size=8)
    assert not torch.allclose(heavy, grouped)
    by_cfg, _ = moe.moe_forward(p, x, cfg_heavy.replace(moe_group_size=8))
    assert torch.equal(grouped, by_cfg)


def test_moe_forward_matches_jax_bf16():
    """bf16, the JAX side run op by op: the dispatch copies token rows
    exactly, so the outputs agree at the reference's bf16 tolerance."""
    jcfg, jp, cfg, p = _layer0(1.25, "bf16")
    x = _x((1, 16, cfg.d_model), 2)
    with jax.disable_jit():
        (jout, jaux), (out, aux) = _both(jcfg, jp, cfg, p, x)
    np.testing.assert_allclose(out, jout, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(aux, jaux, atol=2e-2, rtol=2e-2)


def test_routing_tie_goes_to_the_lower_expert_like_jax():
    """A zero router makes every probability equal: lax.top_k picks experts
    0..k-1 in order, and so must the port (torch.topk promises no order).
    With capacity 1 per expert the first token takes every slot, so the
    tie order decides the whole output."""
    jcfg, jp, cfg, p = _layer0(0.25)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    probs = torch.full((3, cfg.n_experts), 1.0 / cfg.n_experts)
    _, idx = moe.route_topk(probs, cfg.top_k)
    assert idx.tolist() == [list(range(cfg.top_k))] * 3
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    x = _x((1, 6, cfg.d_model), 3)
    (jout, jaux), (out, aux) = _both(jcfg, jp, cfg, p, x)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)


def test_moe_template_matches_jax():
    jcfg, _, cfg, _ = _layer0(1.25)
    jt, tt = JMOE.moe_template(jcfg), moe.moe_template(cfg)
    assert jt.keys() == tt.keys()
    for name in jt:
        assert jt[name].shape == tt[name].shape and jt[name].init == tt[name].init


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mlp", ["gelu", "relu2"])
def test_non_gated_experts_match_jax(mlp, dt):
    """An MoE config whose mlp is not swiglu has non-gated experts (no
    w_gate): gelu in f32, tanh form, for gelu and, as the reference has it,
    for relu2 too.  f32 at 3e-5; bf16 with the JAX side op by op at 2e-2."""
    jcfg, jp, cfg, p = _layer0(1.25, dt, mlp=mlp)
    assert "w_gate" not in p and "w_gate" not in jp
    x = _x((2, 12, cfg.d_model), 5)
    with jax.disable_jit() if dt == "bf16" else contextlib.nullcontext():
        (jout, jaux), (out, aux) = _both(jcfg, jp, cfg, p, x)
    tol = TOL if dt == "f32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out, jout, **tol)
    np.testing.assert_allclose(aux, jaux, **tol)


def test_relu2_experts_apply_gelu_like_the_reference():
    """The reference's quirk, kept: relu2 experts compute what gelu experts
    compute on the same weights, not squared ReLU."""
    _, _, cfg, p = _layer0(1.25, mlp="gelu")
    x = torch.from_numpy(_x((1, 10, cfg.d_model), 6))
    gelu, _ = moe.moe_forward(p, x, cfg)
    relu2, _ = moe.moe_forward(p, x, cfg.replace(mlp="relu2"))
    assert torch.equal(gelu, relu2)
