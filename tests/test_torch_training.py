"""The port's training path against the JAX package at REDUCED size, f32 on
the CPU: the plain backward versions of the two kernels, ``lm_loss`` and its
gradients for every family, AdamW, the train step with and without
microbatches, remat, the data pipeline, and the kernel dispatch of the
gradient path.

Weights are made by the JAX init and carried over through the bridge; tokens,
labels and frames are drawn with numpy from a seed and handed to both sides.
Tolerances: the plain backward versions and the gradients 3e-5 of each
tensor's (leaf's) largest magnitude (tests/test_kernels.py's f32 tolerance);
AdamW rtol 1e-5 (tests/test_training.py:74).
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import attention as JATT  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JMAMBA  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro.training.train_step import build_train_step as jax_build_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import flash_attention as _flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as _rmsnorm  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training.train_step import build_train_step  # noqa: E402

TOL = 3e-5  # of each tensor's largest magnitude
FAMILY_ARCHS = ["granite-8b", "minicpm3-4b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b",
                "whisper-large-v3", "pixtral-12b"]
OPT_CFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _close(got, want, what=""):
    """|got - want| <= TOL * max|want| everywhere."""
    got, want = (t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
                 for t in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, reduced=True).replace(dtype=torch.float32)
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg


def _port_params(arch):
    jcfg, jparams, cfg = _models(arch)
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _batch(cfg, b=2, s=12, seed=3):
    """numpy tokens, labels with some -100, and frames for vlm / encdec."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.2] = -100
    out = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.family in ("vlm", "encdec"):
        out["frames"] = (rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch):
    """The port's lm_loss and its autograd gradient tree."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in _flat(params).items()}

    def tree(flat):
        out = {}
        for path, v in flat.items():
            d = out
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = v
        return out

    tb = _torch_batch(batch)
    loss = TF.lm_loss(cfg, tree(leaves), tb["tokens"], tb["labels"], tb.get("frames"))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, {k: torch.zeros_like(p) if g is None else g
                  for (k, p), g in zip(leaves.items(), grads)}


# ---------------------------------------------------------------------------
# The plain backward versions against jax.vjp of the reference's oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 48)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape):
    rng = np.random.default_rng(0)
    x, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = (1 + 0.3 * rng.standard_normal(shape[-1:])).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: JL.rmsnorm(x, w, 1e-5), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    dx, dw = ref.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    _close(dx, jdx, "dx")
    _close(dw, jdw, "dw")


@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d,causal,scale",
    [(2, 24, 24, 4, 4, 16, True, None), (2, 24, 24, 8, 2, 64, True, None),
     (1, 20, 36, 4, 1, 16, False, None), (2, 20, 36, 4, 4, 64, False, 0.05),
     (1, 40, 40, 8, 2, 16, True, 0.3)],
    ids=["causal-nrep1-d16", "causal-nrep4-d64", "cross-nrep4-d16", "cross-nrep1-d64-scale",
         "causal-nrep4-d16-scale"])
def test_flash_attention_bwd_ref_matches_jax_vjp(b, sq, sk, h, kv, d, causal, scale):
    rng = np.random.default_rng(1)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, kv, d)).astype(np.float32) for _ in range(2))

    def attn(q, k, v):
        return JL.chunked_attention(q, k, v, causal=causal, softmax_scale=scale,
                                    q_chunk=16, kv_chunk=16)

    jo, vjp = jax.vjp(attn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, softmax_scale=scale)
    _close(o, jo, "o")
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, torch.from_numpy(do), causal=causal,
                                      softmax_scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


def test_bwd_refs_equal_autograd_of_the_plain_forwards():
    """The explicit formulas are the plain forwards' gradients."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal(32).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    torch.autograd.backward(ref.rmsnorm_ref(x, w), g)
    dx, dw = ref.rmsnorm_bwd_ref(x.detach(), w.detach(), g)
    _close(dx, x.grad, "dx")
    _close(dw, w.grad, "dw")
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32)).requires_grad_()
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    o = ref.flash_attention_ref(q, k, v)
    torch.autograd.backward(o, do)
    for got, t in zip(ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do),
                      (q, k, v)):
        _close(got, t.grad)


# ---------------------------------------------------------------------------
# lm_loss and its gradients, every family
# ---------------------------------------------------------------------------


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``: handed to the
    reference's model modules in place of their ``jnp``, it turns each of
    their f32 upcasts into an f64 one, so that under x64 the whole loss and
    its gradient run in float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_f64_grads(arch, batch, monkeypatch):
    """JAX's own lm_loss gradient in float64 on the same weights and inputs:
    the witness of exact arithmetic, independent of the port."""
    jcfg, jparams, _ = _models(arch)
    with monkeypatch.context() as m, jax.enable_x64(True):
        for mod in (JTF, JL, JATT, JMOE, JMAMBA):
            m.setattr(mod, "jnp", _Wide())
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jparams)
        jb = {k: jnp.asarray(v.astype(np.float64) if k == "frames" else v) for k, v in batch.items()}
        cfg64 = jcfg.replace(dtype=jnp.float64)
        grads = jax.grad(lambda p: JTF.lm_loss(cfg64, p, jb["tokens"], jb["labels"], jb.get("frames")))(p64)
        out = _flat(jax.tree.map(np.asarray, grads))
    assert all(v.dtype == np.float64 for v in out.values())
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_lm_loss_and_grads_match_jax(arch, monkeypatch):
    """The loss within 3e-5 and each gradient leaf within 3e-5 of its largest
    magnitude of JAX's.  Where a leaf is farther, JAX's own gradient in
    float64 witnesses that f32 rounding, not a fault, set the distance: the
    port's leaf may be no farther from it than 3x JAX's f32 leaf is.
    Measured (largest over the leaves, of the leaf's scale; port and JAX
    f32 distances from JAX f64): granite's attention wk 3.03e-5 (6.7e-5,
    9.3e-5), olmoe's wq 1.1e-3 (4.5e-4, 1.55e-3: the port is the nearer
    on every far leaf, at most 0.36x JAX's distance), zamba2's a_log
    3.05e-5 (1.3e-5, 1.75e-5), whisper's wk 1.26e-3 (6.1e-4, 6.5e-4: under
    the reference's init law at REDUCED size both f32 runs sit ~6e-4 of the
    scale from exact; the port's largest ratio is 2.31x, at the encoder's
    norm1); minicpm3, mamba2 and pixtral within 3e-5 of JAX."""
    jcfg, jparams, cfg = _models(arch)
    batch = _batch(cfg)
    jb = _jax_batch(batch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JTF.lm_loss(jcfg, p, jb["tokens"], jb["labels"], jb.get("frames")))(jparams)
    loss, grads = _loss_and_grads(cfg, _port_params(arch), batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert grads.keys() == want.keys()
    far = {}
    for key, w in want.items():
        g = grads[key].detach().double().numpy()
        if np.abs(g - w).max() > TOL * np.abs(w).max():
            far[key] = (g, w.astype(np.float64))
    if far:
        exact = _jax_f64_grads(arch, batch, monkeypatch)
        for key, (g, w) in far.items():
            e = exact[key]
            assert np.abs(g - e).max() <= 3 * np.abs(w - e).max(), (
                key, np.abs(g - w).max(), np.abs(g - e).max(), np.abs(w - e).max())


def test_lm_loss_ignores_masked_labels():
    """Labels of -100 add nothing: the loss equals the mean over the rest."""
    _, _, cfg = _models("granite-8b")
    params = _port_params("granite-8b")
    batch = _batch(cfg)
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits, _ = TF.train_forward(cfg, params, tb["tokens"])
        logp = torch.log_softmax(logits[..., :cfg.vocab_size].float(), dim=-1)
        lab = tb["labels"].long()
        keep = lab != -100
        want = -logp.gather(-1, lab.clamp_min(0)[..., None])[..., 0][keep].mean()
        got = TF.lm_loss(cfg, params, tb["tokens"], tb["labels"])
    _close(got, want)


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b", "olmoe-1b-7b"])
def test_remat_gives_the_same_grads(arch):
    """Checkpointing each layer (zamba2: each group with its shared block)
    recomputes the same numbers: remat on and off give equal gradients."""
    _, _, cfg = _models(arch)
    params = _port_params(arch)
    batch = _batch(cfg)
    l1, g1 = _loss_and_grads(cfg.replace(remat=True), params, batch)
    l0, g0 = _loss_and_grads(cfg.replace(remat=False), params, batch)
    assert torch.equal(l1, l0)
    for key in g0:
        assert torch.equal(g1[key], g0[key]), key


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _np_tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1e9, 0.5], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(clip):
    kw = dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01, grad_clip=clip,
              warmup_steps=2, total_steps=10, min_lr_frac=0.1)
    jcfg, cfg = JOPT.AdamWConfig(**kw), OPT.AdamWConfig(**kw)
    rng = np.random.default_rng(4)
    shapes = {"w": (3, 5), "b": (7,), "z": (2, 2, 2)}
    p = _np_tree(rng, shapes)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jopt, topt = JOPT.adamw_init(jp, jcfg), OPT.adamw_init(tp, cfg)
    for step in range(4):
        g = _np_tree(rng, shapes)
        jp, jopt, jm = JOPT.adamw_update(jp, jax.tree.map(jnp.asarray, g), jopt, jcfg)
        tp, topt, tm = OPT.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                        topt, cfg)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (topt["m"][k], jopt["m"][k]),
                              (topt["v"][k], jopt["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-5)


def test_adamw_bf16_params_and_moments_match_jax():
    """bf16 parameters and bf16 moments: the update math in f32, each leaf
    cast back as the reference casts it."""
    kw = dict(lr=0.05, warmup_steps=0, total_steps=10)
    jcfg = JOPT.AdamWConfig(moment_dtype=jnp.bfloat16, **kw)
    cfg = OPT.AdamWConfig(moment_dtype=torch.bfloat16, **kw)
    rng = np.random.default_rng(5)
    p = rng.standard_normal((4, 6)).astype(np.float32)
    g = rng.standard_normal((4, 6)).astype(np.float32)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    jp, jopt, _ = JOPT.adamw_update(jp, {"w": jnp.asarray(g)}, JOPT.adamw_init(jp, jcfg), jcfg)
    tp, topt, _ = OPT.adamw_update(tp, {"w": torch.from_numpy(g)}, OPT.adamw_init(tp, cfg), cfg)
    assert tp["w"].dtype == topt["m"]["w"].dtype == torch.bfloat16
    for got, want in ((tp["w"], jp["w"]), (topt["m"]["w"], jopt["m"]["w"]),
                      (topt["v"]["w"], jopt["v"]["w"])):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2)


def test_lr_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
               dict(lr=3e-4, warmup_steps=0, total_steps=7), dict(lr=2.0, warmup_steps=5, total_steps=5)):
        jcfg, cfg = JOPT.AdamWConfig(**kw), OPT.AdamWConfig(**kw)
        for step in (0, 1, 4, 5, 10, 55, 99, 100, 150):
            np.testing.assert_allclose(float(OPT.lr_at(cfg, step)),
                                       float(JOPT.lr_at(jcfg, jnp.int32(step))), rtol=1e-6, atol=1e-9)


def test_grad_clipping_bounds_the_update():
    """The norm is reported unclipped; the step moves each weight by at
    most lr (Adam's normalised step) as the clipped gradient drives it."""
    cfg = OPT.AdamWConfig(lr=1.0, grad_clip=0.5, warmup_steps=0, total_steps=10,
                          weight_decay=0.0, min_lr_frac=1.0)
    p = {"w": torch.zeros(4)}
    _, opt, metrics = OPT.adamw_update(p, {"w": torch.full((4,), 100.0)},
                                       OPT.adamw_init(p, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(p["w"].abs().max()) <= 1.0 + 1e-6
    # the first moment holds the clipped gradient's share: (1 - b1) * 100 * 0.5 / 200
    np.testing.assert_allclose(opt["m"]["w"].numpy(), np.full(4, 0.1 * 0.25, np.float32), rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_jax(micro):
    """Three steps of loss -> grad -> AdamW from the same weights on the
    same batches: every loss, grad norm and final parameter.  The
    parameters within 1e-4 of each leaf's scale: three Adam steps at lr
    1e-3 normalise each gradient element, so an element whose gradient is
    a rounding error apart can move by a few 1e-6 more or less."""
    jcfg, jparams, cfg = _models("granite-8b")
    jopt_cfg, opt_cfg = JOPT.AdamWConfig(**OPT_CFG), OPT.AdamWConfig(**OPT_CFG)
    jstep = jax.jit(jax_build_train_step(jcfg, jopt_cfg, microbatches=micro))
    tstep = build_train_step(cfg, opt_cfg, microbatches=micro)
    jp, jo = jparams, JOPT.adamw_init(jparams, jopt_cfg)
    tp = _port_params("granite-8b")
    to = OPT.adamw_init(tp, opt_cfg)
    for step in range(3):
        batch = pipeline.make_batch(cfg, 4, 16, step=step, seed=1)
        jp, jo, jm = jstep(jp, jo, _jax_batch(batch))
        tp, to, tm = tstep(tp, to, _torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(to["step"]) == 3
    want = _flat(jax.tree.map(np.asarray, jp))
    got = _flat(tp)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=str(key))


def test_microbatches_accumulate_the_full_batch_gradient():
    """Two microbatches of 2 give the full batch of 4's loss and gradient
    (f32 accumulation): the first step's updated weights agree within the
    tolerance of the reference's own test (tests/test_training.py:49)."""
    _, _, cfg = _models("granite-8b")
    opt_cfg = OPT.AdamWConfig(**OPT_CFG)
    batch = _torch_batch(pipeline.make_batch(cfg, 4, 16, step=0, seed=2))
    out = {}
    for micro in (1, 2):
        p = _port_params("granite-8b")
        p, _, m = build_train_step(cfg, opt_cfg, microbatches=micro)(p, OPT.adamw_init(p, opt_cfg), batch)
        out[micro] = (float(m["loss"]), _flat(p))
    assert out[1][0] == pytest.approx(out[2][0], rel=1e-5)
    for key, a in out[1][1].items():
        np.testing.assert_allclose(a.numpy(), out[2][1][key].numpy(), atol=5e-3, rtol=5e-2)


def test_train_step_leaves_the_callers_tensors_without_grad():
    _, _, cfg = _models("granite-8b")
    opt_cfg = OPT.AdamWConfig(**OPT_CFG)
    p = _port_params("granite-8b")
    batch = _torch_batch(pipeline.make_batch(cfg, 2, 8, step=0))
    p, o, _ = build_train_step(cfg, opt_cfg)(p, OPT.adamw_init(p, opt_cfg), batch)
    assert not any(t.requires_grad for t in OPT.tree_leaves(p))
    assert not any(t.requires_grad for t in OPT.tree_leaves(o))


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host,n_hosts", [(0, 0, 0, 1), (7, 3, 1, 2), (3, 11, 3, 4)])
def test_pipeline_batches_equal_the_reference(seed, step, host, n_hosts):
    kw = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=seed)
    a = pipeline.SyntheticTokenPipeline(**kw).host_slice(step, host, n_hosts)
    b = jax_pipeline.SyntheticTokenPipeline(**kw).host_slice(step, host, n_hosts)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["granite-8b", "whisper-large-v3"])
def test_make_batch_equals_the_reference(arch):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch, reduced=True)
    a = pipeline.make_batch(cfg, 4, 16, step=5, seed=2)
    b = jax_pipeline.make_batch(jcfg, 4, 16, step=5, seed=2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# Dispatch of the gradient path
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_kernels(monkeypatch):
    """``_use_kernel`` forced on, and each kernel wrapper swapped for its
    plain version with a launch counter: the kernel path's control flow on
    the CPU."""
    calls = types.SimpleNamespace(rms=0, rms_bwd=0, flash=0, flash_bwd=0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            setattr(calls, name, getattr(calls, name) + 1)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ops, "_use_kernel", lambda impl, t: (impl or ops._default[0]) != "ref")
    monkeypatch.setattr(_rmsnorm, "fused_rmsnorm", counted("rms", ref.rmsnorm_ref))
    monkeypatch.setattr(_rmsnorm, "fused_rmsnorm_bwd", counted("rms_bwd", ref.rmsnorm_bwd_ref))
    monkeypatch.setattr(_flash, "flash_attention", counted("flash", ref.flash_attention_ref))
    monkeypatch.setattr(_flash, "flash_attention_bwd", counted("flash_bwd", ref.flash_attention_bwd_ref))
    return calls


def test_autograd_function_is_taken_iff_grad_is_required(fake_kernels):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    w = torch.ones(16)
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    # no input requires grad, or grad is disabled: the kernel, no autograd node
    for ctx in (torch.enable_grad, torch.no_grad):
        with ctx():
            wg = w.clone().requires_grad_(ctx is torch.no_grad)
            assert ops.rmsnorm(x, wg).grad_fn is None
            qg = q.clone().requires_grad_(ctx is torch.no_grad)
            assert ops.flash_attention(qg, kv, kv).grad_fn is None
    assert (fake_kernels.rms, fake_kernels.flash) == (2, 2)
    # an input requires grad: the Function, its backward the backward kernel
    xg = x.clone().requires_grad_()
    out = ops.rmsnorm(xg, w)
    assert type(out.grad_fn).__name__ == "_RMSNormBackward"
    g = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    out.backward(g)
    assert (fake_kernels.rms, fake_kernels.rms_bwd) == (3, 1)
    _close(xg.grad, ref.rmsnorm_bwd_ref(x, w, g)[0])
    kg = kv.clone().requires_grad_()
    o = ops.flash_attention(q, kg, kv, causal=False)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.sum().backward()
    assert (fake_kernels.flash, fake_kernels.flash_bwd) == (3, 1)
    _close(kg.grad, ref.flash_attention_bwd_ref(q, kv, kv, o.detach(), torch.ones_like(o),
                                                causal=False)[1])


def test_kernel_path_grads_and_launches_of_a_train_step(fake_kernels):
    """granite REDUCED through the kernel path's control flow: the loss and
    every gradient equal the plain path's within 3e-5 of the leaf, and the
    launches per microbatch are the path's formula with remat: forward
    flash L and rmsnorm 2L+1, the recompute L and 2L, backward
    flash_attention_bwd L and rmsnorm_bwd 2L+1."""
    _, _, cfg = _models("granite-8b")
    params = _port_params("granite-8b")
    batch = _batch(cfg)
    loss, grads = _loss_and_grads(cfg, params, batch)
    L = cfg.n_layers
    assert (fake_kernels.flash, fake_kernels.rms) == (2 * L, 4 * L + 1)
    assert (fake_kernels.flash_bwd, fake_kernels.rms_bwd) == (L, 2 * L + 1)
    with ops.use_impl("ref"):  # the plain path, autograd through the plain versions
        want_loss, want = _loss_and_grads(cfg, params, batch)
    _close(loss, want_loss, "loss")
    for key, w in want.items():
        _close(grads[key], w, str(key))
