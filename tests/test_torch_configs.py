"""The other archs of the JAX package registered in the port (dense GQA,
MLA for minicpm3-4b, MoE olmoe-1b-7b and grok-1-314b, SSM mamba2-370m,
hybrid zamba2-2.7b, squared-ReLU nemotron-4-340b, enc-dec whisper-large-v3,
VLM pixtral-12b): each config equals the JAX one field by field, at full
size and at REDUCED, and at REDUCED in f32 the port's prefill logits equal
the JAX model's on the same (bridged) weights; the two stub frontends get
the same frames, drawn with numpy from a seed."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.layers import vocab_mask_logits as jax_vocab_mask  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

ARCHS = ["llama3-8b", "qwen1.5-4b", "mistral-24b", "qwen2.5-72b", "minicpm3-4b",
         "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b", "grok-1-314b", "nemotron-4-340b",
         "whisper-large-v3", "pixtral-12b"]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch, reduced):
    jcfg = jax_get_config(arch, reduced=reduced)
    cfg = get_config(arch, reduced=reduced)
    jf, tf = _fields(jcfg), _fields(cfg)
    assert jcfg.dtype == jnp.bfloat16 and cfg.dtype == torch.bfloat16
    jf.pop("dtype"), tf.pop("dtype")
    assert tf == jf
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert cfg.padded_vocab_size == jcfg.padded_vocab_size
    assert cfg.approx_params() == jcfg.approx_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_equal_jax_f32(arch):
    """A 10-token prefill of two sequences: f32 logits of the last position
    against JAX's forward at 1e-4 (sums in another order), and next-token
    ids equal to JAX's prefill.  JAX initialises qkv biases to
    zero, so they are drawn at random here to exercise the bias path."""
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, reduced=True).replace(dtype=torch.float32)
    jparams = JTF.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    if jcfg.qkv_bias:
        attn = jparams["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.standard_normal(attn[name].shape).astype(np.float32))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    frames = jframes = None
    if cfg.family in ("vlm", "encdec"):
        frames = (rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
        jframes, frames = jnp.asarray(frames), torch.from_numpy(frames)
    jnxt, _ = JTF.prefill(jcfg, jparams, jnp.asarray(toks), JTF.init_caches(jcfg, 2, 32), jframes)
    jlogits, _ = JTF.train_forward(jcfg, jparams, jnp.asarray(toks), jframes)
    want = np.asarray(jax_vocab_mask(jlogits[:, -1].astype(jnp.float32), jcfg))
    logits, _ = TF.prefill_logits(cfg, params, torch.from_numpy(toks),
                                  TF.init_caches(cfg, 2, 32, device="cpu"), frames)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(jnxt))
    np.testing.assert_allclose(logits.float().numpy(), want, atol=1e-4, rtol=1e-4)
