"""The port's model (``repro.models.transformer``), dense family with GQA or
MLA attention.

Parameters and caches are nested dicts of tensors with the JAX package's keys
and its stacked leading layer axis, so the JAX pytrees carry over one to one
(:mod:`repro_torch.models.bridge`).  ``lax.scan`` over the layer axis becomes
a Python loop; ``forward_layers_range`` runs layers ``[lo, hi)`` directly
(the JAX masked scan exists only to avoid a recompile per split point, and
eager PyTorch compiles nothing).

The norms and the attentions go through :mod:`repro_torch.kernels.ops`:
the hand-written kernels on CUDA, their plain versions on the CPU (MLA's
absorbed decode is plain products, as in the JAX package).  Caches are
updated in place.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention, kvcache, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TensorSpec

# ---------------------------------------------------------------------------
# Templates and init
# ---------------------------------------------------------------------------


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attn not in ("gqa", "mla") or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} attn={cfg.attn!r}: not yet ported "
            "(dense GQA and MLA only)"
        )


def _norm_spec(cfg) -> TensorSpec:
    return TensorSpec((cfg.d_model,), init="ones", dtype=cfg.dtype)


def layer_template(cfg) -> dict:
    """One attention+MLP block."""
    return {
        "norm1": _norm_spec(cfg),
        "norm2": _norm_spec(cfg),
        "attn": attention.mla_template(cfg) if cfg.attn == "mla" else attention.gqa_template(cfg),
        "mlp": layers.mlp_template(cfg),
    }


def param_template(cfg: ModelConfig) -> dict:
    """Full-model TensorSpec tree; ``layers`` leaves carry the stacked axis."""
    _check_family(cfg)
    return {
        "embed": layers.embedding_template(cfg),
        "layers": layers.stack_template(layer_template(cfg), cfg.n_layers),
        "final_norm": _norm_spec(cfg),
    }


def _init_leaf(spec: TensorSpec, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    std = layers.init_std(spec)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    # draw in f32 one layer slice at a time: the largest granite leaf is
    # 8.5 GB in f32 but one layer slice of it is 235 MB
    for part in out.unbind(0) if len(spec.shape) > 2 else (out,):
        noise = torch.randn(part.shape, generator=gen, dtype=torch.float32, device=device)
        part.copy_(noise.mul_(std))
    return out


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Random parameters with the reference's init law, drawn on ``device``
    from ``generator`` (or a seed).  The numbers differ from ``jax.random``'s:
    tests that compare with JAX carry the JAX weights over instead."""
    dev = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(generator))
    return layers.map_template(lambda s: _init_leaf(s, gen, dev), param_template(cfg))


# ---------------------------------------------------------------------------
# Per-layer views of the stacked trees
# ---------------------------------------------------------------------------


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _n_layers(stacked: dict) -> int:
    return stacked["norm1"].shape[0]


# ---------------------------------------------------------------------------
# Single-layer forwards
# ---------------------------------------------------------------------------


def _attn_layer_fwd(
    cfg, lp: dict, x: torch.Tensor, positions: torch.Tensor, *, causal: bool = True,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Full-sequence layer.  Returns (x, cache)."""
    h = ops.rmsnorm(x, lp["norm1"], eps=cfg.norm_eps)
    if cfg.attn == "mla":
        a, cache = attention.mla_prefill(lp["attn"], h, positions, cfg, cache=cache)
    else:
        a, cache = attention.gqa_prefill(lp["attn"], h, positions, cfg, causal=causal, cache=cache)
    x = x + a
    h2 = ops.rmsnorm(x, lp["norm2"], eps=cfg.norm_eps)
    return x + layers.mlp_forward(lp["mlp"], h2, cfg), cache


def _attn_layer_decode(
    cfg, lp: dict, x: torch.Tensor, cache: dict, live: torch.Tensor | None = None
) -> tuple[torch.Tensor, dict]:
    h = ops.rmsnorm(x, lp["norm1"], eps=cfg.norm_eps)
    decode = attention.mla_decode if cfg.attn == "mla" else attention.gqa_decode
    a, cache = decode(lp["attn"], h, cfg, cache, live=live)
    x = x + a
    h2 = ops.rmsnorm(x, lp["norm2"], eps=cfg.norm_eps)
    return x + layers.mlp_forward(lp["mlp"], h2, cfg), cache


# ---------------------------------------------------------------------------
# Caches and embedding
# ---------------------------------------------------------------------------


def init_caches(
    cfg: ModelConfig, batch: int, max_seq: int, device: str | torch.device | None = None
) -> dict:
    """Stacked per-layer decode caches, lengths (L, B): GQA k/v (L, B, KV, S,
    D); MLA ckv (L, B, S, kv_lora) and krope (L, B, S, rope)."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.attn == "mla":
        one = kvcache.init_mla_cache(
            batch, max_seq, cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.dtype, device=dev)
    else:
        one = kvcache.init_kv_cache(
            batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.dtype,
            quant=cfg.kv_quant, device=dev,
        )
    return {"layers": {k: v[None].repeat(cfg.n_layers, *([1] * v.dim())) for k, v in one.items()}}


def _embed(cfg, params, tokens):
    return layers.embed_tokens(params["embed"], tokens, cfg)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def _head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed of (B, 1, d) -> masked f32 logits (B, V)."""
    x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = layers.unembed(params["embed"], x, cfg)[:, 0]
    return layers.vocab_mask_logits(logits.float(), cfg)


# ---------------------------------------------------------------------------
# Train forward (full sequence, no caches; forward only)
# ---------------------------------------------------------------------------


def train_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Returns (logits (B, S, V), aux loss 0)."""
    _check_family(cfg)
    positions = _positions(tokens)
    x = _embed(cfg, params, tokens)
    for i in range(_n_layers(params["layers"])):
        x, _ = _attn_layer_fwd(cfg, layer_slice(params["layers"], i), x, positions)
    x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = layers.unembed(params["embed"], x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def prefill_logits(cfg: ModelConfig, params: dict, tokens: torch.Tensor, caches: dict):
    """Returns (last-position masked f32 logits (B, V), filled caches)."""
    _check_family(cfg)
    positions = _positions(tokens)
    x = _embed(cfg, params, tokens)
    for i in range(_n_layers(params["layers"])):
        x, _ = _attn_layer_fwd(
            cfg, layer_slice(params["layers"], i), x, positions,
            cache=layer_slice(caches["layers"], i),
        )
    return _head(cfg, params, x[:, -1:]), caches


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, caches: dict):
    """Returns (next-token ids (B,) int32, filled caches)."""
    logits, caches = prefill_logits(cfg, params, tokens, caches)
    return logits.argmax(dim=-1).to(torch.int32), caches


def decode_logits(
    cfg: ModelConfig, params: dict, last_tokens: torch.Tensor, caches: dict,
    live: torch.Tensor | None = None,
):
    """One step for every row.  ``live`` (B,) bool limits the cache append to
    live rows (the engine's free slots keep their caches).  Returns (masked
    f32 logits (B, V), caches)."""
    _check_family(cfg)
    x = layers.embed_tokens(params["embed"], last_tokens[:, None], cfg)
    for i in range(_n_layers(params["layers"])):
        x, _ = _attn_layer_decode(
            cfg, layer_slice(params["layers"], i), x, layer_slice(caches["layers"], i), live
        )
    return _head(cfg, params, x), caches


def decode_step(
    cfg: ModelConfig, params: dict, last_tokens: torch.Tensor, caches: dict,
    live: torch.Tensor | None = None,
):
    """One auto-regressive step.  Returns (next-token ids (B,) int32, caches)."""
    logits, caches = decode_logits(cfg, params, last_tokens, caches, live)
    return logits.argmax(dim=-1).to(torch.int32), caches


# ---------------------------------------------------------------------------
# Layer-range execution: the layer-level serving abstraction of live scaling
# ---------------------------------------------------------------------------


def forward_layers_range(
    cfg: ModelConfig,
    stacked_layers: dict,
    x: torch.Tensor,  # (B, S, d) activation entering layer `lo`
    lo: int,
    hi: int,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Run layers ``[lo, hi)`` of the main stack."""
    _check_family(cfg)
    for i in range(int(lo), int(hi)):
        x, _ = _attn_layer_fwd(cfg, layer_slice(stacked_layers, i), x, positions)
    return x
