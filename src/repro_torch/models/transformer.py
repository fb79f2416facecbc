"""The port's model (``repro.models.transformer``): every family of the JAX
package.

  dense / vlm : [norm1 -> GQA|MLA -> +res -> norm2 -> MLP -> +res]
  moe         : [norm1 -> GQA     -> +res -> norm2 -> MoE -> +res]
  ssm         : [norm1 -> Mamba2  -> +res]
  hybrid      : ssm layers, and one *shared* attention+MLP block (one
                parameter set, ``params["shared"]``) after every
                ``attn_every``-th layer, each site with its own cache
                (``caches["shared"]``, one per site)
  encdec      : an encoder of non-causal GQA + MLP blocks over the stub
                frames (``params["encoder"]``, then ``enc_norm``); each
                decoder block adds [norm_x -> cross-attention to the encoder
                output -> +res] after its self-attention, with the cross K/V
                computed once at prefill (``caches["cross"]``)
  vlm         : the stub patch frames overwrite the first token positions

Parameters and caches are nested dicts of tensors with the JAX package's keys
and its stacked leading layer axis, so the JAX pytrees carry over one to one
(:mod:`repro_torch.models.bridge`).  ``lax.scan`` over the layer axis becomes
a Python loop; ``forward_layers_range`` runs layers ``[lo, hi)`` directly
(the JAX masked scan exists only to avoid a recompile per split point, and
eager PyTorch compiles nothing).

The norms and the attentions go through :mod:`repro_torch.kernels.ops`:
the hand-written kernels on CUDA, their plain versions on the CPU (MLA's
absorbed decode, the MoE dispatch and the SSD scan are plain products, as in
the JAX package).  Caches are updated in place; a decode step given a
``live`` row mask leaves the caches and SSM states of the other rows as they
were, as the reference engine's select does (in MoE models, apart from the
one K/V entry at a free row's length, which is never read: see
``attention.gqa_decode``).  ``frames`` (B, Sf, d) feed the vlm and encdec
stub frontends in ``train_forward`` and the prefill; decode reads the cross
cache, and ``forward_layers_range`` runs an enc-dec decoder's layers
without cross-attention, as the reference's does.  Only the int8 cache
raises.

Training: ``lm_loss`` is the reference's cross-entropy (plus the MoE aux
loss) over ``train_forward``'s logits, and autograd differentiates it; on the
card the norms and the attentions take their backward kernels
(:mod:`repro_torch.kernels.ops`).  With ``cfg.remat`` and grad enabled,
``train_forward`` runs each layer (the hybrid: each group of ``attn_every``
layers and its shared block) under ``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint``: only the layer's input is
kept, and the backward recomputes the layer.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention, kvcache, layers, mamba2, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TensorSpec

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

# ---------------------------------------------------------------------------
# Templates and init
# ---------------------------------------------------------------------------


def _check_family(cfg: ModelConfig) -> None:
    if cfg.kv_quant:
        raise NotImplementedError(f"{cfg.name}: kv_quant (the int8 KV cache): not yet ported")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} (families {FAMILIES})")
    if cfg.family != "ssm" and cfg.attn not in ("gqa", "mla"):
        raise ValueError(
            f"{cfg.name}: family={cfg.family!r} has attention blocks, which need "
            f"attn 'gqa' or 'mla', got {cfg.attn!r}"
        )


def _is_ssm(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _norm_spec(cfg) -> TensorSpec:
    return TensorSpec((cfg.d_model,), init="ones", dtype=cfg.dtype)


def attn_layer_template(cfg, *, cross: bool = False) -> dict:
    """One attention block: attention, with ``cross`` a cross-attention
    (``norm_x``, ``xattn``), then the MLP or (MoE) the experts."""
    t = {
        "norm1": _norm_spec(cfg),
        "norm2": _norm_spec(cfg),
        "attn": attention.mla_template(cfg) if cfg.attn == "mla" else attention.gqa_template(cfg),
    }
    if cross:
        t["norm_x"] = _norm_spec(cfg)
        t["xattn"] = attention.gqa_template(cfg)
    if cfg.n_experts:
        t["moe"] = moe.moe_template(cfg)
    else:
        t["mlp"] = layers.mlp_template(cfg)
    return t


def layer_template(cfg) -> dict:
    """The per-layer template of the main stack."""
    if _is_ssm(cfg):
        return {"norm1": _norm_spec(cfg), "mixer": mamba2.mamba2_template(cfg)}
    return attn_layer_template(cfg, cross=cfg.family == "encdec")


def param_template(cfg: ModelConfig) -> dict:
    """Full-model TensorSpec tree; ``layers`` leaves carry the stacked axis."""
    _check_family(cfg)
    t = {
        "embed": layers.embedding_template(cfg),
        "layers": layers.stack_template(layer_template(cfg), cfg.n_layers),
        "final_norm": _norm_spec(cfg),
    }
    if cfg.family == "hybrid":
        t["shared"] = attn_layer_template(cfg)
    if cfg.family == "encdec":
        t["encoder"] = layers.stack_template(attn_layer_template(cfg), cfg.n_enc_layers)
        t["enc_norm"] = _norm_spec(cfg)
    return t


def n_layer_blocks(cfg: ModelConfig) -> int:
    """Multicast / live-scaling blocks: the main stack's layers, plus the
    enc-dec model's encoder layers or the hybrid's one shared block."""
    extra = {"encdec": cfg.n_enc_layers, "hybrid": 1}.get(cfg.family, 0)
    return cfg.n_layers + extra


def _init_leaf(spec: TensorSpec, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init in ("ssm_a", "ssm_dt"):
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=device)
        law = layers.ssm_a_from_uniform if spec.init == "ssm_a" else layers.ssm_dt_from_uniform
        return law(u).to(spec.dtype)
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


def _ffn(cfg, lp: dict, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's MLP, or its experts (with their aux loss)."""
    if cfg.n_experts:
        return moe.moe_forward(lp["moe"], h, cfg)
    return layers.mlp_forward(lp["mlp"], h, cfg), None


def _attn_layer_fwd(
    cfg, lp: dict, x: torch.Tensor, positions: torch.Tensor, *, causal: bool = True,
    cache: dict | None = None, cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Full-sequence attention block, writing ``cache`` when given; with
    ``cross_kv`` (the encoder output's K/V for this block) the
    cross-attention runs after the self-attention.  Returns (x, the MoE aux
    loss or None)."""
    h = ops.rmsnorm(x, lp["norm1"], eps=cfg.norm_eps)
    if cfg.attn == "mla":
        a, _ = attention.mla_prefill(lp["attn"], h, positions, cfg, cache=cache)
    else:
        a, _ = attention.gqa_prefill(lp["attn"], h, positions, cfg, causal=causal, cache=cache)
    x = x + a
    if cross_kv is not None:
        hx = ops.rmsnorm(x, lp["norm_x"], eps=cfg.norm_eps)
        ax, _ = attention.gqa_prefill(lp["xattn"], hx, positions, cfg, causal=False,
                                      kv_override=cross_kv)
        x = x + ax
    m, aux = _ffn(cfg, lp, ops.rmsnorm(x, lp["norm2"], eps=cfg.norm_eps))
    return x + m, aux


def _attn_layer_decode(
    cfg, lp: dict, x: torch.Tensor, cache: dict, live: torch.Tensor | None = None,
    cross: dict | None = None,
) -> torch.Tensor:
    h = ops.rmsnorm(x, lp["norm1"], eps=cfg.norm_eps)
    decode = attention.mla_decode if cfg.attn == "mla" else attention.gqa_decode
    a, _ = decode(lp["attn"], h, cfg, cache, live=live)
    x = x + a
    if cross is not None:
        hx = ops.rmsnorm(x, lp["norm_x"], eps=cfg.norm_eps)
        ax, _ = attention.gqa_decode(lp["xattn"], hx, cfg, cache, cross_cache=cross)
        x = x + ax
    m, _ = _ffn(cfg, lp, ops.rmsnorm(x, lp["norm2"], eps=cfg.norm_eps))
    return x + m


def _ssm_layer_fwd(cfg, lp: dict, x: torch.Tensor, state: dict | None = None) -> torch.Tensor:
    """Full-sequence Mamba2 block; with ``state``, the prefill writes the
    decode state into it."""
    h = ops.rmsnorm(x, lp["norm1"], eps=cfg.norm_eps)
    if state is None:
        return x + mamba2.mamba2_forward(lp["mixer"], h, cfg)
    out, new = mamba2.mamba2_prefill(lp["mixer"], h, cfg, state)
    kvcache.write_ssm_state(state, new)
    return x + out


def _ssm_layer_decode(
    cfg, lp: dict, x: torch.Tensor, state: dict, live: torch.Tensor | None = None
) -> torch.Tensor:
    h = ops.rmsnorm(x, lp["norm1"], eps=cfg.norm_eps)
    out, new = mamba2.mamba2_decode(lp["mixer"], h, cfg, state)
    kvcache.write_ssm_state(state, new, live)
    return x + out


def _is_site(cfg, i: int) -> bool:
    """Whether the hybrid's shared block runs after main-stack layer ``i``."""
    return cfg.family == "hybrid" and i % cfg.attn_every == cfg.attn_every - 1


# ---------------------------------------------------------------------------
# Caches and embedding
# ---------------------------------------------------------------------------


def _stack(one: dict, n: int) -> dict:
    return {k: v[None].repeat(n, *([1] * v.dim())) for k, v in one.items()}


def init_caches(
    cfg: ModelConfig, batch: int, max_seq: int, device: str | torch.device | None = None
) -> dict:
    """Stacked per-layer decode state.  ``layers``: GQA k/v (L, B, KV, S, D)
    and lengths (L, B); MLA ckv (L, B, S, kv_lora) and krope (L, B, S,
    rope); SSM conv (L, B, K-1, d_xbc) and h (L, B, H, P, N).  The hybrid's
    ``shared``: a GQA cache per site, (n_layers // attn_every, B, ...).  The
    enc-dec model's ``cross``: k/v (L, B, KV, n_frontend_tokens, D) and
    lengths (B,), written by the prefill."""
    _check_family(cfg)
    dev = resolve_device(device)

    def kv():
        return kvcache.init_kv_cache(
            batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.dtype,
            quant=cfg.kv_quant, device=dev,
        )

    if _is_ssm(cfg):
        caches = {"layers": _stack(kvcache.init_ssm_state(batch, cfg, device=dev), cfg.n_layers)}
        if cfg.family == "hybrid":
            caches["shared"] = _stack(kv(), cfg.n_layers // cfg.attn_every)
        return caches
    if cfg.attn == "mla":
        one = kvcache.init_mla_cache(
            batch, max_seq, cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.dtype, device=dev)
    else:
        one = kv()
    caches = {"layers": _stack(one, cfg.n_layers)}
    if cfg.family == "encdec":
        caches["cross"] = kvcache.init_cross_cache(
            cfg.n_layers, batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.dtype, device=dev)
    return caches


def _embed(cfg, params, tokens, frames=None):
    """Token embeddings (B, S, d); a vlm's patch frames (B, Sf, d), Sf <= S,
    overwrite the first Sf positions."""
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and frames is not None:
        x = torch.cat([frames.to(x.dtype), x[:, frames.shape[1]:]], dim=1)
    return x


def _run_encoder(cfg, params, frames) -> torch.Tensor:
    """The enc-dec model's encoder over the stub frame embeddings (cast to
    the model dtype): non-causal blocks with RoPE at positions 0..Sf-1, as
    the reference runs them, then ``enc_norm``."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the enc-dec model needs frames (B, Sf, d_model)")
    x = frames.to(cfg.dtype)
    pos = _positions(x[..., 0])
    for i in range(cfg.n_enc_layers):
        x, _ = _attn_layer_fwd(cfg, layer_slice(params["encoder"], i), x, pos, causal=False)
    return ops.rmsnorm(x, params["enc_norm"], eps=cfg.norm_eps)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def _head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed of (B, 1, d) -> masked f32 logits (B, V)."""
    x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = layers.unembed(params["embed"], x, cfg)[:, 0]
    return layers.vocab_mask_logits(layers.wide(logits), cfg)


def _forward(cfg, params: dict, x: torch.Tensor, positions: torch.Tensor, lo: int, hi: int,
             *, shared: dict | None = None, caches: dict | None = None,
             enc_out: torch.Tensor | None = None):
    """Main-stack layers [lo, hi) over a full sequence, the hybrid's shared
    block at its sites in that range (when ``shared`` is given), each block's
    cross-attention to ``enc_out`` (when given), writing ``caches`` (and the
    cross K/V into ``caches["cross"]``) when given.  Returns (x, summed MoE
    aux loss or None)."""
    aux = None
    for i in range(int(lo), int(hi)):
        lp = layer_slice(params, i)
        c = None if caches is None else layer_slice(caches["layers"], i)
        if _is_ssm(cfg):
            x = _ssm_layer_fwd(cfg, lp, x, state=c)
        else:
            xkv = None
            if enc_out is not None:
                xkv = attention.cross_kv(lp["xattn"], enc_out)
                if caches is not None:
                    kvcache.write_cross_kv(caches["cross"], i, *xkv)
            x, a = _attn_layer_fwd(cfg, lp, x, positions, cache=c, cross_kv=xkv)
            if a is not None:
                aux = a if aux is None else aux + a
        if shared is not None and _is_site(cfg, i):
            sc = None if caches is None else layer_slice(caches["shared"], i // cfg.attn_every)
            x, _ = _attn_layer_fwd(cfg, shared, x, positions, cache=sc)
    return x, aux


# ---------------------------------------------------------------------------
# Train forward (full sequence, no caches, remat over layers) and the loss
# ---------------------------------------------------------------------------


def _enc_out(cfg, params, frames):
    return _run_encoder(cfg, params, frames) if cfg.family == "encdec" else None


def train_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  frames: torch.Tensor | None = None):
    """Returns (logits (B, S, V), the MoE aux loss summed over layers; 0
    for the other families).  ``frames``: the vlm's patches or the encdec
    encoder's input.  With ``cfg.remat`` and grad enabled each layer (a
    hybrid's group of ``attn_every`` layers with its shared block) is
    checkpointed, as the reference's ``jax.checkpoint`` of its scan body;
    the encoder is not, as in the reference."""
    _check_family(cfg)
    positions = _positions(tokens)
    stacked, shared = params["layers"], params.get("shared")
    enc_out = _enc_out(cfg, params, frames)
    n = _n_layers(stacked)
    x = _embed(cfg, params, tokens, frames)
    if cfg.remat and torch.is_grad_enabled():
        unit = cfg.attn_every if cfg.family == "hybrid" else 1
        aux = None
        for lo in range(0, n, unit):
            x, a = checkpoint(
                lambda x, lo=lo: _forward(cfg, stacked, x, positions, lo, min(lo + unit, n),
                                          shared=shared, enc_out=enc_out),
                x, use_reentrant=False)
            if a is not None:
                aux = a if aux is None else aux + a
    else:
        x, aux = _forward(cfg, stacked, x, positions, 0, n, shared=shared, enc_out=enc_out)
    x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = layers.unembed(params["embed"], x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


def lm_loss(cfg: ModelConfig, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            frames: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels that are not -100, plus
    the MoE aux loss (the reference's ``lm_loss``): vocab-masked logits, an
    f32 log-sum-exp and the gold logit.  The reference's sharding
    annotations (the vocab-sharded logits) have no counterpart on one
    device."""
    logits, aux = train_forward(cfg, params, tokens, frames)
    lf = layers.wide(layers.vocab_mask_logits(logits, cfg))
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    m = lf.amax(dim=-1)
    lse = torch.log(torch.exp(lf - m[..., None]).sum(dim=-1)) + m
    gold = lf.gather(-1, safe[..., None])[..., 0]
    nll = lse - gold
    loss = (nll * valid).sum() / valid.sum().clamp_min(1)
    return loss + aux


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def prefill_logits(cfg: ModelConfig, params: dict, tokens: torch.Tensor, caches: dict,
                   frames: torch.Tensor | None = None):
    """Returns (last-position masked f32 logits (B, V), filled caches)."""
    _check_family(cfg)
    x, _ = _forward(cfg, params["layers"], _embed(cfg, params, tokens, frames), _positions(tokens),
                    0, _n_layers(params["layers"]), shared=params.get("shared"), caches=caches,
                    enc_out=_enc_out(cfg, params, frames))
    return _head(cfg, params, x[:, -1:].contiguous()), caches  # the rmsnorm kernel takes rows


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, caches: dict,
            frames: torch.Tensor | None = None):
    """Returns (next-token ids (B,) int32, filled caches)."""
    logits, caches = prefill_logits(cfg, params, tokens, caches, frames)
    return logits.argmax(dim=-1).to(torch.int32), caches


def decode_logits(
    cfg: ModelConfig, params: dict, last_tokens: torch.Tensor, caches: dict,
    live: torch.Tensor | None = None,
):
    """One step for every row.  ``live`` (B,) bool limits the cache and state
    writes to live rows (the engine's free slots keep theirs).  Returns
    (masked f32 logits (B, V), caches)."""
    _check_family(cfg)
    x = layers.embed_tokens(params["embed"], last_tokens[:, None], cfg)
    for i in range(_n_layers(params["layers"])):
        lp, c = layer_slice(params["layers"], i), layer_slice(caches["layers"], i)
        if _is_ssm(cfg):
            x = _ssm_layer_decode(cfg, lp, x, c, live)
        else:
            cross = None
            if cfg.family == "encdec":
                xc = caches["cross"]
                cross = {"k": xc["k"][i], "v": xc["v"][i], "lengths": xc["lengths"]}
            x = _attn_layer_decode(cfg, lp, x, c, live, cross)
        if _is_site(cfg, i):
            sc = layer_slice(caches["shared"], i // cfg.attn_every)
            x = _attn_layer_decode(cfg, params["shared"], x, sc, live)
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
    shared: dict | None = None,
) -> torch.Tensor:
    """Run layers ``[lo, hi)`` of the main stack, and the hybrid's shared
    block after each of its sites in that range when ``shared`` is given.
    An enc-dec decoder's layers run without their cross-attention, as the
    reference's masked scan runs them (it passes no encoder output)."""
    _check_family(cfg)
    x, _ = _forward(cfg, stacked_layers, x, positions, lo, hi, shared=shared)
    return x
