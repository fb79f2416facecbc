"""GQA attention of the port (``repro.models.attention``, GQA part).

``gqa_prefill`` runs the prompt through the flash-attention kernel and
``gqa_decode`` one token through the decode-attention kernel, both by way of
:mod:`repro_torch.kernels.ops` (the plain versions on a CPU tensor).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import kvcache
from repro_torch.models.layers import TensorSpec, apply_rope, rope_for


def gqa_template(cfg) -> dict[str, TensorSpec]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    t = {
        "wq": TensorSpec((d, h, hd), dtype=cfg.dtype),
        "wk": TensorSpec((d, kv, hd), dtype=cfg.dtype),
        "wv": TensorSpec((d, kv, hd), dtype=cfg.dtype),
        "wo": TensorSpec((h, hd, d), dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        t["bq"] = TensorSpec((h, hd), init="zeros", dtype=cfg.dtype)
        t["bk"] = TensorSpec((kv, hd), init="zeros", dtype=cfg.dtype)
        t["bv"] = TensorSpec((kv, hd), init="zeros", dtype=cfg.dtype)
    return t


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _gqa_qkv(params: dict, x: torch.Tensor, cfg):
    q = _proj_heads(x, params["wq"])
    k = _proj_heads(x, params["wk"])
    v = _proj_heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('...hk,hkd->...d') as one matrix product."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def gqa_prefill(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    cfg,
    *,
    causal: bool = True,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    q, k, v = _gqa_qkv(params, x, cfg)
    cos, sin = rope_for(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.flash_attention(q, k, v, causal=causal)
    if cache is not None:
        lengths = (positions[:, -1] + 1).to(torch.int32)
        cache = kvcache.write_prompt_kv(cache, k, v, lengths)
    return _out_proj(out, params["wo"]), cache


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg,
    cache: dict,
    *,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """One token against the cache.  RoPE takes the length before the append
    as the position; attention reads the length after it."""
    q, k, v = _gqa_qkv(params, x, cfg)
    pos = cache["lengths"][:, None]  # (B, 1)
    cos, sin = rope_for(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0]  # (B, H, D)
    k = apply_rope(k, cos, sin)[:, 0]  # (B, KV, D)
    cache = kvcache.append_kv(cache, k, v[:, 0], live)
    out = ops.decode_attention(q.contiguous(), cache["k"], cache["v"], cache["lengths"])
    return _out_proj(out, params["wo"])[:, None], cache
