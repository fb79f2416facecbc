"""Attention of the port (``repro.models.attention``): GQA and MLA.

``gqa_prefill`` runs the prompt through the flash-attention kernel and
``gqa_decode`` one token through the decode-attention kernel, both by way of
:mod:`repro_torch.kernels.ops` (the plain versions on a CPU tensor); with a
static K/V of an encoder output (whisper's cross-attention) the same two
kernels run non-causal over it, with no RoPE and no append.
``mla_prefill`` (minicpm3) expands the latent keys and values per head and
runs the same flash kernel at the qk head dim; ``mla_decode`` scores one
token against the latent cache in the absorbed form, in plain products, as
the JAX package computes it outside any Pallas kernel
(``ops.mla_decode_attention``; a latent cache sharded along its sequence
keeps its shard there, each rank's block merged as flash-decoding merges
it).  The caches are written in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import TensorSpec, matmul, pad, seq_sharded, shard
from repro_torch.kernels import ops
from repro_torch.models import kvcache
from repro_torch.models.layers import apply_rope, rope_for


def gqa_template(cfg) -> dict[str, TensorSpec]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    t = {
        "wq": TensorSpec((d, h, hd), ("d_model", "heads", "head_dim"), dtype=cfg.dtype),
        "wk": TensorSpec((d, kv, hd), ("d_model", "kv_heads", "head_dim"), dtype=cfg.dtype),
        "wv": TensorSpec((d, kv, hd), ("d_model", "kv_heads", "head_dim"), dtype=cfg.dtype),
        "wo": TensorSpec((h, hd, d), ("heads", "head_dim", "d_model"), dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        t["bq"] = TensorSpec((h, hd), ("heads", "head_dim"), init="zeros", dtype=cfg.dtype)
        t["bk"] = TensorSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros", dtype=cfg.dtype)
        t["bv"] = TensorSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros", dtype=cfg.dtype)
    return t


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _gqa_q(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    q = _proj_heads(x, params["wq"])
    q = q + params["bq"] if cfg.qkv_bias else q
    return shard(q, "batch", "seq", "act_heads", None).to(x.dtype)


def _gqa_qkv(params: dict, x: torch.Tensor, cfg):
    """q, k, v.  Under a mesh that cannot shard the KV heads (or the q
    heads), a decode's k and v (and q) come out of ``matmul`` as f32
    partial sums over that axis (``sharding.idle_contraction``): the
    constraints reduce them, and they are cast back to x's dtype, so RoPE
    and the cache see what they see unsharded."""
    k = _proj_heads(x, params["wk"])
    v = _proj_heads(x, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    k = shard(k, "batch", "seq", "act_heads", None).to(x.dtype)
    v = shard(v, "batch", "seq", "act_heads", None).to(x.dtype)
    return _gqa_q(params, x, cfg), k, v


def _seq_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The sequence-parallel layout (where the rules shard 'seq'): q stays a
    sequence shard and k/v are gathered once per layer."""
    if not seq_sharded():
        return q, k, v
    return (shard(q, "batch", "seq", None, None), shard(k, "batch", None, None, None),
            shard(v, "batch", None, None, None))


def cross_kv(params: dict, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A cross-attention block's K and V (B, frames, KV, D) of the encoder
    output: no bias and no RoPE, as the reference projects them."""
    return _proj_heads(enc_out, params["wk"]), _proj_heads(enc_out, params["wv"])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('...hk,hkd->...d') as one matrix product."""
    h, k, d = wo.shape
    return matmul(out.reshape(*out.shape[:-2], h * k), wo.reshape(h * k, d))


def gqa_prefill(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    cfg,
    *,
    causal: bool = True,
    cache: dict | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Full-sequence GQA through the flash kernel, writing ``cache`` when
    given.  With ``kv_override`` (the enc-dec decoder's cross-attention:
    K/V of the encoder output, ``cross_kv``) only q is projected, neither
    side takes RoPE and no cache is written; the reference also projects a
    k and v of ``x`` there and drops them."""
    if kv_override is not None:
        q, k, v = _seq_parallel(_gqa_q(params, x, cfg), *kv_override)
        out = ops.flash_attention(q, k, v, causal=causal)
        return shard(_out_proj(out, params["wo"]), "batch", "seq", "act_d_model"), None
    q, k, v = _gqa_qkv(params, x, cfg)
    cos, sin = rope_for(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q, k, v = _seq_parallel(q, k, v)
    out = ops.flash_attention(q, k, v, causal=causal)
    if cache is not None:
        lengths = (positions[:, -1] + 1).to(torch.int32)
        cache = kvcache.write_prompt_kv(cache, k, v, lengths)
    return shard(_out_proj(out, params["wo"]), "batch", "seq", "act_d_model"), cache


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg,
    cache: dict,
    *,
    live: torch.Tensor | None = None,
    cross_cache: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """One token against the cache.  RoPE takes the length before the append
    as the position; attention reads the length after it.  A
    ``uniform_decode`` config appends in lockstep (``append_kv_uniform``).

    With ``cross_cache`` (one decoder layer's static cross K/V and its
    lengths) the token's q, without RoPE, attends to it and nothing is
    appended; the reference also projects a k and v there and drops them.

    With a ``live`` mask, rows that are not live keep their cache.  Where
    the rows share the MoE experts' capacity (``n_experts``), a free row
    still competes for it with its stale token, as in the reference engine,
    so it must compute what the reference computes for it: it appends and
    attends like a live row, and only its length is put back after the
    attention.  No later step reads the K/V entry it wrote at that length:
    the engine (the one caller with a mask, which appends per row) rewrites
    it at the next step before attending, and admission copies the whole
    slot row over it."""
    if cross_cache is not None:
        q = _gqa_q(params, x, cfg)[:, 0].contiguous()  # (B, H, D)
        out = ops.decode_attention(q, cross_cache["k"], cross_cache["v"], cross_cache["lengths"])
        return shard(_out_proj(out, params["wo"])[:, None], "batch", "seq", "act_d_model"), cache
    q, k, v = _gqa_qkv(params, x, cfg)
    pos = cache["lengths"][:, None]  # (B, 1)
    cos, sin = rope_for(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0]  # (B, H, D)
    k = apply_rope(k, cos, sin)[:, 0]  # (B, KV, D)
    append = kvcache.append_kv_uniform if cfg.uniform_decode else kvcache.append_kv
    coupled = live is not None and cfg.n_experts > 0
    saved = cache["lengths"].clone() if coupled else None
    cache = append(cache, k, v[:, 0], None if coupled else live)
    out = ops.decode_attention(q.contiguous(), cache["k"], cache["v"], cache["lengths"],
                               k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    if coupled:
        cache["lengths"].copy_(torch.where(live, cache["lengths"], saved))
    return shard(_out_proj(out, params["wo"])[:, None], "batch", "seq", "act_d_model"), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention) — minicpm3
# ---------------------------------------------------------------------------
#
# q  = W_uq · rmsnorm(W_dq · x)            -> (H, nope+rope)
# c  = rmsnorm(W_dkv · x)                  -> kv_lora_rank   (cached)
# kr = rope(W_kr · x)                      -> qk_rope_dim    (cached, shared)
# k  = [W_uk · c  (per head), kr] ; v = W_uv · c
#
# Decode uses the absorbed form: q_nope is pushed through W_uk^T, so a score
# is an inner product in latent space against the cached c.


def mla_template(cfg) -> dict[str, TensorSpec]:
    d = cfg.d_model
    h = cfg.n_heads
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": TensorSpec((d, qlr), ("d_model", "lora"), dtype=cfg.dtype),
        "q_norm": TensorSpec((qlr,), ("lora",), init="ones", dtype=cfg.dtype),
        "w_uq": TensorSpec((qlr, h, nope + rope_d), ("lora", "heads", "head_dim"),
                           dtype=cfg.dtype),
        "w_dkv": TensorSpec((d, kvlr), ("d_model", "lora"), dtype=cfg.dtype),
        "kv_norm": TensorSpec((kvlr,), ("lora",), init="ones", dtype=cfg.dtype),
        "w_kr": TensorSpec((d, rope_d), ("d_model", "head_dim"), dtype=cfg.dtype),
        "w_uk": TensorSpec((kvlr, h, nope), ("lora", "heads", "head_dim"), dtype=cfg.dtype),
        "w_uv": TensorSpec((kvlr, h, vdim), ("lora", "heads", "head_dim"), dtype=cfg.dtype),
        "wo": TensorSpec((h, vdim, d), ("heads", "head_dim", "d_model"), dtype=cfg.dtype),
    }


def _mla_q(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg):
    cq = ops.rmsnorm(matmul(x, params["w_dq"]), params["q_norm"], eps=cfg.norm_eps)
    q = _proj_heads(cq, params["w_uq"])
    q_nope = q[..., : cfg.qk_nope_dim]
    q_rope = q[..., cfg.qk_nope_dim :]
    cos, sin = rope_for(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_ckv(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg):
    c = ops.rmsnorm(matmul(x, params["w_dkv"]), params["kv_norm"], eps=cfg.norm_eps)
    kr = matmul(x, params["w_kr"])[:, :, None, :]  # (B, S, 1, rope)
    cos, sin = rope_for(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return c, apply_rope(kr, cos, sin)[:, :, 0]  # (B, S, rope)


def mla_prefill(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    cfg,
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Keys and values expanded per head (the standard form); the flash
    kernel runs at the qk head dim with V zero-padded to it and an explicit
    scale, and the output is sliced back to ``v_head_dim``."""
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c, kr = _mla_ckv(params, x, positions, cfg)
    k_nope = _proj_heads(c, params["w_uk"])
    v = _proj_heads(c, params["w_uv"])
    k_rope = kr[:, :, None, :].expand(*kr.shape[:2], cfg.n_heads, cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    qk_dim, vdim = cfg.mla_qk_head_dim, cfg.v_head_dim
    v_p = pad(v, (0, qk_dim - vdim)) if vdim < qk_dim else v
    q, k, v_p = _seq_parallel(q, k, v_p)
    out = ops.flash_attention(q, k, v_p, causal=True, softmax_scale=1.0 / math.sqrt(qk_dim))
    out = out[..., :vdim]
    if cache is not None:
        lengths = (positions[:, -1] + 1).to(torch.int32)
        cache = kvcache.write_prompt_mla(cache, c, kr, lengths)
    return shard(_out_proj(out, params["wo"]), "batch", "seq", "act_d_model"), cache


def mla_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg,
    cache: dict,
    *,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """One token in the absorbed form: score = (q_nope·W_uk)·c + q_rope·kr
    and out = W_uv·(p·c), in f32 over the latent cache; a cache whose
    sequence is sharded merges each rank's p·c before W_uv
    (``ops.mla_decode_attention``).  A ``uniform_decode`` config appends in
    lockstep (``append_mla_uniform``)."""
    pos = cache["lengths"][:, None]  # (B, 1)
    q_nope, q_rope = _mla_q(params, x, pos, cfg)  # (B, 1, H, ·)
    c_new, kr_new = _mla_ckv(params, x, pos, cfg)
    append = kvcache.append_mla_uniform if cfg.uniform_decode else kvcache.append_mla
    cache = append(cache, c_new[:, 0], kr_new[:, 0], live)
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["w_uk"])  # (B, H, kvlr)
    ctx = ops.mla_decode_attention(q_abs, q_rope[:, 0], cache["ckv"], cache["krope"],
                                   cache["lengths"],
                                   softmax_scale=1.0 / math.sqrt(cfg.mla_qk_head_dim))
    out = shard(torch.einsum("bhr,rhk->bhk", ctx, params["w_uv"].float()), "batch", "act_heads")
    return shard(_out_proj(out.to(x.dtype), params["wo"])[:, None], "batch", "seq",
                 "act_d_model"), cache
