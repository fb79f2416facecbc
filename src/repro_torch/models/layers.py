"""Core layers of the port (``repro.models.layers`` in PyTorch).

Plain functions on tensors.  Layouts are the JAX package's: activations
``(B, S, H, D)``, caches ``(B, KV, S, D)``.  These are the plain (reference)
versions; the model reaches the hand-written kernels through
:mod:`repro_torch.kernels.ops`.

bf16 note: a torch bf16 product rounds its output to bf16, where the JAX
reference contracts bf16 operands with an f32 result
(``preferred_element_type``).  The attention scores are therefore taken on
operands upcast to f32; the product of two bf16 values is exact in f32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter templates (shape + init law per leaf)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Declarative parameter leaf: shape, init law and dtype."""

    shape: tuple[int, ...]
    init: str = "normal"  # 'normal' | 'zeros' | 'ones'
    dtype: Any = torch.float32

    def stacked(self, n: int) -> "TensorSpec":
        """Prepend the scan-over-layers axis."""
        return dataclasses.replace(self, shape=(n, *self.shape))


def map_template(fn, template: Any) -> Any:
    if isinstance(template, dict):
        return {k: map_template(fn, v) for k, v in template.items()}
    return fn(template)


def stack_template(template: Any, n: int) -> Any:
    return map_template(lambda s: s.stacked(n), template)


def param_count(template: Any) -> int:
    if isinstance(template, dict):
        return sum(param_count(v) for v in template.values())
    return int(np.prod(template.shape))


def init_std(spec: TensorSpec) -> float:
    """The reference's init law: std = 1/sqrt(shape[0]) for rank >= 2.

    On a stacked layer leaf shape[0] is ``n_layers``, so every layer weight
    gets std 1/sqrt(n_layers) (1/6 for 36-layer granite).  Copied as it is so
    that a port-initialised model behaves like a JAX-initialised one."""
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    return 1.0 / float(np.sqrt(max(fan_in, 1)))


def ssm_a_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The reference's ``ssm_a`` law on uniform draws u in [0, 1): Mamba2's A
    is a negative scalar per head, A = -exp(u * (log 16 - log 1) + log 1).
    The leaf that holds it is named ``a_log``; the model uses it as A."""
    return -torch.exp(u * float(np.log(16.0) - np.log(1.0)) + float(np.log(1.0)))


def ssm_dt_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The reference's ``ssm_dt`` law: dt = exp(u * (log 0.1 - log 1e-3) +
    log 1e-3) spans [1e-3, 1e-1], and the bias is softplus's inverse of it."""
    dt = torch.exp(u * float(np.log(0.1) - np.log(1e-3)) + float(np.log(1e-3)))
    return dt + torch.log(-torch.expm1(-dt))


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, where the reference computes in f32; an f64 tensor stays
    f64, so that a float64 run of the plain path rounds nowhere to f32."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = wide(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * wide(w)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split convention)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Built in numpy f32 exactly as the reference, copied to the device once
    (a copy per call would synchronise the stream at every layer)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return torch.from_numpy(np.asarray(inv_freq, np.float32)).to(device)


def rope_cos_sin(
    positions: torch.Tensor, dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin of shape (..., S, dim//2), f32."""
    angles = positions[..., None].float() * _inv_freq(dim, float(theta), positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D). cos/sin: broadcastable (..., S, 1, D//2)."""
    xf = wide(x)
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_for(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) positions -> (B, S, 1, D//2) cos/sin for heads."""
    cos, sin = rope_cos_sin(positions, head_dim, theta)
    return cos[:, :, None, :], sin[:, :, None, :]


# ---------------------------------------------------------------------------
# Attention math
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*n_rep, D) by repeating each kv head."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def attention_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool,
    q_offset: int | torch.Tensor = 0,
    kv_len: torch.Tensor | None = None,  # (B,) valid kv lengths
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Naive O(Sq*Sk) attention, the numerical oracle for kernels and tests."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(d))
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    logits = torch.einsum("bqhd,bkhd->bhqk", wide(q), wide(k)) * scale
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
    mask = mask[None, None].expand(b, 1, sq, sk)
    if kv_len is not None:
        valid = torch.arange(sk, device=q.device)[None, :] < kv_len[:, None]
        mask = mask & valid[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, wide(v))
    return out.to(q.dtype)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool,
    q_offset: int | torch.Tensor = 0,
    kv_len: torch.Tensor | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Exact attention with O(q_chunk*kv_chunk) live score memory: a loop over
    Q chunks, an inner loop over KV chunks carrying (max, denominator, acc)."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    n_rep = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(d))
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    dev = q.device
    kv_len_arr = (
        torch.full((b,), sk, dtype=torch.int32, device=dev)
        if kv_len is None
        else kv_len.to(torch.int32)
    )
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc = q[:, q0 : q0 + q_chunk].float()
        cq = qc.shape[1]
        q_pos = q0 + torch.arange(cq, device=dev) + q_offset
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, d), dtype=torch.float32, device=dev)
        for k0 in range(0, sk, kv_chunk):
            kr = _repeat_kv(k[:, k0 : k0 + kv_chunk], n_rep).float()
            vr = _repeat_kv(v[:, k0 : k0 + kv_chunk], n_rep).float()
            k_pos = k0 + torch.arange(kr.shape[1], device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kr) * scale
            mask = torch.ones((cq, kr.shape[1]), dtype=torch.bool, device=dev)
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
            valid = k_pos[None, :] < kv_len_arr[:, None]  # (B, Ck)
            s = torch.where(mask[None, None] & valid[:, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vr)
            m = m_new
        outs.append((acc / l[..., None].clamp_min(1e-30)).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # (B, H, D), one new token per sequence
    k_cache: torch.Tensor,  # (B, KV, Smax, D), seq-major cache layout
    v_cache: torch.Tensor,  # (B, KV, Smax, D)
    lengths: torch.Tensor,  # (B,) valid cache entries (incl. the new token)
    *,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Single-token GQA decode against a padded cache.

    The ``n_rep`` query heads sharing a KV head contract against it directly.
    As in the reference, scores are f32 and the probabilities are cast to the
    cache dtype before the PV product (accumulated in f32)."""
    if k_cache.dtype == torch.int8:
        raise NotImplementedError("int8 KV cache: not yet ported")
    b, h, d = q.shape
    _, kvh, smax, _ = k_cache.shape
    rep = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / float(np.sqrt(d))
    qg = q.reshape(b, kvh, rep, d)
    s = torch.einsum("bgrd,bgsd->bgrs", wide(qg), wide(k_cache)) * scale
    valid = torch.arange(smax, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgrs,bgsd->bgrd", wide(p), wide(v_cache))
    return out.reshape(b, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_template(cfg) -> dict[str, TensorSpec]:
    d, f = cfg.d_model, cfg.d_ff
    t = {
        "w_up": TensorSpec((d, f), dtype=cfg.dtype),
        "w_down": TensorSpec((f, d), dtype=cfg.dtype),
    }
    if cfg.gated_mlp:
        t["w_gate"] = TensorSpec((d, f), dtype=cfg.dtype)
    return t


def mlp_forward(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (..., d_model).  SwiGLU (gate in f32), nemotron's squared ReLU (in
    the input dtype, so a bf16 square rounds to bf16 as the reference's
    does) or whisper's gelu (f32, the tanh form that ``jax.nn.gelu`` takes by
    default)."""
    up = x @ params["w_up"]
    if cfg.mlp == "swiglu":
        gate = x @ params["w_gate"]
        hidden = F.silu(wide(gate)).to(x.dtype) * up
    elif cfg.mlp == "relu2":
        r = F.relu(up)
        hidden = r * r
    elif cfg.mlp == "gelu":
        hidden = F.gelu(wide(up), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown mlp {cfg.mlp!r}")
    return hidden @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embedding_template(cfg) -> dict[str, TensorSpec]:
    pv = cfg.padded_vocab_size
    t = {"tok": TensorSpec((pv, cfg.d_model), dtype=cfg.dtype)}
    if not cfg.tie_embeddings:
        t["unembed"] = TensorSpec((cfg.d_model, pv), dtype=cfg.dtype)
    return t


def vocab_mask_logits(logits: torch.Tensor, cfg) -> torch.Tensor:
    """-inf the padded vocab tail so softmax/argmax ignore it."""
    pv = cfg.padded_vocab_size
    if pv == cfg.vocab_size:
        return logits
    valid = torch.arange(pv, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, NEG_INF)


def embed_tokens(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """A row gather.  ``F.embedding``, not ``index_select``: on CUDA its
    backward sums each row's gradients in a fixed order, where
    ``index_select``'s accumulates them with float atomics, so a training
    step's bits would change from run to run."""
    return F.embedding(tokens, params["tok"])


def unembed(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w
