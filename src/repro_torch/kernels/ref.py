"""Plain PyTorch versions of the port's kernels.

The CPU tests run them, ``chip_smoke.py`` holds each kernel against its plain
version on the card, and :mod:`repro_torch.kernels.ops` takes the forward
ones for CPU tensors (where autograd differentiates them).  They are the
model's own oracles in :mod:`repro_torch.models.layers`.  The two backward
versions (``rmsnorm_bwd_ref``, ``flash_attention_bwd_ref``) are the plain
counterparts of the backward kernels, by the explicit formulas the kernels
use; nothing on the card's path calls them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import attention_reference, decode_attention_reference
from repro_torch.models.layers import rmsnorm as rmsnorm_ref  # noqa: F401  (the plain rmsnorm)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    return attention_reference(q, k, v, causal=causal, softmax_scale=softmax_scale)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KV, S, D)
    v_cache: torch.Tensor,  # (B, KV, S, D)
    lengths: torch.Tensor,  # (B,)
    *,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    return decode_attention_reference(q, k_cache, v_cache, lengths, softmax_scale=softmax_scale)



def rmsnorm_bwd_ref(
    x: torch.Tensor,  # (..., d)
    w: torch.Tensor,  # (d,)
    g: torch.Tensor,  # (..., d): the gradient of rmsnorm's output
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm_ref(x, w, eps)`` in f32, cast to the inputs'
    dtypes: with x^ = x * rstd and gw = g * w,
    dx = rstd * (gw - x^ * mean(gw * x^)) and dw = sum over rows of g * x^."""
    xf, wf, gf = x.float(), w.float(), g.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xh = xf * rstd
    gw = gf * wf
    dx = rstd * (gw - xh * (gw * xh).mean(dim=-1, keepdim=True))
    dw = (gf * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    o: torch.Tensor,  # (B, Sq, H, D): the forward's output
    do: torch.Tensor,  # (B, Sq, H, D): its gradient
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_ref`` in f32 with P materialised:
    dV = P^T dO, dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO * O),
    dQ = scale dS K, dK = scale dS^T Q.  For GQA, dk and dv sum over each KV
    head's n_rep query heads.  The causal mask keeps k_pos <= q_pos (the
    diagonal at 0, as the kernels)."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    n_rep = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, heads, S, D)
    of, dof = o.float().transpose(1, 2), do.float().transpose(1, 2)
    kr, vr = kf.repeat_interleave(n_rep, dim=1), vf.repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    if causal:
        keep = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, kv, n_rep, sk, d).sum(dim=2)
    dv = dv.reshape(b, kv, n_rep, sk, d).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
