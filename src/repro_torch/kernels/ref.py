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


_LOG2E = 1.4426950408889634


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, softmax_scale: float | None,
            q_offset: int = 0) -> torch.Tensor:
    """scale Q K^T in f32, (B, H, Sq, Sk), -inf where the causal mask drops a
    key (k_pos > q_offset + q_pos); GQA's KV heads repeated over their query
    heads."""
    sq, h, d = q.shape[1:]
    sk, kv = k.shape[1:3]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)
    kr = k.float().transpose(1, 2).repeat_interleave(h // kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None] + q_offset
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``q_offset``: the global position of q's row 0, which the causal mask
    reads (``flash_attention.flash_attention``'s)."""
    return attention_reference(q, k, v, causal=causal, softmax_scale=softmax_scale,
                               q_offset=q_offset)


def flash_attention_lse_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Each row's log-sum-exp in the flash kernels' convention, (B, H, Sq)
    f32: the log2 domain of the scaled scores, log2(sum_k 2^(s_k log2(e)))
    with s = scale Q K^T, the causal mask keeping k_pos <= q_offset + q_pos;
    +inf for a row with no valid key (its P is then 0, as the backward
    rebuilds it)."""
    lse = torch.logsumexp(_scores(q, k, causal, softmax_scale, q_offset), dim=-1) * _LOG2E
    return lse.masked_fill(lse == float("-inf"), float("inf"))


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KV, S, D)
    v_cache: torch.Tensor,  # (B, KV, S, D)
    lengths: torch.Tensor,  # (B,)
    *,
    softmax_scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # (B, KV, S) f32, with an int8 cache
    v_scale: torch.Tensor | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The model's decode oracle; with ``return_lse`` the kernel's
    arithmetic step by step in f32 instead, and (out, lse) as the kernel
    gives them: s = scale q.k (times k_scale) in the log2 domain, m its max
    over the valid rows, p = 2^(s - m), l = sum p, out = sum (p v_scale) v /
    l, lse = m + log2(l) (B, H); a row of length 0 gives out 0 and lse -inf,
    weight 0 where ``ops.merge_partials`` merges the partials of cache
    slices.  (Without it, the oracle averages V over a row of length 0.)"""
    if not return_lse:
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          softmax_scale=softmax_scale, k_scale=k_scale,
                                          v_scale=v_scale)
    b, h, d = q.shape
    _, kv, s, _ = k_cache.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, kv, h // kv, d)
    sc = torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float()) * (scale * _LOG2E)
    if k_scale is not None:
        sc = sc * k_scale.float()[:, :, None, :]
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None].long()  # (B, S)
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp2(sc - torch.where(m == float("-inf"), 0.0, m))  # masked: 0
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    out = torch.einsum("bgrs,bgsd->bgrd", p, v_cache.float()) / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log2(l), float("-inf"))
    return out.reshape(b, h, d).to(q.dtype), lse.reshape(b, h)



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
    lse: torch.Tensor | None = None,  # (B, H, Sq): the forward's log-sum-exp
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_ref`` in f32 with P materialised:
    dV = P^T dO, dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO * O),
    dQ = scale dS K, dK = scale dS^T Q.  For GQA, dk and dv sum over each KV
    head's n_rep query heads.  The causal mask keeps k_pos <= q_offset +
    q_pos, as the kernels (keys no query sees get dk = dv = 0).  P is
    softmax(S); given the forward's ``lse`` (as ``flash_attention_lse_ref``
    gives it, at the same offset), P = exp2(S log2(e) - lse), as the kernels
    rebuild it."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    n_rep = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, heads, S, D)
    of, dof = o.float().transpose(1, 2), do.float().transpose(1, 2)
    kr, vr = kf.repeat_interleave(n_rep, dim=1), vf.repeat_interleave(n_rep, dim=1)
    s = _scores(q, k, causal, softmax_scale, q_offset)
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp2(s * _LOG2E - lse.float()[..., None])
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
