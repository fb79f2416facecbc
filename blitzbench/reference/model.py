"""The plain reference of the served models, in PyTorch float32.

A decoder of the configuration's widths as the benchmark's configuration
files state it: token embedding; per layer RMSNorm -> grouped-query
attention with rotary embeddings (half-split form, angles in float64) ->
residual -> RMSNorm -> SwiGLU MLP, or (OLMoE) a router softmax over every
expert, the top k taken (the lower index first among equal probabilities),
their probabilities renormalized where ``norm_topk_prob`` says so, and the
chosen experts' SwiGLU outputs summed with those weights, with no capacity
and no token dropped -> residual; a final RMSNorm and the unembedding.

``forward`` runs one sequence with teacher forcing: every position at once,
causal, each layer's weights cast to float32 as it is reached.  A context
(the long cell's cache) enters as the keys and values a cache holds, rotary
embedding already applied, at positions ``[0, n_ctx)``; the tokens follow at
``n_ctx`` onwards.  ``kv`` rounds every key and value to what a cache of
that kind holds (``quant.kv_round``): the int8 cache the long cell's
configuration states, or int4 as its control.  ``fp8`` rounds both operands
of every weight product to e4m3 (``quant.fp8_round``), the control of the
bf16 cells; the router stays in float32, as the configuration states it.

It imports nothing of the program: it reads the benchmark's weights and
inputs only, and works out everything else itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from blitzbench.reference.quant import fp8_round, kv_round


@dataclasses.dataclass(frozen=True)
class Spec:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0
    norm_topk_prob: bool = True

    @classmethod
    def from_config(cls, conf: dict) -> "Spec":
        """The published keys of a configuration file."""
        h = conf["num_attention_heads"]
        return cls(
            n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"], n_heads=h,
            n_kv_heads=conf["num_key_value_heads"],
            head_dim=conf.get("head_dim") or conf["hidden_size"] // h,
            d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
            rope_theta=float(conf["rope_theta"]), norm_eps=float(conf["rms_norm_eps"]),
            n_experts=conf.get("num_experts", 0), top_k=conf.get("num_experts_per_tok", 0),
            norm_topk_prob=bool(conf.get("norm_topk_prob", True)),
        )


@contextlib.contextmanager
def exact_f32():
    """Float32 products in float32, not TF32, for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) rotated by its positions (S,): pairs (i, i + D/2)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Products:
    """x @ w in float32, with both operands rounded to e4m3 under ``fp8``."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return fp8_round(x, -1) @ fp8_round(w, 0)
        return x @ w


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_ctx: int,
           block: int = 256) -> torch.Tensor:
    """Causal attention of q (S, H, D) at positions n_ctx + i over k, v
    (n_ctx + S, KV, D), each group of H / KV query heads on its KV head, in
    blocks of ``block`` queries."""
    s, h, d = q.shape
    t, kvh, _ = k.shape
    qg = q.reshape(s, kvh, h // kvh, d)
    kpos = torch.arange(t, device=q.device)
    out = torch.empty_like(q)
    for lo in range(0, s, block):
        qb = qg[lo:lo + block]
        scores = torch.einsum("bgrd,tgd->bgrt", qb, k) / math.sqrt(d)
        qpos = n_ctx + torch.arange(lo, lo + qb.shape[0], device=q.device)
        scores = scores.masked_fill((kpos[None, :] > qpos[:, None])[:, None, None, :], float("-inf"))
        p = torch.softmax(scores, dim=-1)
        out[lo:lo + qb.shape[0]] = torch.einsum("bgrt,tgd->bgrd", p, v).reshape(-1, h, d)
    return out


def moe(spec: Spec, lp: dict, h: torch.Tensor, mm: _Products) -> torch.Tensor:
    """Every token's top-k experts, dropless, summed with their weights."""
    probs = torch.softmax(h @ lp["router"].float(), dim=-1)
    order = torch.sort(-probs, dim=-1, stable=True).indices[:, : spec.top_k]
    weight = probs.gather(-1, order)
    if spec.norm_topk_prob:
        weight = weight / weight.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(spec.n_experts):
        rows, slot = (order == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = mm(F.silu(mm(x, lp["w_gate"][e])) * mm(x, lp["w_up"][e]), lp["w_down"][e])
        out.index_add_(0, rows, y * weight[rows, slot, None])
    return out


def forward(
    spec: Spec,
    weights: dict,
    tokens: torch.Tensor,
    *,
    rows: torch.Tensor | None = None,
    n_ctx: int = 0,
    context: Callable[[int], tuple[torch.Tensor, torch.Tensor]] | None = None,
    kv: str | None = None,
    fp8: bool = False,
) -> torch.Tensor:
    """Float32 logits (len(rows), vocab_size) of ``tokens`` (S,) at positions
    n_ctx .. n_ctx + S - 1, at the sequence rows ``rows`` (all by default).
    ``context(layer)`` gives that layer's cached keys and values (n_ctx, KV,
    D) when n_ctx > 0."""
    mm = _Products(fp8)
    dev = weights["final_norm"].device
    tokens = tokens.to(dev)
    positions = n_ctx + torch.arange(tokens.shape[0], device=dev)
    hd, eps = spec.head_dim, spec.norm_eps
    stacked = weights["layers"]
    with exact_f32(), torch.no_grad():
        x = weights["embed"]["tok"][tokens].float()
        for i in range(spec.n_layers):
            lp = {k: (v[i] if isinstance(v, torch.Tensor) else {n: t[i] for n, t in v.items()})
                  for k, v in stacked.items()}
            at = lp["attn"]
            h = rmsnorm(x, lp["norm1"], eps)
            q = mm(h, at["wq"].reshape(spec.d_model, -1)).reshape(-1, spec.n_heads, hd)
            k = mm(h, at["wk"].reshape(spec.d_model, -1)).reshape(-1, spec.n_kv_heads, hd)
            v = mm(h, at["wv"].reshape(spec.d_model, -1)).reshape(-1, spec.n_kv_heads, hd)
            q, k = rope(q, positions, spec.rope_theta), rope(k, positions, spec.rope_theta)
            if n_ctx:
                ck, cv = context(i)
                k, v = torch.cat([ck.float(), k]), torch.cat([cv.float(), v])
            if kv is not None:
                k, v = kv_round(k, kv), kv_round(v, kv)
            a = attend(q, k, v, n_ctx)
            x = x + mm(a.reshape(a.shape[0], -1), at["wo"].reshape(-1, spec.d_model))
            h = rmsnorm(x, lp["norm2"], eps)
            if spec.n_experts:
                x = x + moe(spec, lp["moe"], h, mm)
            else:
                m = lp["mlp"]
                x = x + mm(F.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"]), m["w_down"])
        if rows is not None:
            x = x[rows.to(dev)]
        x = rmsnorm(x, weights["final_norm"], eps)
        return mm(x, weights["embed"]["unembed"][:, : spec.vocab_size])
