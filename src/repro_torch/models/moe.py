"""Mixture-of-experts layer of the port (``repro.models.moe``): olmoe's 64
experts, top-8, and grok-1's 8, top-2 in groups of 512 tokens.

Token-choice top-k routing with GShard one-hot dispatch and per-group
capacity, as the JAX package computes it: tokens in groups of
``moe_group_size``; in each group a (S, E, C) dispatch tensor built from the
routing one-hots scatters tokens into per-expert buffers of ``C`` slots, every
expert runs over its whole buffer (one batched product over E), and a
combine tensor weighted by the routing probabilities gathers the results
back.  A token's choice beyond an expert's capacity is dropped; the drop
priority is an exclusive cumulative sum over the group's (S*k) one-hots,
token-major, so the earlier token keeps a contested slot.

These are plain products, which the JAX package leaves to XLA; no kernel of
the port runs here.  Routing ties go to the lower expert index, as
``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    TensorSpec,
    current_rules,
    einsum,
    from_block,
    gather_dims,
    is_dtensor,
    matmul,
    pad,
    placement_types,
    placements_for,
    redistributed,
    shard,
)


def moe_template(cfg) -> dict[str, TensorSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    t = {
        "router": TensorSpec((d, e), ("d_model", "experts"), dtype=torch.float32),
        "w_up": TensorSpec((e, d, f), ("experts", "d_model", "d_ff"), dtype=cfg.dtype),
        "w_down": TensorSpec((e, f, d), ("experts", "d_ff", "d_model"), dtype=cfg.dtype),
    }
    if cfg.gated_mlp:
        t["w_gate"] = TensorSpec((e, d, f), ("experts", "d_model", "d_ff"), dtype=cfg.dtype)
    return t


def _expert_ffn(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (G, E, C, d) -> (G, E, C, d), every expert over its own buffer.
    SwiGLU (olmoe's and grok-1's experts), else the reference's non-gated
    experts: gelu in f32, the tanh form that ``jax.nn.gelu`` takes by
    default, for every other ``mlp``.  That includes ``relu2``: the
    reference's experts apply gelu there, not squared ReLU, and so do
    these."""
    up = einsum("gecd,edf->gecf", x, params["w_up"])
    if cfg.gated_mlp:
        gate = einsum("gecd,edf->gecf", x, params["w_gate"])
        hidden = F.silu(gate.float()).to(x.dtype) * up
    else:
        hidden = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    hidden = shard(hidden, "batch", "experts", None, "act_d_ff")
    # a sharded d_ff (grok-1's) is contracted on each rank's blocks: partial
    # sums, added in f32 where the combine reads them, as the reference adds them
    return einsum("gecf,efd->gecd", hidden, params["w_down"])


def _flatten_groups(y: torch.Tensor) -> torch.Tensor:
    """(G, S, d) -> (G * S, d).  A DTensor with no shard of S is reshaped
    block by block, a shard of G becoming the rows' (the same blocks: the
    rules shard G only over mesh axes that divide it); DTensor's own view
    refuses a shard that holds a single group (one group on a one-rank
    axis)."""
    g, s, d = y.shape
    if not is_dtensor(y) or any(p.is_shard(1) for p in y.placements):
        return y.reshape(g * s, d)
    _, Replicate, Shard = placement_types()
    local = y.to_local(grad_placements=[Replicate() if p.is_partial() else p for p in y.placements])
    return from_block(local.reshape(-1, d), y.device_mesh,
                      [Shard(p.dim - 1) if p.is_shard(2) else p for p in y.placements], (g * s, d))


def route_topk(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities of each row and their expert indices, the
    lower index first among equal probabilities (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none)."""
    vals, idx = torch.sort(-probs, dim=-1, stable=True)
    return -vals[..., :k], idx[..., :k]


def moe_forward(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    *,
    group_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), router aux loss, an f32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]

    logits = matmul(tokens.float(), params["router"])  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = route_topk(probs, k)  # (T, k)
    topk_p = topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    fe = F.one_hot(topk_i[:, 0], e).float().mean(dim=0)
    aux = e * (fe * me).sum() * cfg.router_aux_coef

    # G groups of g_sz tokens; the tail group is padded with invalid tokens
    g_sz = min(group_size or cfg.moe_group_size, t)
    n_groups = -(-t // g_sz)
    extra = n_groups * g_sz - t
    if extra:
        tokens, topk_p, topk_i = (pad(t, (0, 0, 0, extra)) for t in (tokens, topk_p, topk_i))
    tk = tokens.reshape(n_groups, g_sz, d)
    pi = topk_p.reshape(n_groups, g_sz, k)
    ii = topk_i.reshape(n_groups, g_sz, k)
    vm = (torch.arange(n_groups * g_sz, device=x.device) < t).reshape(n_groups, g_sz)

    cap = max(int(math.ceil(cfg.capacity_factor * g_sz * k / e)), 1)

    # slot of each (token, choice) in its expert: exclusive cumsum over the
    # flattened (S*k) one-hots, per group
    onehot = F.one_hot(ii, e).float()  # (G, S, k, E)
    flat = onehot.reshape(n_groups, g_sz * k, e)
    pos_f = flat.cumsum(dim=1) - flat
    pos = (pos_f * flat).sum(-1).reshape(n_groups, g_sz, k)
    keep = (pos < cap) & (pi > 0) & vm[..., None]  # (G, S, k)

    # one-hot of the slot, zero past the capacity (jax.nn.one_hot's rule)
    oc = (pos[..., None] == torch.arange(cap, device=x.device, dtype=pos.dtype)).float()
    oc = oc * keep[..., None]  # (G, S, k, C)
    # each rank builds its experts' columns only, as the reference's
    # constraints on dispatch and combine have GSPMD build them
    onehot = shard(onehot, "batch", None, None, "experts")
    dispatch = einsum("gske,gskc->gsec", onehot, oc)  # (G, S, E, C)
    combine = einsum("gske,gskc->gsec", onehot * pi[..., None], oc)
    dispatch = shard(dispatch, "batch", None, "experts", None)
    combine = shard(combine, "batch", None, "experts", None)
    if is_dtensor(tk):
        # where the groups could not take the tokens' shard (one group of a
        # decode step's tokens), the tokens keep it: the combine computes
        # each rank's tokens only, as GSPMD propagates the output's batch
        # shard back into it (a replicated dim cut, no data moved)
        Shard = placement_types()[2]
        combine = redistributed(combine, [Shard(1) if pt.is_shard(1) else pc
                                          for pt, pc in zip(tk.placements, combine.placements)])

    buf = einsum("gsec,gsd->gecd", dispatch.to(x.dtype), tk)  # (G, E, C, d)
    buf = shard(buf, "batch", "experts", None, None)
    out_buf = _expert_ffn(params, buf, cfg)
    y = einsum("gsec,gecd->gsd", combine, out_buf.float())  # (G, S, d)
    flat = _flatten_groups(y)[:t]
    if is_dtensor(flat):
        # the expert shards' partial sums added in f32, before the cast (as
        # the reference adds them); the group shards gathered over axes the
        # batch is not sharded on
        batch = placements_for(current_rules().spec_for_shape((b,), ("batch",)), flat.device_mesh,
                               (b,))
        flat = gather_dims(flat, (0,), keep=[p.is_shard(0) for p in batch])
    out = flat.reshape(b, s, d).to(x.dtype)
    return shard(out, "batch", "seq", "act_d_model"), aux
