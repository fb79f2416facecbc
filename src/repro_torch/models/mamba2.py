"""Mamba2 (SSD, state-space duality) mixer of the port (``repro.models.mamba2``).

Chunked SSD, as in the JAX package:

* within a chunk, the quadratic form ``Y_diag = (C B^T * L) X``;
* each chunk's boundary state ``S_c = sum_j decay_j dt_j B_j (x) X_j``;
* between chunks the linear recurrence ``h_c = gamma_c h_{c-1} + S_c``
  (``lax.scan`` in the JAX package; a loop over the chunks here);
* the off-diagonal term ``Y_off = C h_{c-1} decay_in``.

Decode is the O(1) recurrent step over the (H, P, N) state.
``ssd_reference`` is the sequential per-token oracle of the chunked form.
The gated norm goes through :func:`repro_torch.kernels.ops.rmsnorm`, so on
the card it is the rmsnorm kernel.  The parameter named ``a_log`` holds A
itself (negative), as the reference's init law and its use here have it.
On DTensors the mixer keeps the reference's head shard from the input
projection on: the conv runs on each rank's x channels, the chunked scan on
its block (batch and head shards kept, a sequence shard gathered), as the
attention kernels do, and the gated norm sums its row statistic across the
head shards (one all-reduce; plain PyTorch on the block, as the reference
computes jnp there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    TensorSpec,
    as_dtensor,
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
from repro_torch.kernels import ops


def mamba2_template(cfg) -> dict[str, TensorSpec]:
    d = cfg.d_model
    din = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    h = cfg.ssm_nheads
    d_xbc = din + 2 * g * n
    d_in_proj = 2 * din + 2 * g * n + h  # z, x, B, C, dt
    return {
        "in_proj": TensorSpec((d, d_in_proj), ("d_model", "d_ff"), dtype=cfg.dtype),
        "conv_w": TensorSpec((cfg.ssm_conv, d_xbc), ("conv", "d_ff"), dtype=cfg.dtype),
        "conv_b": TensorSpec((d_xbc,), ("d_ff",), init="zeros", dtype=cfg.dtype),
        "a_log": TensorSpec((h,), ("ssm_heads",), init="ssm_a", dtype=torch.float32),
        "d_skip": TensorSpec((h,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "dt_bias": TensorSpec((h,), ("ssm_heads",), init="ssm_dt", dtype=torch.float32),
        "norm_w": TensorSpec((din,), ("d_ff",), init="ones", dtype=cfg.dtype),
        "out_proj": TensorSpec((din, d), ("d_ff", "d_model"), dtype=cfg.dtype),
    }


def _split_in_proj(cfg, zxbcdt: torch.Tensor):
    din = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    h = cfg.ssm_nheads
    return zxbcdt[..., :din], zxbcdt[..., din : 2 * din + 2 * g * n], zxbcdt[..., -h:]


def _split_xbc(cfg, xbc: torch.Tensor):
    din = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return xbc[..., :din], xbc[..., din : din + gn], xbc[..., din + gn :]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  xbc: (B, S, D), w: (K, D)."""
    k = w.shape[0]
    s = xbc.shape[1]
    padded = pad(xbc, (0, 0, k - 1, 0))
    out = padded[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + padded[:, i : i + s] * w[i]
    return F.silu((out + b).float()).to(xbc.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[i, j] = sum_{j < t <= i} x[t]; -inf for j > i."""
    t = x.shape[-1]
    cum = x.cumsum(dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), softplus applied
    a: torch.Tensor,  # (H,) negative
    b_in: torch.Tensor,  # (B, S, G, N)
    c_in: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    h_init: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32)."""
    if is_dtensor(x):
        return _ssd_blocks(x, dt, a, b_in, c_in, chunk, h_init)
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk

    xc = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bc = b_in.float().repeat_interleave(rep, dim=2).reshape(bsz, nc, chunk, h, n)
    cc = c_in.float().repeat_interleave(rep, dim=2).reshape(bsz, nc, chunk, h, n)

    da_t = (dtc * a).transpose(2, 3)  # (B, nc, H, Q)
    cum = da_t.cumsum(dim=-1)

    # (1) within-chunk (quadratic) term, dt_j on the key side
    l_mat = torch.exp(_segsum(da_t))  # (B, nc, H, Q, Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)
    scores = scores * l_mat * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # (2) per-chunk boundary states: sum_j exp(cum_last - cum_j) dt_j B_j (x) X_j
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (B, nc, H, Q)
    wgt = decay_to_end.transpose(2, 3) * dtc  # (B, nc, Q, H)
    sc = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", wgt, bc, xc)  # (B, nc, H, P, N)

    # (3) inter-chunk recurrence: the state entering each chunk
    gamma = torch.exp(cum[..., -1])  # (B, nc, H)
    h_prev = (h_init.float() if h_init is not None
              else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(h_prev)
        h_prev = h_prev * gamma[:, c, :, None, None] + sc[:, c]
    h_enter = torch.stack(entering, dim=1)  # (B, nc, H, P, N)

    # (4) off-diagonal: Y_off = decay_in * C . h_enter
    decay_in = torch.exp(cum)  # (B, nc, H, Q)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", cc, h_enter) * decay_in.transpose(2, 3)[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), h_prev


def _ssd_blocks(x, dt, a, b_in, c_in, chunk, h_init):
    """``ssd_chunked`` on this rank's block of DTensor inputs: per mesh dim a
    batch shard of x is kept (every input follows it), a head shard is kept
    where B and C have one group (they are then replicated and get a
    partial gradient), anything else is gathered."""
    Partial, Replicate, Shard = placement_types()
    mesh = x.device_mesh
    x, dt, a, b_in, c_in, h_init = (as_dtensor(t, mesh) for t in (x, dt, a, b_in, c_in, h_init))
    pls = {k: [] for k in ("x", "dt", "a", "bc", "h", "a_grad", "bc_grad")}
    for i, px in enumerate(x.placements):
        if px.is_shard(0):
            picks = dict(x=Shard(0), dt=Shard(0), a=Replicate(), bc=Shard(0), h=Shard(0),
                         a_grad=Partial(), bc_grad=Shard(0))
        elif px.is_shard(2) and b_in.shape[2] == 1 and x.shape[2] % mesh.size(i) == 0:
            picks = dict(x=Shard(2), dt=Shard(2), a=Shard(0), bc=Replicate(), h=Shard(1),
                         a_grad=Shard(0), bc_grad=Partial())
        else:
            picks = dict(x=Replicate(), dt=Replicate(), a=Replicate(), bc=Replicate(),
                         h=Replicate(), a_grad=Replicate(), bc_grad=Replicate())
        for k, v in picks.items():
            pls[k].append(v)
    x, dt, a = redistributed(x, pls["x"]), redistributed(dt, pls["dt"]), redistributed(a, pls["a"])
    b_in, c_in = redistributed(b_in, pls["bc"]), redistributed(c_in, pls["bc"])
    h_init = redistributed(h_init, pls["h"])
    y, h_final = ssd_chunked(
        x.to_local(), dt.to_local(), a.to_local(grad_placements=pls["a_grad"]),
        b_in.to_local(grad_placements=pls["bc_grad"]),
        c_in.to_local(grad_placements=pls["bc_grad"]), chunk,
        None if h_init is None else h_init.to_local())
    bsz, _, h, p = x.shape
    return (from_block(y, mesh, pls["x"], x.shape),
            from_block(h_final, mesh, pls["h"], (bsz, h, p, b_in.shape[3])))


def ssd_reference(x, dt, a, b_in, c_in, h_init=None):
    """Sequential per-token recurrence, the oracle of the chunked form."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    rep = h // g
    bf = b_in.float().repeat_interleave(rep, dim=2)
    cf = c_in.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    state = (h_init.float() if h_init is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for i in range(s):
        decay = torch.exp(dtf[:, i] * a)[..., None, None]  # (B, H, 1, 1)
        state = state * decay + dtf[:, i, :, None, None] * (xf[:, i, :, :, None] * bf[:, i, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", cf[:, i], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _gated_out(params: dict, y: torch.Tensor, z: torch.Tensor, u: torch.Tensor, cfg):
    """rmsnorm(y * silu(z)) @ out_proj, in u's dtype."""
    gated = y * F.silu(z.float()).to(u.dtype)
    normed = ops.rmsnorm(gated, params["norm_w"], eps=cfg.norm_eps, split_rows=True)
    return matmul(normed, params["out_proj"])


def _on_heads(t: torch.Tensor, dim: int, cfg) -> torch.Tensor:
    """A DTensor whose ``dim`` runs over the SSM heads (H wide, or H x P
    channels) split as the rules split ``ssm_heads``: on those mesh dims
    each rank keeps its heads' block, which a replicated dim gives without
    moving data; a plain tensor, or any tensor without rules, as it is."""
    rules = current_rules()
    if rules is None or rules.mesh is None or not is_dtensor(t):
        return t
    Shard = placement_types()[2]
    n = (cfg.ssm_nheads,)
    heads = placements_for(rules.spec_for_shape(n, ("ssm_heads",)), t.device_mesh, n)
    return redistributed(t, [Shard(dim) if h.is_shard() else p for h, p in zip(heads, t.placements)])


def _conv_on_heads(params: dict, xbc_raw: torch.Tensor, cfg):
    """The causal conv of a DTensor xbc whose channels are whole on each
    rank: x's channels on each rank's heads (the conv's weights, a few KB,
    gathered and cut the same way), B's and C's replicated.  The conv is
    depthwise, so each channel's value is the unsharded one."""
    din, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    w, bias = (gather_dims(as_dtensor(params[k], xbc_raw.device_mesh), (params[k].ndim - 1,))
               for k in ("conv_w", "conv_b"))
    x = _causal_conv(_on_heads(xbc_raw[..., :din], 2, cfg), _on_heads(w[:, :din], 1, cfg),
                     _on_heads(bias[:din], 0, cfg))
    bc = _causal_conv(xbc_raw[..., din:], w[:, din:], bias[din:])
    return x, bc[..., :gn], bc[..., gn:]


def _ssm_inputs(params: dict, u: torch.Tensor, cfg):
    """in_proj, causal conv and the split: (z, raw xbc, x (B,S,H,P), B, C,
    dt (B,S,H) f32 after softplus).  On DTensors in_proj's column shards,
    which cut z, x, B, C and dt at no head boundary, are gathered once;
    then z, x and dt keep each rank's heads (the conv runs on its x
    channels) and B and C are replicated, as the reference's mixer keeps
    the head dim sharded."""
    b, s, _ = u.shape
    zxbcdt = matmul(u, params["in_proj"])
    if is_dtensor(zxbcdt):
        zxbcdt = gather_dims(zxbcdt, (zxbcdt.ndim - 1,))
    z, xbc_raw, dt = _split_in_proj(cfg, zxbcdt)
    if is_dtensor(xbc_raw):
        x, b_in, c_in = _conv_on_heads(params, xbc_raw, cfg)
        z, dt = _on_heads(z, 2, cfg), _on_heads(dt, 2, cfg)
    else:
        x, b_in, c_in = _split_xbc(cfg, _causal_conv(xbc_raw, params["conv_w"], params["conv_b"]))
    x = x.reshape(b, s, cfg.ssm_nheads, cfg.ssm_headdim)
    b_in = b_in.reshape(b, s, cfg.ssm_ngroups, cfg.ssm_state)
    c_in = c_in.reshape(b, s, cfg.ssm_ngroups, cfg.ssm_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    return z, xbc_raw, x, b_in, c_in, dt


def _ssd_padded(params: dict, x, dt, b_in, c_in, cfg):
    """ssd_chunked over the sequence padded to a chunk multiple with dt = 0
    (decay 1, no state update), so the final state is exact; y sliced back."""
    s = x.shape[1]
    extra = (-s) % cfg.ssm_chunk
    if extra:
        x = pad(x, (0, 0, 0, 0, 0, extra))
        dt = pad(dt, (0, 0, 0, extra))
        b_in = pad(b_in, (0, 0, 0, 0, 0, extra))
        c_in = pad(c_in, (0, 0, 0, 0, 0, extra))
    y, h_final = ssd_chunked(x, dt, params["a_log"], b_in, c_in, cfg.ssm_chunk)
    return y[:, :s], h_final


def _skip_and_gate(params: dict, y, x, z, u, cfg):
    b, s = u.shape[:2]
    y = y + params["d_skip"][None, None, :, None] * x.float()
    y = y.reshape(b, s, cfg.d_inner).to(u.dtype)
    return _gated_out(params, y, z, u, cfg)


def mamba2_forward(params: dict, u: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence forward (train, prefill without a state)."""
    z, _, x, b_in, c_in, dt = _ssm_inputs(params, u, cfg)
    y, _ = _ssd_padded(params, x, dt, b_in, c_in, cfg)
    return shard(_skip_and_gate(params, y, x, z, u, cfg), "batch", "seq", "act_d_model")


def mamba2_prefill(params: dict, u: torch.Tensor, cfg, state: dict) -> tuple[torch.Tensor, dict]:
    """Prefill that also returns the decode state: the conv tail (the last
    K-1 raw conv inputs, left-padded with zeros for a shorter prompt) and
    the final h."""
    z, xbc_raw, x, b_in, c_in, dt = _ssm_inputs(params, u, cfg)
    y, h_final = _ssd_padded(params, x, dt, b_in, c_in, cfg)
    out = _skip_and_gate(params, y, x, z, u, cfg)
    k = cfg.ssm_conv - 1
    s = u.shape[1]
    tail = xbc_raw[:, -k:] if s >= k else pad(xbc_raw, (0, 0, k - s, 0))
    return (shard(out, "batch", "seq", "act_d_model"),
            {"conv": tail.to(state["conv"].dtype), "h": h_final})


def mamba2_decode(params: dict, u: torch.Tensor, cfg, state: dict) -> tuple[torch.Tensor, dict]:
    """One recurrent step.  u: (B, 1, d_model).  Returns (out (B, 1, d), the
    new state); the caller decides where it is written."""
    b = u.shape[0]
    din = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    h = cfg.ssm_nheads
    z, xbc_new, dt = _split_in_proj(cfg, matmul(u[:, 0], params["in_proj"]))

    # conv ring buffer: window = [conv state, new input]
    window = torch.cat([state["conv"], xbc_new[:, None, :]], dim=1)  # (B, K, D)
    conv = einsum("bkd,kd->bd", window.float(), params["conv_w"].float())
    conv = F.silu(conv + params["conv_b"].float()).to(u.dtype)
    x = conv[:, :din].reshape(b, h, cfg.ssm_headdim)
    rep = h // g
    b_r = conv[:, din : din + g * n].reshape(b, g, n).repeat_interleave(rep, dim=1).float()
    c_r = conv[:, din + g * n :].reshape(b, g, n).repeat_interleave(rep, dim=1).float()

    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, H)
    decay = torch.exp(dt * params["a_log"])[..., None, None]
    h_new = state["h"] * decay + dt[..., None, None] * (x.float()[..., :, None] * b_r[:, :, None, :])
    y = einsum("bhn,bhpn->bhp", c_r, h_new)
    y = y + params["d_skip"][None, :, None] * x.float()
    y = y.reshape(b, 1, din).to(u.dtype)
    out = _gated_out(params, y, z[:, None], u, cfg)
    return (shard(out, "batch", "seq", "act_d_model"),
            {"conv": window[:, 1:].to(state["conv"].dtype), "h": h_new})
