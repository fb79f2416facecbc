"""Decode-time state of the port: the contiguous GQA cache, the enc-dec
model's cross-attention cache, the MLA latent cache and the Mamba2 SSM state.

Caches are plain dicts of tensors in the JAX package's layouts: GQA
``k``/``v`` ``(B, KV, S, D)``, MLA ``ckv`` ``(B, S, kv_lora)`` and ``krope``
``(B, S, rope)``, each with per-sequence int32 ``lengths``; the cross cache
``k``/``v`` ``(L, B, KV, frames, D)`` stacked over the decoder's layers,
with one ``lengths`` ``(B,)``; the SSM state ``conv`` ``(B, K-1, d_xbc)``
and ``h`` ``(B, H, P, N)`` in f32.  Unlike the
functional JAX versions, the writers here update the cache in place and
return it: the engine and the model hold one buffer per slot and never need
the old one.

Two appends: per row at each sequence's own length (``append_kv``,
``append_mla``), and the lockstep one of a ``uniform_decode`` config
(``append_kv_uniform``, ``append_mla_uniform``), which writes every row at
the batch's largest length, as the reference does: a straggler row's token
lands past its own length, where its attention does not read it.
"""

from __future__ import annotations

import torch


def init_kv_cache(
    batch: int,
    max_seq: int,
    n_kv: int,
    head_dim: int,
    dtype,
    *,
    quant: bool = False,
    device: torch.device,
) -> dict:
    """Zeroed cache in the seq-major layout (B, KV, S, D)."""
    if quant:
        raise NotImplementedError("int8 KV cache: not yet ported")
    shape = (batch, n_kv, max_seq, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def write_prompt_kv(
    cache: dict, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> dict:
    """Write a prompt's K/V (B, S, KV, D activations) at positions [0, S)."""
    s = k.shape[1]
    cache["k"][:, :, :s].copy_(k.transpose(1, 2))
    cache["v"][:, :, :s].copy_(v.transpose(1, 2))
    cache["lengths"].copy_(lengths)
    return cache


def _append_index(lengths: torch.Tensor, smax: int, live: torch.Tensor | None):
    """Rows, clamped write positions and the rows to write for a one-token
    append at each sequence's length: live rows below the cache size."""
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    pos = lengths.long().clamp(0, smax - 1)
    ok = lengths < smax
    return rows, pos, ok if live is None else ok & live


def _uniform_write(buf: torch.Tensor, dim: int, new: torch.Tensor, lengths: torch.Tensor,
                   live: torch.Tensor | None) -> None:
    """Write ``new`` (``buf`` without axis ``dim``) at the batch's largest
    length along ``dim``, clamped into the cache as ``dynamic_update_slice``
    clamps its start, in place; rows that are not live keep theirs.  The
    position stays on the device (no host read)."""
    pos = lengths.max().long().clamp(0, buf.shape[dim] - 1).reshape(1)
    new = new.to(buf.dtype).unsqueeze(dim)
    if live is not None:
        keep = live.reshape(-1, *([1] * (buf.dim() - 1)))
        new = torch.where(keep, new, buf.index_select(dim, pos))
    buf.index_copy_(dim, pos, new)


def append_kv_uniform(
    cache: dict,
    k_new: torch.Tensor,  # (B, KV, D)
    v_new: torch.Tensor,
    live: torch.Tensor | None = None,  # (B,) bool; None = every row
) -> dict:
    """Lockstep append: every row writes at the batch's largest length, then
    every live row's length grows by one, in place."""
    _uniform_write(cache["k"], 2, k_new, cache["lengths"], live)
    _uniform_write(cache["v"], 2, v_new, cache["lengths"], live)
    cache["lengths"].add_(1 if live is None else live.to(torch.int32))
    return cache


def append_kv(
    cache: dict,
    k_new: torch.Tensor,  # (B, KV, D)
    v_new: torch.Tensor,
    live: torch.Tensor | None = None,  # (B,) bool; None = every row
) -> dict:
    """Append one token's K/V at each sequence's current length, in place.

    A row is written only where it is live and its length is below the cache
    size; the reference's masked ``where`` writes nothing past the end either.
    The index is clamped, so a full or free slot never indexes out of the
    cache.  Live rows' lengths grow by one (as in the reference, even when
    full); rows that are not live keep theirs."""
    k, v = cache["k"], cache["v"]
    rows, pos, ok = _append_index(cache["lengths"], k.shape[2], live)
    keep = ok[:, None, None]
    k[rows, :, pos] = torch.where(keep, k_new.to(k.dtype), k[rows, :, pos])
    v[rows, :, pos] = torch.where(keep, v_new.to(v.dtype), v[rows, :, pos])
    cache["lengths"].add_(1 if live is None else live.to(torch.int32))
    return cache


def init_cross_cache(
    n_layers: int, batch: int, n_frames: int, n_kv: int, head_dim: int, dtype, *,
    device: torch.device,
) -> dict:
    """Zeroed cross-attention cache of an enc-dec model, seq-major like the
    decode cache: k/v (L, B, KV, frames, D), lengths (B,)."""
    shape = (n_layers, batch, n_kv, n_frames, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def write_cross_kv(cross: dict, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Store one decoder layer's cross K/V (B, frames, KV, D activations)
    seq-major, and every row's length as the frame count, in place.  The
    frame count must be the cache's."""
    if k.shape[1] != cross["k"].shape[3]:
        raise ValueError(f"cross cache holds {cross['k'].shape[3]} frames, got {k.shape[1]}")
    cross["k"][layer].copy_(k.transpose(1, 2))
    cross["v"][layer].copy_(v.transpose(1, 2))
    cross["lengths"].fill_(k.shape[1])


# ---------------------------------------------------------------------------
# MLA compressed cache (latent c_kv + shared rope key per token)
# ---------------------------------------------------------------------------


def init_mla_cache(
    batch: int, max_seq: int, kv_lora_rank: int, rope_dim: int, dtype, *, device: torch.device
) -> dict:
    """Zeroed latent cache: ckv (B, S, kv_lora), krope (B, S, rope)."""
    return {
        "ckv": torch.zeros((batch, max_seq, kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, max_seq, rope_dim), dtype=dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def write_prompt_mla(
    cache: dict, ckv: torch.Tensor, krope: torch.Tensor, lengths: torch.Tensor
) -> dict:
    """Write a prompt's latents (B, S, kv_lora) and rope keys (B, S, rope) at
    positions [0, S)."""
    s = ckv.shape[1]
    cache["ckv"][:, :s].copy_(ckv)
    cache["krope"][:, :s].copy_(krope)
    cache["lengths"].copy_(lengths)
    return cache


def append_mla_uniform(
    cache: dict,
    ckv_new: torch.Tensor,  # (B, kv_lora)
    krope_new: torch.Tensor,  # (B, rope)
    live: torch.Tensor | None = None,
) -> dict:
    """Lockstep MLA append, as ``append_kv_uniform``."""
    _uniform_write(cache["ckv"], 1, ckv_new, cache["lengths"], live)
    _uniform_write(cache["krope"], 1, krope_new, cache["lengths"], live)
    cache["lengths"].add_(1 if live is None else live.to(torch.int32))
    return cache


def append_mla(
    cache: dict,
    ckv_new: torch.Tensor,  # (B, kv_lora)
    krope_new: torch.Tensor,  # (B, rope)
    live: torch.Tensor | None = None,  # (B,) bool; None = every row
) -> dict:
    """Append one token's latent and rope key at each sequence's length, in
    place, with the same live-row mask and clamped index as ``append_kv``: a
    free or full slot is never written."""
    ckv, krope = cache["ckv"], cache["krope"]
    rows, pos, ok = _append_index(cache["lengths"], ckv.shape[1], live)
    keep = ok[:, None]
    ckv[rows, pos] = torch.where(keep, ckv_new.to(ckv.dtype), ckv[rows, pos])
    krope[rows, pos] = torch.where(keep, krope_new.to(krope.dtype), krope[rows, pos])
    cache["lengths"].add_(1 if live is None else live.to(torch.int32))
    return cache


# ---------------------------------------------------------------------------
# Mamba2 SSM state (constant size per sequence)
# ---------------------------------------------------------------------------


def init_ssm_state(batch: int, cfg, *, device: torch.device) -> dict:
    """Zeroed state: conv (B, K-1, d_xbc) in cfg.dtype, h (B, H, P, N) f32."""
    d_xbc = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_xbc), dtype=cfg.dtype, device=device),
        "h": torch.zeros(
            (batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state), dtype=torch.float32,
            device=device),
    }


def write_ssm_state(state: dict, new: dict, live: torch.Tensor | None = None) -> dict:
    """Copy a new SSM state into ``state`` in place; rows that are not live
    keep theirs (the reference engine's select of the old state)."""
    for name, buf in state.items():
        if live is None:
            buf.copy_(new[name])
        else:
            buf.copy_(torch.where(live.reshape(-1, *([1] * (buf.dim() - 1))), new[name], buf))
    return state
