"""Decode-time KV cache of the port: the contiguous GQA cache.

Caches are plain dicts of tensors, in the JAX package's layout
``(B, KV, S, D)`` with per-sequence ``lengths``.  Unlike the functional JAX
versions, the writers here update the cache in place and return it: the
engine and the model hold one buffer per slot and never need the old one.
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
    k, v, lengths = cache["k"], cache["v"], cache["lengths"]
    smax = k.shape[2]
    rows = torch.arange(k.shape[0], device=k.device)
    pos = lengths.long().clamp(0, smax - 1)
    ok = lengths < smax
    if live is not None:
        ok = ok & live
    keep = ok[:, None, None]
    k[rows, :, pos] = torch.where(keep, k_new.to(k.dtype), k[rows, :, pos])
    v[rows, :, pos] = torch.where(keep, v_new.to(v.dtype), v[rows, :, pos])
    lengths.add_(1 if live is None else live.to(lengths.dtype))
    return cache
