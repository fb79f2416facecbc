"""Decode-time state of the port: the contiguous GQA cache (optionally int8),
the enc-dec model's cross-attention cache, the MLA latent cache, the Mamba2
SSM state and the paged block pool.

Caches are plain dicts of tensors in the JAX package's layouts: GQA
``k``/``v`` ``(B, KV, S, D)``, MLA ``ckv`` ``(B, S, kv_lora)`` and ``krope``
``(B, S, rope)``, each with per-sequence int32 ``lengths``; the int8 GQA
cache (``quant=True``, the reference's §Perf C3 variant) also holds f32
``k_scale``/``v_scale`` ``(B, KV, S)``, one absmax scale per token and KV
head (``quantize_kv``), written under the same mask and index as the
values; the cross cache
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

from repro_torch.distributed.sharding import is_dtensor, pad


def quantize_kv(x: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values, f32 scales) with absmax scaling along ``dim``, as
    the reference's ``quantize_kv``: scale = max(amax, 1e-8) / 127 in f32,
    values round(x / scale), half to even as ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(dim=dim).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale.unsqueeze(dim)).to(torch.int8), scale


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
    """Zeroed cache in the seq-major layout (B, KV, S, D); with ``quant``
    int8 values and f32 scales (B, KV, S)."""
    shape = (batch, n_kv, max_seq, head_dim)
    vdtype = torch.int8 if quant else dtype
    out = {
        "k": torch.zeros(shape, dtype=vdtype, device=device),
        "v": torch.zeros(shape, dtype=vdtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if quant:
        out["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        out["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return out


def kv_cache_axes(*, quant: bool = False) -> dict:
    """Logical axes of a GQA cache's leaves (the int8 scales included), for
    :mod:`repro_torch.distributed.sharding`."""
    out = {
        "k": ("cache_batch", "cache_kv_heads", "cache_seq", "head_dim"),
        "v": ("cache_batch", "cache_kv_heads", "cache_seq", "head_dim"),
        "lengths": ("cache_batch",),
    }
    if quant:
        out["k_scale"] = ("cache_batch", "cache_kv_heads", "cache_seq")
        out["v_scale"] = ("cache_batch", "cache_kv_heads", "cache_seq")
    return out


# -- DTensor caches ----------------------------------------------------------
#
# A sharded cache (a DTensor, its sequence dim split over a mesh axis by
# default) cannot take a write through an index or a slice along a sharded
# dim in place.  Its writers take the reference's form instead: a masked
# ``where`` over the whole buffer, which every rank applies to its own block.


def _put_prefix(buf: torch.Tensor, dim: int, new: torch.Tensor) -> None:
    """buf[..., :n, ...] = new along ``dim``, n = new.shape[dim]."""
    if not is_dtensor(buf):
        buf.narrow(dim, 0, new.shape[dim]).copy_(new)
        return
    n, size = new.shape[dim], buf.shape[dim]
    if n == size:
        buf.copy_(new)
        return
    widths = (0, 0) * (buf.dim() - 1 - dim) + (0, size - n)
    keep = (torch.arange(size, device=buf.device) < n).reshape(
        *[size if d == dim else 1 for d in range(buf.dim())])
    buf.copy_(torch.where(keep, pad(new.to(buf.dtype), widths), buf))


def _put_at(buf: torch.Tensor, dim: int, new: torch.Tensor, pos: torch.Tensor,
            ok: torch.Tensor) -> None:
    """Row b of ``buf`` takes ``new[b]`` at position ``pos[b]`` along ``dim``
    where ``ok[b]``, by a masked ``where`` over the whole buffer."""
    size = buf.shape[dim]
    hit = (torch.arange(size, device=buf.device)[None, :] == pos[:, None]) & ok[:, None]
    hit = hit.reshape(buf.shape[0], *[size if d == dim else 1 for d in range(1, buf.dim())])
    buf.copy_(torch.where(hit, new.to(buf.dtype).unsqueeze(dim), buf))


def write_prompt_kv(
    cache: dict, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor
) -> dict:
    """Write a prompt's K/V (B, S, KV, D activations) at positions [0, S),
    quantized where the cache is int8."""
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if "k_scale" in cache:
        (kt, ks), (vt, vs) = quantize_kv(kt), quantize_kv(vt)
        _put_prefix(cache["k_scale"], 2, ks)
        _put_prefix(cache["v_scale"], 2, vs)
    _put_prefix(cache["k"], 2, kt)
    _put_prefix(cache["v"], 2, vt)
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
    if is_dtensor(buf):
        every = torch.ones_like(lengths, dtype=torch.bool)
        _put_at(buf, dim, new, pos.expand(lengths.shape[0]), every if live is None else live)
        return
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
    if "k_scale" in cache:
        (k_new, ks), (v_new, vs) = quantize_kv(k_new), quantize_kv(v_new)
        _uniform_write(cache["k_scale"], 2, ks, cache["lengths"], live)
        _uniform_write(cache["v_scale"], 2, vs, cache["lengths"], live)
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
    full); rows that are not live keep theirs.  An int8 cache's scales
    are written at the same rows and positions."""
    k, v = cache["k"], cache["v"]
    rows, pos, ok = _append_index(cache["lengths"], k.shape[2], live)
    if "k_scale" in cache:
        (k_new, ks), (v_new, vs) = quantize_kv(k_new), quantize_kv(v_new)
        for buf, new in ((cache["k_scale"], ks), (cache["v_scale"], vs)):
            if is_dtensor(buf):
                _put_at(buf, 2, new, pos, ok)
            else:
                buf[rows, :, pos] = torch.where(ok[:, None], new, buf[rows, :, pos])
    if is_dtensor(k):
        _put_at(k, 2, k_new, pos, ok)
        _put_at(v, 2, v_new, pos, ok)
        cache["lengths"].add_(1 if live is None else live.to(torch.int32))
        return cache
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


def mla_cache_axes() -> dict:
    return {
        "ckv": ("cache_batch", "cache_seq", None),
        "krope": ("cache_batch", "cache_seq", None),
        "lengths": ("cache_batch",),
    }


def write_prompt_mla(
    cache: dict, ckv: torch.Tensor, krope: torch.Tensor, lengths: torch.Tensor
) -> dict:
    """Write a prompt's latents (B, S, kv_lora) and rope keys (B, S, rope) at
    positions [0, S)."""
    _put_prefix(cache["ckv"], 1, ckv)
    _put_prefix(cache["krope"], 1, krope)
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
    if is_dtensor(ckv):
        _put_at(ckv, 1, ckv_new, pos, ok)
        _put_at(krope, 1, krope_new, pos, ok)
        cache["lengths"].add_(1 if live is None else live.to(torch.int32))
        return cache
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


def ssm_state_axes() -> dict:
    return {
        "conv": ("cache_batch", None, None),
        "h": ("cache_batch", "ssm_heads", None, None),
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


# ---------------------------------------------------------------------------
# Paged KV cache (vLLM-style block tables)
# ---------------------------------------------------------------------------


class PagedKVCache:
    """The reference's paged cache: a pool of fixed-size blocks on
    ``device`` and per-request block tables kept on the host.  ``gather``
    copies a request's tokens into contiguous form.  Host bookkeeping
    around the pool, with no kernel: each ``append`` and ``gather`` is one
    indexed copy per pool, its block and offset indices built on the host.
    The pool holds ``dtype`` (the reference's numpy pool is f32 whatever
    its ``dtype``)."""

    def __init__(self, n_blocks: int, block_size: int, n_kv: int, head_dim: int, dtype, *,
                 device: torch.device):
        self.block_size = block_size
        self.n_kv = n_kv
        self.head_dim = head_dim
        self.device = torch.device(device)
        shape = (n_blocks, block_size, n_kv, head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.free: list[int] = list(range(n_blocks))[::-1]
        self.tables: dict[int, list[int]] = {}
        self.lengths: dict[int, int] = {}

    @property
    def n_free_blocks(self) -> int:
        return len(self.free)

    def allocate(self, req_id: int) -> None:
        assert req_id not in self.tables
        self.tables[req_id] = []
        self.lengths[req_id] = 0

    def release(self, req_id: int) -> None:
        self.free.extend(self.tables.pop(req_id, []))
        self.lengths.pop(req_id, None)

    def _ensure_capacity(self, req_id: int, new_len: int) -> None:
        need = -(-new_len // self.block_size)  # ceil
        table = self.tables[req_id]
        while len(table) < need:
            if not self.free:
                raise MemoryError("paged KV cache exhausted")
            table.append(self.free.pop())

    def _slots(self, req_id: int, start: int, stop: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(block, offset) index tensors of positions [start, stop)."""
        table, bs = self.tables[req_id], self.block_size
        blk = [table[p // bs] for p in range(start, stop)]
        off = [p % bs for p in range(start, stop)]
        return (torch.tensor(blk, dtype=torch.long, device=self.device),
                torch.tensor(off, dtype=torch.long, device=self.device))

    def append(self, req_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """k/v: (T, KV, D) -- append T tokens for request req_id."""
        t = k.shape[0]
        start = self.lengths[req_id]
        self._ensure_capacity(req_id, start + t)
        blk, off = self._slots(req_id, start, start + t)
        self.k_pool[blk, off] = k.to(self.k_pool)
        self.v_pool[blk, off] = v.to(self.v_pool)
        self.lengths[req_id] = start + t

    def gather(self, req_id: int, max_seq: int) -> tuple[torch.Tensor, torch.Tensor, int]:
        """A contiguous (max_seq, KV, D) copy of the request's tokens, zero
        past its length, and the length."""
        length = self.lengths[req_id]
        k = torch.zeros((max_seq, self.n_kv, self.head_dim), dtype=self.k_pool.dtype,
                        device=self.device)
        v = torch.zeros_like(k)
        blk, off = self._slots(req_id, 0, length)
        k[:length] = self.k_pool[blk, off]
        v[:length] = self.v_pool[blk, off]
        return k, v, length
