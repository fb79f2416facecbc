"""Dispatch between the port's CUDA kernels and their plain versions.

``impl``: ``"auto"`` takes the kernel for a CUDA tensor and the plain version
(``ref.py``) for a CPU tensor; ``"kernel"`` takes the kernel and raises on a
CPU tensor; ``"ref"`` takes the plain version on any device.  There is no
fallback: on a CUDA tensor ``auto`` launches the kernel or raises.

An op called without ``impl`` uses the default that :func:`use_impl` sets for
a block of code (``"auto"`` otherwise), so a whole model run can be switched
to the plain path, as ``chip_smoke.py`` does to compare the two on the card.

Gradients.  On the plain path autograd differentiates the plain versions.
On the kernel path ``rmsnorm`` and ``flash_attention`` go through a
``torch.autograd.Function`` whose forward is the forward kernel and whose
backward is the backward kernel (``rmsnorm_bwd``, ``flash_attention_bwd``),
but only when grad is enabled and an input requires it: otherwise (every
serving step) they launch the forward kernel directly, with no autograd node
and no saved tensors.  Only the Function asks the flash kernel for each
row's log-sum-exp, which its backward reads.  A gradient through a kernel is
a backward kernel or an error, never the plain version.
``decode_attention`` serves decode only and has no gradient.

DTensors (a model sharded over a device mesh).  Each op takes the same
kernel or plain version on this rank's block, above that choice: the inputs
are first redistributed to a layout the op can run block by block, and the
result is wrapped back as a DTensor.  ``rmsnorm`` keeps x's batch and
sequence shards and gathers ``w``; with ``split_rows`` (the SSM's gated
norm over its heads, on more than one rank) a shard of the last dimension
is kept too, its row statistic summed across the shards by one
all-reduce, in plain PyTorch on the block (the reference's jnp norm there
has no kernel).  The attentions keep batch and head shards, and sequence
shards thus:

* decode keeps the cache's sequence shard (flash-decoding): on that mesh
  dim q, a few KB a layer, is gathered instead; each rank runs the kernel
  over its own slice of the cache (its int8 scales beside it) with its
  lengths cut to the slice, then one all-gather of every slice's (out, lse)
  and an exact merge in f32 (``merge_partials``, one reduction over the
  slices) give each rank the same bits, and out takes q's placement back.
  A slice with no key of a row (past its length, or an uneven shard's
  empty tail) has weight 0.
* MLA's absorbed decode (``mla_decode_attention``, plain products, no
  kernel, as the reference computes it) keeps the latent cache's sequence
  shard the same way: each rank runs ``mla_decode_block`` on its rows
  (the block's own softmax, then p·c, and the block's lse), and the
  (ctx, lse) partials are gathered once and merged, ctx (kvlr wide) before
  W_uv.  With one block the merge gives the unsharded bits.
* the flash forward keeps q's sequence shard beside the whole k and v
  (gathered), its block start the query offset, in serving and in
  training alike; under autograd its backward runs at the same offset.
  Each rank's dk and dv then sum over its own q rows only: they are marked
  partial on the sequence's mesh dims, and autograd sums them across the
  shards (the all-reduce that k's and v's replicated constraint gives their
  gradient, as in the reference).

Nothing falls back to the gathered layout: a kernel or the merge that
fails raises.  Under GQA the rules may shard q's heads over an axis that
does not divide the KV heads, which then stay whole: the local q head ``h``
is global head ``offset + h``, so each rank slices the KV heads its q heads
read.  A replicated operand whose block-wise gradient differs per rank
(``w`` beside a sharded x, the sliced KV heads) receives a partial
gradient, summed over that mesh axis by autograd.  Plain tensors beside
DTensors count as replicated.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm

IMPLS = ("auto", "kernel", "ref")
_default = ["auto"]


@contextlib.contextmanager
def use_impl(impl: str) -> Iterator[None]:
    """Make ``impl`` the default of every op called inside the block."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    prev = _default[0]
    _default[0] = impl
    try:
        yield
    finally:
        _default[0] = prev


def _use_kernel(impl: str | None, t: torch.Tensor) -> bool:
    impl = impl or _default[0]
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and t.device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got one on {t.device}")
    return impl == "kernel" or (impl == "auto" and t.device.type == "cuda")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _RMSNorm(torch.autograd.Function):
    """The rmsnorm kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm.fused_rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _rmsnorm.fused_rmsnorm_bwd(x, w, g.contiguous(), ctx.eps)
        return dx, dw, None


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale, q_offset):
        o, lse = _flash.flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                                        return_lse=True, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.softmax_scale, ctx.q_offset = causal, softmax_scale, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash.flash_attention_bwd(
            q, k, v, o, do.contiguous(), lse, causal=ctx.causal, softmax_scale=ctx.softmax_scale,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# DTensor inputs: the op on this rank's block
# ---------------------------------------------------------------------------


def _mesh_of(*ts) -> object:
    return next(t.device_mesh for t in ts if sh.is_dtensor(t))


def _rmsnorm_blocks(x, w, eps, impl, split_rows):
    """rmsnorm of a DTensor x, row block by row block.  With ``split_rows``
    a last dim sharded over a mesh dim of more than one rank (the SSM's
    gated norm: y over its heads) stays split: each rank sums its columns'
    squares in f32, one all-reduce of that (..., 1) statistic gives each
    row's, and the block is normalized with its block of w in plain
    PyTorch, as the reference computes jnp there.  Otherwise the rows are
    gathered whole on each rank (a mesh dim of one rank holds them whole)
    and the op runs on them as on a plain tensor."""
    Partial, Replicate, Shard = sh.placement_types()
    mesh = _mesh_of(x, w)
    x, w = sh.as_dtensor(x, mesh), sh.as_dtensor(w, mesh)
    last = x.ndim - 1
    split = [split_rows and p.is_shard(last) and mesh.size(i) > 1 for i, p in enumerate(x.placements)]
    x_pl = [p if (p.is_shard() and p.dim < last) or s else Replicate()
            for p, s in zip(x.placements, split)]
    x = sh.redistributed(x, x_pl)
    w_pl = [Shard(0) if s else Replicate() for s in split]
    w_local = sh.redistributed(w, w_pl).to_local(
        grad_placements=[q if s else Partial() if p.is_shard() else Replicate()
                         for p, s, q in zip(x_pl, split, w_pl)])
    if not any(split):
        out = rmsnorm(x.to_local(), w_local, eps=eps, impl=impl)
        return sh.from_block(out, mesh, x_pl, x.shape)
    xl = x.to_local()
    xf = xl if xl.dtype == torch.float64 else xl.float()
    rows = [Partial() if s else p for p, s in zip(x_pl, split)]
    ss = sh.from_block(xf.square().sum(dim=-1, keepdim=True), mesh, rows, (*x.shape[:-1], 1))
    # each rank's gradient of the row statistic is partial: its columns' share
    ss = ss.redistribute(mesh, [Replicate() if s else p for p, s in zip(x_pl, split)]).to_local(
        grad_placements=rows)
    out = xf * torch.rsqrt(ss / x.shape[last] + eps)
    return sh.from_block((out * w_local.to(xf.dtype)).to(xl.dtype), mesh, x_pl, x.shape)


def _attention_layout(q, kvs, q_heads: int, kv_heads: int | None, *, q_seq: int | None = None,
                      kv_seq: int | None = None):
    """Placements that let attention run block by block: per mesh dimension,
    a batch shard of q is kept (the KV side follows it); with ``q_seq``, a
    sequence shard of q (that dim) is kept beside the whole KV side, placed
    by a query offset; with ``kv_seq``, a sequence shard of the KV side (that
    dim) is kept beside the whole q, its slices' partials merged; a head
    shard of q is kept with the KV side's head shard where both divide
    evenly, else the KV side is replicated; anything else (a sequence shard
    not kept, a partial) is gathered.  Returns (q's, the KV side's, the mesh
    dims whose KV heads are replicated beside q's head shard, the mesh dims
    that keep a sequence shard).  ``kv_heads`` None: the KV side has no
    heads (MLA's latent cache, which every head reads), so a head shard of
    q is kept beside the whole KV side, nothing sliced."""
    _, Replicate, Shard = sh.placement_types()
    sizes = q.device_mesh.shape
    q_pl, kv_pl, sliced, seq = [], [], [], []
    for i, pq in enumerate(q.placements):
        if pq.is_shard(0):
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
        elif q_seq is not None and pq.is_shard(q_seq):
            q_pl.append(Shard(q_seq))
            kv_pl.append(Replicate())
            seq.append(i)
        elif kv_seq is not None and all(t.placements[i].is_shard(kv_seq) for t in kvs):
            q_pl.append(Replicate())
            kv_pl.append(Shard(kv_seq))
            seq.append(i)
        elif pq.is_shard(q_heads) and q.shape[q_heads] % sizes[i] == 0:
            q_pl.append(Shard(q_heads))
            even = kv_heads is not None and \
                all(t.placements[i].is_shard(kv_heads) for t in kvs) and \
                kvs[0].shape[kv_heads] % sizes[i] == 0
            kv_pl.append(Shard(kv_heads) if even else Replicate())
            if not even and kv_heads is not None:
                sliced.append(i)
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    return q_pl, kv_pl, sliced, seq


def _kv_heads_for(q, q_pl, kv, kv_pl, q_heads: int, kv_heads: int) -> slice | list[int]:
    """The local KV heads this rank's q heads read: global q head g reads KV
    head g // n_rep.  A slice where the local heads share them in equal
    groups (the kernels' h // n_rep), else one KV head per q head."""
    mesh = q.device_mesh
    qb = sh.local_block(tuple(q.shape), mesh, tuple(q_pl))[q_heads]
    kb = sh.local_block(tuple(kv.shape), mesh, tuple(kv_pl))[kv_heads]
    n_rep = q.shape[q_heads] // kv.shape[kv_heads]
    heads = [(g // n_rep) - kb.start for g in range(qb.start, qb.stop)]
    if min(heads) < 0 or max(heads) >= kb.stop - kb.start:
        raise ValueError(f"q heads {qb} read KV heads outside this rank's block {kb}")
    lo, hi = heads[0], heads[-1] + 1
    group = len(heads) // (hi - lo)
    if len(heads) % (hi - lo) == 0 and heads == [lo + j // group for j in range(len(heads))]:
        return slice(lo, hi)
    return heads


def _flash_blocks(q, k, v, causal, softmax_scale, q_offset, impl):
    """q's sequence shard beside the whole k and v, its block start the
    query offset, forward and backward; k's and v's gradients are partial
    on the mesh dims that shard q's sequence (each rank's sum over its own q
    rows) and on those whose KV heads are sliced."""
    Partial, Replicate, _ = sh.placement_types()
    mesh = _mesh_of(q, k, v)
    q, k, v = (sh.as_dtensor(t, mesh) for t in (q, k, v))
    q_pl, kv_pl, sliced, seq = _attention_layout(q, (k, v), 2, 2, q_seq=1)
    q, k, v = sh.redistributed(q, q_pl), sh.redistributed(k, kv_pl), sh.redistributed(v, kv_pl)
    grad_pl = [Partial() if i in sliced or i in seq else p for i, p in enumerate(kv_pl)]
    heads = _kv_heads_for(q, q_pl, k, kv_pl, 2, 2)
    kl, vl = (t.to_local(grad_placements=grad_pl)[:, :, heads] for t in (k, v))
    start = sh.local_block(tuple(q.shape), mesh, tuple(q_pl))[1].start
    out = flash_attention(q.to_local(), kl.contiguous(), vl.contiguous(), causal=causal,
                          softmax_scale=softmax_scale, q_offset=q_offset + start, impl=impl)
    return sh.from_block(out, mesh, q_pl, (*q.shape[:3], v.shape[3]))


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact softmax attention over a whole cache from the partials of
    its n slices: ``outs`` (n, ..., D) each slice's output, ``lses`` (n, ...)
    each slice's log-sum-exp in the log2 domain, ``-inf`` where the slice
    holds no key of the row (``decode_attention(..., return_lse=True)``).
    In f32, as one reduction over the slices' dim whatever their number, so
    that every rank holding the same partials holds the same bits (the same
    kernels on the same data): m = max lse, w_i = 2^(lse_i - m), out = sum
    w_i out_i / sum w_i, lse = m + log2(sum w_i).  A row with no key in any
    slice gives out 0 and lse -inf.  Returns (out f32, lse)."""
    lses = lses.float()
    m = lses.amax(dim=0)
    m_use = torch.where(m == float("-inf"), 0.0, m)
    w = torch.exp2(lses - m_use)  # 0 for a slice with no key of the row
    den = w.sum(dim=0)
    num = (w[..., None] * outs.float()).sum(dim=0)
    lse = torch.where(den > 0, m_use + torch.log2(den), float("-inf"))
    return num / den.clamp_min(1e-30)[..., None], lse


def _decode_slice(q, kc, vc, lengths, impl, **kw):
    """(out, lse) over one cache slice; a slice of no rows (an uneven
    sequence shard's tail) holds no key."""
    if kc.shape[2] == 0:
        return torch.zeros_like(q), torch.full(q.shape[:2], float("-inf"), device=q.device)
    return decode_attention(q, kc, vc, lengths, impl=impl, return_lse=True, **kw)


def _gathered_partials(out, lse, mesh, q_pl, seq, shape):
    """Every rank's (out, lse) over its cache slice for this rank's rows
    and heads, stacked in rank order along the mesh dims ``seq``: one
    all-gather of (out, lse) in f32, a few KB a layer."""
    _, Replicate, Shard = sh.placement_types()
    part = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    pl = [Shard(0) if i in seq else Shard(p.dim + 1) if p.is_shard() else Replicate()
          for i, p in enumerate(q_pl)]
    n = math.prod(mesh.size(i) for i in seq)
    full = sh.from_block(part, mesh, pl, (n, *shape[:2], shape[2] + 1))
    whole = sh.redistributed(full, [Replicate() if i in seq else p for i, p in enumerate(pl)])
    whole = whole.to_local()
    return whole[..., :-1], whole[..., -1]


def _decode_blocks(q, k_cache, v_cache, lengths, kw, impl):
    """On a mesh dim that shards the cache's sequence (flash-decoding): q is
    gathered there instead, each rank runs the kernel over its own cache
    slice with its lengths cut to it, and the slices' (out, lse) are merged
    exactly (``merge_partials``); out then takes q's placement back."""
    _, Replicate, Shard = sh.placement_types()
    mesh = _mesh_of(q, k_cache, v_cache)
    q, k_cache, v_cache, lengths = (sh.as_dtensor(t, mesh) for t in (q, k_cache, v_cache, lengths))
    scales = {n: sh.as_dtensor(kw[n], mesh) for n in ("k_scale", "v_scale") if kw.get(n) is not None}
    q_own = tuple(q.placements)
    q_pl, kv_pl, _, seq = _attention_layout(q, (k_cache, v_cache), 1, 1, kv_seq=2)
    b_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in q_pl]
    q, lengths = sh.redistributed(q, q_pl), sh.redistributed(lengths, b_pl)
    k_cache, v_cache = sh.redistributed(k_cache, kv_pl), sh.redistributed(v_cache, kv_pl)
    heads = _kv_heads_for(q, q_pl, k_cache, kv_pl, 1, 1)
    local = {n: sh.redistributed(t, kv_pl).to_local()[:, heads].contiguous()
             for n, t in scales.items()}
    args = (q.to_local(), k_cache.to_local()[:, heads].contiguous(),
            v_cache.to_local()[:, heads].contiguous(), lengths.to_local())
    kw = dict(softmax_scale=kw.get("softmax_scale"), k_scale=local.get("k_scale"),
              v_scale=local.get("v_scale"))
    if not seq:
        return sh.from_block(decode_attention(*args, impl=impl, **kw), mesh, q_pl, q.shape)
    rows = sh.local_block(tuple(k_cache.shape), mesh, tuple(kv_pl))[2]
    lens = (args[3] - rows.start).clamp(0, rows.stop - rows.start).to(torch.int32)
    out, lse = _decode_slice(*args[:3], lens, impl, **kw)
    out, _ = merge_partials(*_gathered_partials(out, lse, mesh, q_pl, seq, q.shape))
    out_pl = [q_own[i] if i in seq and q_own[i].is_shard() else p for i, p in enumerate(q_pl)]
    return sh.redistributed(sh.from_block(out.to(q.dtype), mesh, q_pl, q.shape), out_pl)


NEG_INF = -1e30  # the reference's score mask (models.layers.NEG_INF)
mla_block_calls = 0  # calls of the sequence-sharded MLA decode's block path (no kernel)


def mla_decode_block(q_abs, q_rope, ckv, krope, lengths, *, softmax_scale: float, start: int = 0,
                     return_lse: bool = False):
    """MLA's absorbed decode over the latent cache rows [start, start + S)
    that ``ckv`` (B, S, kvlr) and ``krope`` (B, S, rope) hold, in f32 as
    the reference computes it: s = (q_abs·c + q_rope·kr) · scale, NEG_INF
    where start + j >= lengths, then ctx = softmax(s)·c (B, H, kvlr).
    ``return_lse``: also each head's log-sum-exp of s in the log2 domain
    (``merge_partials``), -inf where the block holds no key of the row, so
    that it weighs 0 in a merge; a block of no rows gives ctx 0 and lse
    -inf.  One block merged alone gives ctx's bits back (weight 2^0 = 1,
    divisor 1)."""
    if return_lse and ckv.shape[1] == 0:
        b, h = q_abs.shape[:2]
        return (torch.zeros((b, h, ckv.shape[2]), device=ckv.device),
                torch.full((b, h), float("-inf"), device=ckv.device))
    c = ckv.float()
    s_latent = torch.einsum("bhr,bsr->bhs", q_abs.float(), c)
    s_rope = torch.einsum("bhk,bsk->bhs", q_rope.float(), krope.float())
    s = (s_latent + s_rope) * softmax_scale
    valid = torch.arange(start, start + c.shape[1], device=c.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    ctx = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c)
    if not return_lse:
        return ctx
    lse = torch.logsumexp(s, dim=-1) / math.log(2.0)
    return ctx, torch.where(valid.any(dim=1)[:, None], lse, float("-inf"))


def _mla_decode_blocks(q_abs, q_rope, ckv, krope, lengths, softmax_scale):
    """On a mesh dim that shards the latent cache's sequence (flash-decoding,
    as ``_decode_blocks``): q_abs and q_rope are gathered there instead, a
    few KB a layer; each rank runs ``mla_decode_block`` on its own rows from
    its block start; one all-gather of every block's (ctx, lse) and
    ``merge_partials`` give each rank the same bits, merged before W_uv as
    the reference orders it; ctx then takes q_abs's placement back."""
    global mla_block_calls
    _, Replicate, Shard = sh.placement_types()
    mesh = _mesh_of(q_abs, q_rope, ckv, krope)
    q_abs, q_rope, ckv, krope, lengths = (sh.as_dtensor(t, mesh)
                                          for t in (q_abs, q_rope, ckv, krope, lengths))
    q_own = tuple(q_abs.placements)
    q_pl, kv_pl, _, seq = _attention_layout(q_abs, (ckv, krope), 1, None, kv_seq=1)
    b_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in q_pl]
    q_abs, q_rope = sh.redistributed(q_abs, q_pl), sh.redistributed(q_rope, q_pl)
    ckv, krope = sh.redistributed(ckv, kv_pl), sh.redistributed(krope, kv_pl)
    lengths = sh.redistributed(lengths, b_pl)
    rows = sh.local_block(tuple(ckv.shape), mesh, tuple(kv_pl))[1]
    ctx, lse = mla_decode_block(*(t.to_local() for t in (q_abs, q_rope, ckv, krope, lengths)),
                                softmax_scale=softmax_scale, start=rows.start, return_lse=True)
    mla_block_calls += 1
    ctx, _ = merge_partials(*_gathered_partials(ctx, lse, mesh, q_pl, seq, q_abs.shape))
    out_pl = [q_own[i] if i in seq and q_own[i].is_shard() else p for i, p in enumerate(q_pl)]
    return sh.redistributed(sh.from_block(ctx, mesh, q_pl, q_abs.shape), out_pl)


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5, impl: str | None = None,
            split_rows: bool = False):
    """``split_rows`` (DTensors): keep a shard of x's last dim, the row
    statistic all-reduced across it (``_rmsnorm_blocks``)."""
    if sh.is_dtensor(x) or sh.is_dtensor(w):
        return _rmsnorm_blocks(x, w, eps, impl, split_rows)
    if _use_kernel(impl, x):
        if _needs_grad(x, w):
            return _RMSNorm.apply(x, w, eps)
        return _rmsnorm.fused_rmsnorm(x, w, eps)
    return ref.rmsnorm_ref(x, w, eps)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    q_offset: int = 0,
    impl: str | None = None,
):
    """``q_offset``: the global position of q's row 0, which the causal mask
    reads (a sequence shard of q beside the whole k and v), forward and
    backward."""
    if any(sh.is_dtensor(t) for t in (q, k, v)):
        return _flash_blocks(q, k, v, causal, softmax_scale, q_offset, impl)
    if _use_kernel(impl, q):
        if _needs_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, softmax_scale, q_offset)
        return _flash.flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                                      q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, softmax_scale=softmax_scale,
                                   q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softmax_scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    return_lse: bool = False,
    impl: str | None = None,
):
    """``k_scale``/``v_scale``: the (B, KV, S) scales of an int8 cache.
    ``return_lse`` (plain tensors): also each head's log-sum-exp, (B, H)
    f32, ``-inf`` for a row of length 0 (``decode_attention.decode_attention``)."""
    kw = dict(softmax_scale=softmax_scale, k_scale=k_scale, v_scale=v_scale)
    if any(sh.is_dtensor(t) for t in (q, k_cache, v_cache)):
        if return_lse:
            raise ValueError("decode_attention: return_lse takes plain tensors, not DTensors")
        return _decode_blocks(q, k_cache, v_cache, lengths, kw, impl)
    kw["return_lse"] = return_lse
    if _use_kernel(impl, q):
        return _decode.decode_attention(q, k_cache, v_cache, lengths, **kw)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, **kw)


def mla_decode_attention(q_abs, q_rope, ckv, krope, lengths, *, softmax_scale: float):
    """MLA's absorbed decode over the whole latent cache: ctx (B, H, kvlr)
    f32 (``mla_decode_block``), in plain products, as the reference computes
    it outside any Pallas kernel.  A latent cache sharded along its sequence
    (DTensors) keeps its shard (``_mla_decode_blocks``); any other input
    runs the block function over the whole cache (through DTensor's own ops
    on DTensors)."""
    if sh.is_dtensor(ckv) and sh.is_dtensor(krope) and any(
            a.is_shard(1) and b.is_shard(1) for a, b in zip(ckv.placements, krope.placements)):
        return _mla_decode_blocks(q_abs, q_rope, ckv, krope, lengths, softmax_scale)
    return mla_decode_block(q_abs, q_rope, ckv, krope, lengths, softmax_scale=softmax_scale)


# kernel name -> (wrapper module, its launch counter)
KERNELS = {
    "rmsnorm": (_rmsnorm, "launches"),
    "flash_attention": (_flash, "launches"),
    "decode_attention": (_decode, "launches"),
    "rmsnorm_bwd": (_rmsnorm, "bwd_launches"),
    "flash_attention_bwd": (_flash, "bwd_launches"),
}


# variant name -> (wrapper module, its counter): the launches of a kernel
# above that also take an option of sequence-sharded serving or training
# (each also counts under the kernel's own name)
VARIANTS = {
    "decode_attention_lse": (_decode, "lse_launches"),
    "flash_attention_q_offset": (_flash, "offset_launches"),
    "flash_attention_bwd_q_offset": (_flash, "bwd_offset_launches"),
}
_COUNTERS = {**KERNELS, **VARIANTS}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def variant_counts() -> dict[str, int]:
    """Launches per variant (``VARIANTS``) since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in VARIANTS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` to the kernels' counters: the launches of a replayed
    CUDA graph, which the wrappers' Python counters do not see."""
    for name, n in counts.items():
        mod, attr = KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


@contextlib.contextmanager
def uncounted() -> Iterator[dict[str, int]]:
    """Launches inside the block leave the counters as they were.  The
    yielded dict receives, at the block's end, the launches made inside it
    (a graph capture's: the kernels each replay will launch)."""
    before = {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}
    inside: dict[str, int] = {}
    try:
        yield inside
    finally:
        after = launch_counts()
        inside.update({k: after[k] - before[k] for k in after})
        for name, (mod, attr) in _COUNTERS.items():
            setattr(mod, attr, before[name])
