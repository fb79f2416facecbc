"""Blocked exact attention on the card (wrapper of ``csrc/flash_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``).  Bound on the H100: operations at
long prompts; at the serving prompt (S=512) bytes and operations are close.
Two kernels, chosen by dtype:

* bf16 (serving): both products on the tensor cores (``wgmma``), Q and the
  K/V tiles loaded by TMA into a 2-stage ring on mbarriers, two 64-row
  warpgroups per 128-row q-block, the kv loop stopped at the causal diagonal
  and only the diagonal and tail tiles masked.  The probabilities are
  rounded to bf16 for the PV product.  Needs 16-byte aligned q, k, v.
* f32: f32 FMAs (TF32 would miss the 3e-5 tolerance), register-tiled from
  float4 loads of shared rows padded by 4 floats, K/V tiles on a cp.async
  ring, 256 threads a CTA; the q-block height (64 rows, or 32 where 64 would
  give the card fewer CTAs than SMs) comes from ``fwd_plan``, the heaviest
  causal q-blocks first.  Needs 16-byte aligned q, k, v.

Head dims: 16, 32, 64 (whisper, also non-causal with Sq != Sk for its
cross-attention), 80 (zamba2's shared block), 96 (MLA's qk dim), 128 and 192
(nemotron) run natively.  D = 24 (the
REDUCED MLA config) is zero-padded to 32 here and the output sliced back:
zero columns add nothing to QK^T and give zero output columns.  Any other D
raises.

``q_offset`` is the global position of q's row 0, which the causal mask
reads (k_pos <= q_offset + q_pos): a sequence shard of q beside the whole k
and v, as sequence-parallel prefill and training keep it.  A non-causal
call ignores it.  The backward takes the same offset as its forward.

``return_lse=True`` also returns each row's log-sum-exp, (B, H, Sq) f32 in
the log2 domain of the scaled scores (``ref.flash_attention_lse_ref``); only
the training path asks for it.  Its storage rows are ``lse_stride(Sq)`` long
(a multiple of 128), which the backward needs.

``flash_attention_bwd`` wraps the backward (``csrc/flash_attention_bwd.cu``),
which has no TPU counterpart: the JAX package differentiates its plain
attention, but the port's model calls this kernel, so its gradient is a
kernel too.  It takes the forward's output and log-sum-exp, and the same
head dims (24 padded as here).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Iterator

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192)
PADDED_HEAD_DIMS = {24: 32}  # D -> the instantiated width it is zero-padded to
LSE_ALIGN = 128  # the log-sum-exp's rows are padded to a multiple of this
SMS = 132  # streaming multiprocessors of an H100 SXM, the card fwd_plan sizes the grid for
SMEM_SM = 228 * 1024  # shared memory of an H100 SM (1 KB of it reserved per CTA)
SMEM_CTA = 227 * 1024  # shared memory a CTA can have

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)
offset_launches = 0  # those of them with a query offset above 0
bwd_launches = 0  # the same, of the backward kernel
bwd_offset_launches = 0  # those of them with a query offset above 0


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    return_lse: bool = False,
    q_offset: int = 0,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention out (B, Sq, H, D); with ``return_lse`` also (out, lse)."""
    global launches, offset_launches
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash kernel needs q_offset >= 0, got {q_offset}")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if d in PADDED_HEAD_DIMS:
        pad = PADDED_HEAD_DIMS[d] - d
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel needs 16-byte aligned q, k, v (TMA for bf16, cp.async for f32)")
    plan = fwd_plan(b, sq, sk, h, q.shape[3], q.element_size())
    out = torch.empty_like(q)
    ls = lse_stride(sq)
    lse = torch.empty(b, h, ls, dtype=torch.float32, device=q.device) if return_lse else None
    fn = _build.function(
        "flash_attention",
        "flash_attention_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, ls,
        b, sq, sk, h, kv, q.shape[3], scale, int(causal), int(q_offset), _build.DTYPES[q.dtype],
        plan.block_q,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", err)
    launches += 1
    if q_offset:
        offset_launches += 1
    out = out[..., :d]  # a padded D's zero columns dropped; else the whole of out
    return (out, lse[..., :sq]) if return_lse else out


@dataclass(frozen=True)
class FwdPlan:
    """The forward's launch at one shape (``fwd_plan``)."""

    b: int
    sq: int
    h: int
    block_q: int  # query rows a CTA
    block_k: int  # keys a K/V tile
    stages: int  # K/V tiles in flight (the ring's depth)
    smem: int  # dynamic shared memory of a CTA, bytes
    per_sm: int  # CTAs an SM holds by shared memory
    heads_inner: bool  # CTA order: q-block outermost over all sequences (f32), or per sequence (bf16)

    @property
    def ctas(self) -> int:
        return -(-self.sq // self.block_q) * self.h * self.b

    def q_blocks(self) -> Iterator[tuple[int, int, int]]:
        """(sequence, head, first query row) of each CTA in launch order, as
        the kernel maps its block index: the heaviest causal q-blocks first
        (the f32 kernel over all sequences at once; the bf16 kernel's grid
        (H, q-blocks, B) sequence by sequence)."""
        nqb = -(-self.sq // self.block_q)
        if self.heads_inner:
            for idx in range(self.ctas):
                yield idx % self.b, idx // self.b % self.h, (nqb - 1 - idx // (self.b * self.h)) * self.block_q
        else:
            for b in range(self.b):
                for y in range(nqb):
                    for h in range(self.h):
                        yield b, h, (nqb - 1 - y) * self.block_q


def fwd_plan(b: int, sq: int, sk: int, h: int, d: int, elem: int) -> FwdPlan:
    """The forward kernel's launch for q (b, sq, h, d) and sk keys of
    ``elem``-byte elements, from the shape alone (so the bits do not depend
    on the card).  bf16 (elem 2): the wgmma kernel's fixed 128-row q-blocks,
    64-key tiles, 2 stages.  f32 (elem 4): 64-row q-blocks, or 32 where 64
    would give the card fewer CTAs than SMS (a short grid: smaller blocks
    balance it); K/V tiles of 64 keys (32 at D = 192), on a ring of 3 stages
    where two CTAs still fit an SM, else 2, else as deep as one CTA can hold
    (the layout of ``Fwd<D, BQ>`` in csrc/flash_attention.cu: Q, the K and V
    stages and P in rows padded by 4 floats, D = 16 and 80 run 32 and 96
    wide on zero columns, 5 floats a row of partial maxima and sums)."""
    del sk  # the plan does not depend on it: a CTA walks every key tile it needs
    d = PADDED_HEAD_DIMS.get(d, d)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d} not in {HEAD_DIMS}")
    if elem == 2:
        bq, bk, ns = 128, 64, 2
        smem = bq * d * 2 + 2 * ns * bk * d * 2 + 8 * (1 + 2 * ns) + 1024
        return FwdPlan(b, sq, h, bq, bk, ns, smem, SMEM_SM // (smem + 1024), heads_inner=False)
    if elem != 4:
        raise ValueError(f"flash kernel takes 2- or 4-byte elements, got {elem}")
    dc = {16: 32, 80: 96}.get(d, d)
    ld, bk = dc + 4, 64 if dc <= 128 else 32
    bq = 64 if -(-sq // 64) * h * b >= SMS else 32

    def smem(ns: int) -> int:
        return 4 * (bq * ld + 2 * ns * bk * ld + bq * (bk + 4) + 5 * bq)

    def two(ns: int) -> bool:
        return 2 * (smem(ns) + 1024) <= SMEM_SM

    ns = 3 if two(3) else 2 if two(2) else 3 if smem(3) <= SMEM_CTA else 2
    return FwdPlan(b, sq, h, bq, bk, ns, smem(ns), SMEM_SM // (smem(ns) + 1024), heads_inner=True)


def lse_stride(sq: int) -> int:
    """The length of the log-sum-exp's storage rows for Sq query rows."""
    return -(-sq // LSE_ALIGN) * LSE_ALIGN


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The shapes, dtypes and devices both kernels take, or raise."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash kernel needs q, k, v on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _build.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32 or bf16 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernel needs q (B,Sq,H,D), k = v (B,Sk,KV,D), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv or sk == 0
            or (d not in HEAD_DIMS and d not in PADDED_HEAD_DIMS)):
        raise ValueError(
            f"flash kernel: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
            f"(head dim D={d}; D in {HEAD_DIMS} or {tuple(PADDED_HEAD_DIMS)}, H % KV == 0)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")


def flash_attention_bwd(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    o: torch.Tensor,  # (B, Sq, H, D): flash_attention's output
    do: torch.Tensor,  # (B, Sq, H, D): its gradient
    lse: torch.Tensor | None = None,  # (B, H, Sq): flash_attention's, return_lse=True
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, q_offset=q_offset)``.  No
    TPU counterpart.  Under causal, keys from ``q_offset + Sq`` on are seen
    by no query: their dk and dv are zeros.

    Bound on the H100: operations, 2.5x the forward's.  Deterministic (no
    atomics; see the source's header): delta = rowsum(do * o) into an f32
    scratch (``torch.empty``), then for bf16 a dK/dV pass per (128-key
    block, KV head) over its query heads and a dQ pass per (128-row q-block,
    head), both on ``wgmma`` with TMA rings, P rebuilt from ``lse``; for f32
    the same two passes as the CTAs of one launch, register-tiled f32 FMAs
    on cp.async rings."""
    global bwd_launches, bwd_offset_launches
    if q_offset < 0:
        raise ValueError(f"flash backward needs q_offset >= 0, got {q_offset}")
    _check(q, k, v)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash backward needs {name} like q {tuple(q.shape)} {q.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if sq == 0:
        raise ValueError("flash backward needs Sq > 0")
    ls = lse_stride(sq)
    if lse is None:
        raise ValueError("flash backward needs the forward's lse (flash_attention(..., return_lse=True))")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device
            or lse.stride() != (h * ls, ls, 1)):
        raise ValueError(f"flash backward needs lse as flash_attention returns it: ({b}, {h}, {sq}) "
                         f"f32, rows of {ls}; got {tuple(lse.shape)} {lse.dtype} strides {lse.stride()}")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if d in PADDED_HEAD_DIMS:  # o is then the forward's sliced output
        pad = PADDED_HEAD_DIMS[d] - d
        q, k, v, o, do = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v, o, do))
    if not (o.is_contiguous() and do.is_contiguous()):
        raise ValueError("flash backward needs contiguous o and do")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash backward needs 16-byte aligned q, k, v, do (TMA for bf16, cp.async for f32)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, ls, dtype=torch.float32, device=q.device)
    fn = _build.function(
        "flash_attention_bwd",
        "flash_attention_bwd_launch",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), ls,
        b, sq, sk, h, kv, q.shape[3], scale, int(causal), int(q_offset), _build.DTYPES[q.dtype],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention_bwd", err)
    bwd_launches += 1
    if q_offset:
        bwd_offset_launches += 1
    return dq[..., :d], dk[..., :d], dv[..., :d]
