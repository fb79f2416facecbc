"""Single-token GQA decode attention on the card (wrapper of
``csrc/decode_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``_decode_kernel`` / ``decode_attention``).  Bound on the H100: bytes (each
valid cache row is read once per step).  The kernel splits the sequence into
128-position chunks across CTAs so that a small serving batch still fills the
card (flash-decoding), skips chunks past each sequence's length, reads each K
row once for the n_rep query heads that share it, and merges the chunks'
partial (max, sum, acc) in a second small kernel.  The partials live in f32
scratch that this wrapper allocates.  int8 caches are not taken.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
N_REPS = (1, 2, 4, 8)

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KV, S, D)
    v_cache: torch.Tensor,  # (B, KV, S, D)
    lengths: torch.Tensor,  # (B,) int32
    *,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    global launches
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_cache, v_cache, lengths)):
        raise ValueError("decode kernel needs q, caches and lengths on one CUDA device")
    if k_cache.dtype == torch.int8:
        raise NotImplementedError("int8 KV cache: not yet ported")
    if q.dtype not in _build.DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode kernel takes f32 or bf16 q and caches of one dtype, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode kernel needs int32 lengths, got {lengths.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode kernel needs q (B,H,D), caches (B,KV,S,D), got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, d = q.shape
    _, kv, s, _ = k_cache.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or lengths.shape != (b,) or kv == 0
            or h % kv or h // kv not in N_REPS or d not in HEAD_DIMS or s == 0):
        raise ValueError(f"decode kernel: unsupported shapes q {tuple(q.shape)}, cache {tuple(k_cache.shape)} (D in {HEAD_DIMS}, H/KV in {N_REPS})")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode kernel needs contiguous q, caches and lengths")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode kernel needs 16-byte aligned caches")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    chunk = _build.function("decode_attention", "decode_attention_chunk", [])()
    n_rep, n_split = h // kv, -(-s // chunk)
    out = torch.empty_like(q)
    part_acc = torch.empty((b, kv, n_split, n_rep, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, kv, n_split, n_rep, 2), dtype=torch.float32, device=dev)
    fn = _build.function(
        "decode_attention",
        "decode_attention_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, h, kv, s, d, scale, _build.DTYPES[q.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("decode_attention", err)
    launches += 1
    return out
