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
* f32: f32 FMAs from shared memory (TF32 would miss the 3e-5 tolerance).

Head dims: 16, 32, 64 (whisper, also non-causal with Sq != Sk for its
cross-attention), 80 (zamba2's shared block), 96 (MLA's qk dim), 128 and 192
(nemotron) run natively.  D = 24 (the
REDUCED MLA config) is zero-padded to 32 here and the output sliced back:
zero columns add nothing to QK^T and give zero output columns.  Any other D
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192)
PADDED_HEAD_DIMS = {24: 32}  # D -> the instantiated width it is zero-padded to

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    global launches
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
            f"(D in {HEAD_DIMS} or {tuple(PADDED_HEAD_DIMS)}, H % KV == 0)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if d in PADDED_HEAD_DIMS:
        pad = PADDED_HEAD_DIMS[d] - d
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel needs 16-byte aligned bf16 q, k, v (TMA)")
    out = torch.empty_like(q)
    fn = _build.function(
        "flash_attention",
        "flash_attention_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kv, q.shape[3], scale, int(causal), _build.DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", err)
    launches += 1
    return out[..., :d]  # a padded D's zero columns dropped; else the whole of out
