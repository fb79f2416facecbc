"""Fused RMSNorm on the card (wrapper of ``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py`` (``_rmsnorm_kernel``
/ ``fused_rmsnorm``).  Bound on the H100: bytes (one read and one write of
each element, a few flops each).  The kernel gives each row one 128-thread
block with 16-byte vector loads and an f32 shuffle reduction, and takes
ragged row counts without the TPU version's padding copy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d), w: (d,), both CUDA, same dtype (f32 or bf16), contiguous."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, got {x.device}, {w.device}")
    if x.dtype not in _build.DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"rmsnorm kernel needs contiguous x (..., {d}) and w ({d},), got {tuple(w.shape)}")
    if d == 0:
        raise ValueError("rmsnorm kernel needs d > 0")
    out = torch.empty_like(x)
    fn = _build.function(
        "rmsnorm",
        "rmsnorm_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // d, d, eps,
        _build.DTYPES[x.dtype], x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("rmsnorm", err)
    launches += 1
    return out
