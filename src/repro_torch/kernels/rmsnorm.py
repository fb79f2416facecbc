"""Fused RMSNorm on the card: the forward (wrapper of ``csrc/rmsnorm.cu``) and
its gradient (``csrc/rmsnorm_bwd.cu``).

The forward replaces the TPU kernel ``src/repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``fused_rmsnorm``).  Bound on the H100: bytes (one
read and one write of each element, a few flops each).  The kernel gives
each row one 128-thread block with 16-byte vector loads and an f32 shuffle
reduction, and takes ragged row counts without the TPU version's padding
copy.

The backward has no TPU counterpart (the JAX package differentiates its
plain rmsnorm); see ``fused_rmsnorm_bwd``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)
bwd_launches = 0  # the same, of the backward kernel
TILES = 1024  # the backward's row tiles (dw partials) at most


def _check(x: torch.Tensor, w: torch.Tensor) -> int:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, got {x.device}, {w.device}")
    if x.dtype not in _build.DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"rmsnorm kernel needs contiguous x (..., {d}) and w ({d},), got {tuple(w.shape)}")
    if d == 0:
        raise ValueError("rmsnorm kernel needs d > 0")
    return d


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d), w: (d,), both CUDA, same dtype (f32 or bf16), contiguous."""
    global launches
    d = _check(x, w)
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


def fused_rmsnorm_bwd(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``fused_rmsnorm(x, w, eps)`` given ``g``, the gradient of its
    output (same shape and dtype as x, contiguous).  No TPU counterpart.

    Bound on the H100: bytes (x and g read, dx written).  A block per tile of
    rows walks its rows as the forward walks one, writes dx and keeps the
    tile's f32 dw partial in shared memory; a second launch sums the partials
    (an f32 scratch of n_tiles x d from ``torch.empty``) column by column.  No
    float atomics, so two runs give equal bits."""
    global bwd_launches
    d = _check(x, w)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"rmsnorm backward needs a contiguous g like x {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    n = x.numel() // d
    rows_per_tile = max(1, -(-n // TILES))
    n_tiles = -(-n // rows_per_tile)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty((n_tiles, d), dtype=torch.float32, device=x.device)
    fn = _build.function(
        "rmsnorm_bwd",
        "rmsnorm_bwd_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
        n, d, rows_per_tile, eps, _build.DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("rmsnorm_bwd", err)
    bwd_launches += 1
    return dx, dw
