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
and no saved tensors.  A gradient through a kernel is a backward kernel or
an error, never the plain version.  ``decode_attention`` serves decode only
and has no gradient.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

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
    def forward(ctx, q, k, v, causal, softmax_scale):
        o = _flash.flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.softmax_scale = causal, softmax_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _flash.flash_attention_bwd(
            q, k, v, o, do.contiguous(), causal=ctx.causal, softmax_scale=ctx.softmax_scale)
        return dq, dk, dv, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5, impl: str | None = None):
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
    impl: str | None = None,
):
    if _use_kernel(impl, q):
        if _needs_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, softmax_scale)
        return _flash.flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, softmax_scale=softmax_scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softmax_scale: float | None = None,
    impl: str | None = None,
):
    if _use_kernel(impl, q):
        return _decode.decode_attention(q, k_cache, v_cache, lengths, softmax_scale=softmax_scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, softmax_scale=softmax_scale)


# kernel name -> (wrapper module, its launch counter)
KERNELS = {
    "rmsnorm": (_rmsnorm, "launches"),
    "flash_attention": (_flash, "launches"),
    "decode_attention": (_decode, "launches"),
    "rmsnorm_bwd": (_rmsnorm, "bwd_launches"),
    "flash_attention_bwd": (_flash, "bwd_launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
