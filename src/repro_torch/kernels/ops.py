"""Dispatch between the port's CUDA kernels and their plain versions.

``impl``: ``"auto"`` takes the kernel for a CUDA tensor and the plain version
(``ref.py``) for a CPU tensor; ``"kernel"`` takes the kernel and raises on a
CPU tensor; ``"ref"`` takes the plain version on any device.  There is no
fallback: on a CUDA tensor ``auto`` launches the kernel or raises.

An op called without ``impl`` uses the default that :func:`use_impl` sets for
a block of code (``"auto"`` otherwise), so a whole model run can be switched
to the plain path, as ``chip_smoke.py`` does to compare the two on the card.
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


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5, impl: str | None = None):
    if _use_kernel(impl, x):
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


KERNELS = {"rmsnorm": _rmsnorm, "flash_attention": _flash, "decode_attention": _decode}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
