"""Rounding of the plain reference: the int8 cache the configuration states,
and the lower precisions of the controls.

``kv_round`` is what an int8 (or int4) cache holds of a key or value: one
absmax scale per token and KV head over the head dim, ``max(amax, 1e-8) /
qmax`` in float32, the values rounded half to even and clipped to
``[-qmax, qmax]``, read back as value x scale.  ``fp8_round`` is an e4m3
product operand: one absmax scale per row of the contracted dim, so that the
row's largest magnitude maps to e4m3's largest finite value, 448.
"""

from __future__ import annotations

import torch

QMAX = {"int8": 127.0, "int4": 7.0}
E4M3_MAX = 448.0


def kv_round(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x (..., D) in float32 as a cache of ``kind`` holds it, dequantized."""
    qmax = QMAX[kind]
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
    return torch.round(xf / scale).clamp(-qmax, qmax) * scale


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x in float32 rounded to e4m3 with one scale per slice along ``dim``
    (the contracted dim of the product ``x`` enters)."""
    xf = x.float()
    scale = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (xf / scale).to(torch.float8_e4m3fn).float() * scale
