"""Plain PyTorch versions of the port's three kernels.

The CPU tests run them, ``chip_smoke.py`` holds each kernel against its plain
version on the card, and :mod:`repro_torch.kernels.ops` takes them for CPU
tensors.  They are the model's own oracles in
:mod:`repro_torch.models.layers`.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import attention_reference, decode_attention_reference
from repro_torch.models.layers import rmsnorm as rmsnorm_ref  # noqa: F401  (the plain rmsnorm)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    return attention_reference(q, k, v, causal=causal, softmax_scale=softmax_scale)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KV, S, D)
    v_cache: torch.Tensor,  # (B, KV, S, D)
    lengths: torch.Tensor,  # (B,)
    *,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    return decode_attention_reference(q, k_cache, v_cache, lengths, softmax_scale=softmax_scale)

