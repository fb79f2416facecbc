"""Weight, cache and optimizer-state bridge: nested dicts of numpy arrays ->
the port's tensors.

The JAX side hands its pytrees over as ``jax.tree.map(np.asarray, tree)``;
keys and the stacked leading layer axis carry over one to one.  bf16 arrays
arrive with numpy dtype name ``bfloat16`` (ml_dtypes) and are moved bit for
bit through a uint16 view, never through float16.  This module imports no
JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(a: np.ndarray, device: str | torch.device,
                      dtype_name: str | None = None) -> torch.Tensor:
    """One numpy array -> a tensor on ``device``, a copy; a 0-d array (AdamW's
    step) stays 0-d.  bf16 moves bit for bit through an int16 view: an
    ml_dtypes array, or 2-byte storage named ``dtype_name="bfloat16"`` (the
    checkpoint's uint16 files)."""
    a = np.array(a, order="C")
    if (dtype_name or a.dtype.name) == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tree(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree: dict, *, device: str | torch.device | None = None) -> dict:
    """JAX parameter pytree (numpy leaves) -> the port's parameter dict."""
    return _tree(tree, resolve_device(device))


def caches_from_numpy(tree: dict, *, device: str | torch.device | None = None) -> dict:
    """JAX cache pytree (numpy leaves) -> the port's cache dict."""
    return _tree(tree, resolve_device(device))


def opt_state_from_numpy(tree: dict, *, device: str | torch.device | None = None) -> dict:
    """JAX AdamW state ``{"m": ..., "v": ..., "step": ()}`` (numpy leaves) ->
    the port's (:mod:`repro_torch.training.optimizer`): moments in their
    dtype, ``step`` a 0-d int32 tensor."""
    return _tree(tree, resolve_device(device))
