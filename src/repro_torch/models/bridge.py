"""Weight and cache bridge: nested dicts of numpy arrays -> the port's tensors.

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


def _from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.copy().view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def _tree(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _from_numpy(tree, device)


def params_from_numpy(tree: dict, *, device: str | torch.device | None = None) -> dict:
    """JAX parameter pytree (numpy leaves) -> the port's parameter dict."""
    return _tree(tree, resolve_device(device))


def caches_from_numpy(tree: dict, *, device: str | torch.device | None = None) -> dict:
    """JAX cache pytree (numpy leaves) -> the port's cache dict."""
    return _tree(tree, resolve_device(device))
