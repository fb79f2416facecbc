"""AdamW (the port's copy of ``repro.training.optimizer``), not
``torch.optim.AdamW``: the same schedule, clipping and update arithmetic as
the reference, on the same state (``m``, ``v`` mirroring the parameter tree,
and an int32 ``step``), so a state carries over between the two packages
(:func:`repro_torch.models.bridge.opt_state_from_numpy`, the checkpoint
format).

The update math is in f32 whatever ``moment_dtype`` holds the moments.  Where
the reference returns new arrays (and its training loop donates the old ones), the
port updates the parameter and moment tensors in place, leaf by leaf, so the
step's transient memory is one leaf's f32 temporaries, not a second copy of
the state.  Every number stays on the device: the metrics are 0-d tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: Any = torch.float32  # bf16 for >=100B archs


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict in the reference's pytree order
    (keys sorted at every level), the path its keys joined by ``/``."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The leaves of a nested dict in the reference's pytree order."""
    return [leaf for _, leaf in tree_paths(tree)]


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lr_at(cfg: AdamWConfig, step: torch.Tensor | int) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``; f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Moments mirror the parameter tree, on each leaf's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    device = tree_leaves(params)[0].device
    return {
        "m": _tree_map(zeros, params),
        "v": _tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    opt_state: dict,
    cfg: AdamWConfig,
) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  Returns (params, opt_state, metrics) with
    the metrics ``grad_norm`` and ``lr`` as 0-d f32 tensors."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        gf = g.float() * clip
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf.square()
        delta = (mf / bc1) / ((vf / bc2).sqrt() + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
