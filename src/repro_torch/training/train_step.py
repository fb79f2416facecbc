"""The train step (the port's ``repro.training.train_step``): loss -> grad ->
AdamW, with gradient accumulation over microbatches and remat over layers.

``build_train_step`` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

which, as the optimizer does, updates ``params`` and ``opt_state`` in place
and returns them (the reference's training loop donates them to its jitted step).
Gradients are taken with respect to detached aliases of the parameter
tensors, so the caller's tensors never acquire ``requires_grad``.  With
``n`` microbatches the batch is split along its first axis and the
gradients accumulate in f32, as the reference's ``lax.scan`` does: activation
memory is one microbatch.  Remat happens inside the model (``cfg.remat``).
The reference's ``TrainState``, ``batch_axes`` and abstract batch
(``make_batch_abstract``) serve its sharded steps and dry-run and wait for
the port's (A14).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_update, tree_leaves


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n dicts of (B // n, ...) slices."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split into {n} microbatches")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i] for k, x in batch.items()}
            for i in range(n)]


def _aliases(tree: Any) -> Any:
    """The tree with each tensor replaced by a detached alias of its storage
    that requires grad."""
    if isinstance(tree, dict):
        return {k: _aliases(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int | None = None,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    batch: {"tokens": (B, S) int, "labels": (B, S) int, ["frames": (B, Sf, d)]};
    metrics: ``loss``, ``grad_norm`` and ``lr``, 0-d f32 tensors."""
    n_micro = microbatches if microbatches is not None else max(cfg.microbatches, 1)

    def value_and_grad(params: Any, mb: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The loss and its gradient per leaf (in tree_leaves order); a leaf
        the loss does not reach gets zeros, as jax.grad gives it."""
        alias = _aliases(params)
        leaves = tree_leaves(alias)
        with torch.enable_grad():
            loss = TF.lm_loss(cfg, alias, mb["tokens"], mb["labels"], mb.get("frames"))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def unflatten(like: Any, flat: list) -> Any:
        it = iter(flat)

        def build(t):
            if isinstance(t, dict):
                return {k: build(t[k]) for k in sorted(t)}
            return next(it)

        return build(like)

    def train_step(params: Any, opt_state: dict, batch: dict):
        if n_micro == 1:
            loss, flat = value_and_grad(params, batch)
        else:
            loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            flat = None
            for mb in _split_microbatches(batch, n_micro):
                l, g = value_and_grad(params, mb)
                if flat is None:
                    flat = [x.float() for x in g]
                else:
                    for a, x in zip(flat, g):
                        a.add_(x.float())
                loss_sum = loss_sum + l
                del g
            loss = loss_sum / n_micro
            for a in flat:
                a.div_(n_micro)
        grads = unflatten(params, flat)
        del flat
        new_params, new_opt, om = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step

