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

Sharded: with DTensor parameters, moments and batch (call the step under
:func:`repro_torch.distributed.sharding.use_sharding_rules`), the same step
runs over the mesh.  Plain tensors that the step and the model make count
as replicated (``implicit_replication``); each gradient is redistributed to
its parameter's placements (the data-parallel all-reduce, or a
reduce-scatter under the FSDP overlay); microbatch ``i`` is the same global
rows as in the unsharded step (the token batch is gathered and each slice
sharded again); the metrics are plain 0-d tensors of the full values.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_update, full_value, tree_leaves


def make_batch_abstract(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Meta-tensor batch for the dry-run (never allocated)."""
    out = {
        "tokens": torch.empty((batch, seq), dtype=torch.int32, device="meta"),
        "labels": torch.empty((batch, seq), dtype=torch.int32, device="meta"),
    }
    if cfg.family in ("vlm", "encdec"):
        nf = cfg.n_frontend_tokens or 64
        out["frames"] = torch.empty((batch, nf, cfg.d_model), dtype=cfg.dtype, device="meta")
    return out


def batch_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the batch's leaves."""
    out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family in ("vlm", "encdec"):
        out["frames"] = ("batch", "seq", "act_d_model")
    return out


def _split_microbatches(batch: dict, n: int, axes: dict) -> list[dict]:
    """(B, ...) -> n dicts of (B // n, ...) slices; a sharded leaf is
    gathered and each slice sharded again by its logical axes."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split into {n} microbatches")

    def whole(x):
        if not sh.is_dtensor(x):
            return x
        from torch.distributed.tensor import Replicate

        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)

    full = {k: whole(x) for k, x in batch.items()}
    return [{k: sh.shard(x.reshape(n, x.shape[0] // n, *x.shape[1:])[i], *axes[k])
             for k, x in full.items()} for i in range(n)]


def _sharded(tree: Any) -> bool:
    return any(sh.is_dtensor(x) for x in tree_leaves(tree))


def _as_placed(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements."""
    if sh.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
        return loss.detach(), [torch.zeros_like(p) if g is None else _as_placed(g, p)
                               for p, g in zip(leaves, grads)]

    def unflatten(like: Any, flat: list) -> Any:
        it = iter(flat)

        def build(t):
            if isinstance(t, dict):
                return {k: build(t[k]) for k in sorted(t)}
            return next(it)

        return build(like)

    def train_step(params: Any, opt_state: dict, batch: dict):
        if not _sharded(params):
            return step(params, opt_state, batch)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, {k: full_value(v) for k, v in metrics.items()}

    def step(params: Any, opt_state: dict, batch: dict):
        if n_micro == 1:
            loss, flat = value_and_grad(params, batch)
        else:
            loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            flat = None
            for mb in _split_microbatches(batch, n_micro, batch_axes(cfg)):
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

