"""The port's training entry point (the copy of ``repro.launch.train``):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 20

trains the arch's config (``--reduced`` for its REDUCED size) on the
deterministic synthetic pipeline with AdamW, gradient accumulation over
``--microbatches`` and remat over layers (``cfg.remat``).  Without
``--device`` it runs on ``cuda`` and raises where there is none; on the card
the norms and the attentions run forward and backward on the hand-written
kernels.

Fault tolerance: a checkpoint every ``--ckpt-every`` steps (atomic, pruned,
in the reference's format); on start it resumes from the newest
complete checkpoint under ``--ckpt-dir``, and the pipeline (deterministic in
the step) replays from exactly that step, so a killed and restarted run
gives the same loss trajectory as one that was never stopped.

The reference's ``--mesh host|production`` (sharded training over a device
mesh) waits for the port's sharding (ROADMAP A14) and raises
``NotImplementedError``; the random weights come from ``torch.Generator``,
not ``jax.random``, so the numbers differ from the JAX CLI's.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import AdamWConfig, adamw_init, tree_leaves
from repro_torch.training.train_step import build_train_step


def _device_batch(cfg: ModelConfig, batch: int, seq: int, step: int, seed: int,
                  device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            for k, v in make_batch(cfg, batch, seq, step=step, seed=seed).items()}


def run_train(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    steps: int,
    batch: int = 8,
    seq: int = 128,
    microbatches: int | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Train ``cfg`` from seeded weights (or the newest checkpoint under
    ``ckpt_dir``) up to step ``steps``, printing the reference CLI's lines.
    Returns the start step, every step's loss and grad norm, the wall
    seconds of each step (a logged step's include the host read of its
    loss, which waits for the device) and the final parameters and
    optimizer state."""
    dev = resolve_device(device)
    params = TF.init_params(cfg, seed, device=dev)
    opt_state = adamw_init(params, opt_cfg)

    start_step = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start_step = restore_checkpoint(ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"resumed from step {start_step}")

    train_step = build_train_step(cfg, opt_cfg, microbatches=microbatches)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M batch={batch} seq={seq}")

    losses, norms, step_s = [], [], []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        t_step = time.perf_counter()
        params, opt_state, metrics = train_step(
            params, opt_state, _device_batch(cfg, batch, seq, step, seed, dev))
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
        if step % log_every == 0 or step == steps - 1:
            loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.perf_counter() - t0
            tok_s = (step - start_step + 1) * batch * seq / max(dt, 1e-9)
            print(f"step {step:5d} loss {loss:.4f} grad_norm {gn:.3f} tok/s {tok_s:,.0f}")
        step_s.append(time.perf_counter() - t_step)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, {"params": params, "opt": opt_state})
    print("done")
    return {
        "start_step": start_step,
        "losses": [float(x) for x in losses],
        "grad_norms": [float(x) for x in norms],
        "step_s": step_s,
        "params": params,
        "opt_state": opt_state,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "host", "production"], default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; it raises without CUDA)")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training over a device mesh is not ported yet (ROADMAP A14)")
    cfg = get_config(args.arch, reduced=args.reduced)
    opt_cfg = AdamWConfig(
        lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1), total_steps=args.steps
    )
    run_train(cfg, opt_cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              microbatches=args.microbatches, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              log_every=args.log_every, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
