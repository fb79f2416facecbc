"""End-to-end example on the port: train a ~100M-parameter granite-family
model for a few hundred steps on the synthetic pipeline, with checkpoints.

    python examples_torch/train_100m.py [--steps 300]               # cuda
    python examples_torch/train_100m.py --device cpu --steps 2 --batch 2 --seq 32

Uses the same code path as the port's launcher (repro_torch.launch.train):
AdamW + cosine schedule, grad accumulation, remat over layers, atomic
checkpoints in the reference's format.  On the card the norms and the
attentions run forward and backward on the hand-written kernels.  The
random weights come from a seeded ``torch.Generator``, not ``jax.random``,
so the losses differ from ``examples/train_100m.py``'s; the parameter count
is the same.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import AdamWConfig, adamw_init, tree_leaves
from repro_torch.training.train_step import build_train_step


def main(argv: list[str] | None = None) -> dict:
    """Train up to ``--steps``; returns the last step's ``params`` and
    ``opt`` state with its ``step`` count, for a caller to checkpoint."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "blitz_train_100m_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; it raises without CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params: a scaled-down granite (8 layers, d=768, ff=2048)
    cfg = get_config("granite-8b").replace(
        name="granite-100m", n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab_size=32_000, microbatches=1, remat=True,
        sharding_overrides=None,
    )
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = TF.init_params(cfg, gen, device=dev)
    opt = adamw_init(params, opt_cfg)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params, batch {args.batch} x seq {args.seq}")

    start = 0
    if latest_step(args.ckpt) is not None:
        state, start = restore_checkpoint(args.ckpt, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")

    step_fn = build_train_step(cfg, opt_cfg)
    t0, first_loss = time.perf_counter(), None
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in make_batch(cfg, args.batch, args.seq, step=step).items()}
        params, opt, m = step_fn(params, opt, batch)
        if step % 20 == 0 or step == args.steps - 1:
            loss = float(m["loss"])
            first_loss = first_loss if first_loss is not None else loss
            tok_s = (step - start + 1) * args.batch * args.seq / (time.perf_counter() - t0)
            print(f"step {step:4d}  loss {loss:.4f}  lr {float(m['lr']):.2e}  tok/s {tok_s:,.0f}")
        if (step + 1) % 100 == 0:
            path = save_checkpoint(args.ckpt, step + 1, {"params": params, "opt": opt})
            print(f"  checkpoint -> {path}")

    print(f"\nloss {first_loss:.3f} -> {float(m['loss']):.3f} over {args.steps - start} steps")
    return {"params": params, "opt": opt, "step": args.steps}


if __name__ == "__main__":
    main()
