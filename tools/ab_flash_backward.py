#!/usr/bin/env python3
"""Hold this checkout's flash_attention_bwd against another checkout's on one card.

    python3 tools/ab_flash_backward.py OTHER_ROOT [--rounds 2] [--bit-equal bf16|f32|both] [--json FILE]

As ``tools/ab_flash_forward.py`` (the same options, turns and report), on
the flash backward cases of chip_smoke.py's phase 11a (the train
microbatch 4 x 2048 x 32/8 x 128 causal, whisper's 512 x 1500
cross-attention, every head dim at 2 x 200), bf16 and f32, at query
offset 0, as the unsharded train step calls the kernel.  Each case's
inputs carry that checkout's own forward output and log-sum-exp.  It
reports whether (dq, dk, dv) are bit-equal across the two checkouts, and
each run's mean device ms of phase 11a's timed cases (warm, as 11a times
them).  Needs a CUDA device; builds each side's kernels in that side's
``build/``.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import ab_flash_forward as ab

HERE = Path(__file__).resolve().parents[1]


def worker(root: Path, save: Path | None = None) -> dict:
    """Run the backward cases with ``root``'s kernels: {case: [sha256 of the
    gradients' bytes, ms or None]}; with ``save``, also the gradients
    flattened into one tensor as ``save/<case index>.pt``."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # inputs and timing from this checkout, the same for both sides

    sys.path.insert(0, str(root / "src"))  # ahead of the checkout that chip_smoke put first
    import torch

    from repro_torch.kernels import flash_attention as fk

    if not fk.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {fk.__file__}, not {root}'s kernels")
    out = {}
    for dt in ("bf16", "f32"):
        for name, case, make, kw in cs.bwd_cases(torch, dt):
            if name != "flash_attention_bwd":
                continue
            inputs = make()
            g = torch.cat([t.flatten() for t in fk.flash_attention_bwd(*inputs, **kw)])
            torch.cuda.synchronize()
            digest = hashlib.sha256(g.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            ms = None
            if case.split()[0] in cs.BWD_TIMED:
                ms = cs.time_ms(torch, {"k": lambda *a: fk.flash_attention_bwd(*a, **kw)}, [inputs],
                                iters=10)["k"]
            if save is not None:
                torch.save(g.cpu(), save / f"{len(out)}.pt")
            out[f"{case} {dt}"] = [digest, ms]
            del inputs, g
    return out


if __name__ == "__main__":
    sys.exit(ab.main(worker=worker, script=__file__))
