#!/usr/bin/env python3
"""Hold this checkout's decode_attention kernel against another checkout's on one card.

    python3 tools/ab_decode.py OTHER_ROOT [--rounds 2] [--json FILE]

As ``tools/ab_flash_forward.py`` (the same turns and report), on the decode
cases of chip_smoke.py's phase 2 (bf16 and f32 caches and the int8 cache
under a bf16 and an f32 q, at the serving, family, served-S and 8 and 16 x
32k shapes) and on phase 14(a)'s int8 cache blocks with the log-sum-exp
(block 1 of 4 and of 16 of granite's 8 x 32k), as the model calls the
kernel.  A case's key ends in its q dtype, ``bf16-int8`` for the int8 cache
under a bf16 q: every other case's output must be bit-equal across the two
checkouts (``--bit-equal both``, the default), that one's max |this -
other| is reported instead.  Timed cases: phase 2's and the blocks, cold.
Needs a CUDA device; builds each side's decode library in that side's
``build/``.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import ab_flash_forward as ab

HERE = Path(__file__).resolve().parents[1]


def worker(root: Path, save: Path | None = None) -> dict:
    """Run the decode cases with ``root``'s kernel: {case: [sha256 of the
    output's bytes (and the lse's), ms or None]}; with ``save``, also each
    output as ``save/<case index>.pt``."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # inputs and timing from this checkout, the same for both sides

    sys.path.insert(0, str(root / "src"))  # ahead of the checkout that chip_smoke put first
    import torch

    from repro_torch.kernels import decode_attention as dk

    if not dk.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {dk.__file__}, not {root}'s kernels")

    def run(inputs, **kw):
        q, k, v, lens, *sc = inputs
        scales = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
        return dk.decode_attention(q, k, v, lens, **scales, **kw)

    def record(key, got, ms):
        parts = got if isinstance(got, tuple) else (got,)
        h = hashlib.sha256()
        for t in parts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        if save is not None:
            torch.save(parts[0].cpu(), save / f"{len(out)}.pt")
        out[key] = [h.hexdigest(), ms]

    out = {}
    for dt in ("bf16", "f32"):
        for name, case, make, kw in cs.kernel_cases(torch, dt):
            if not name.startswith("decode_attention"):
                continue
            inputs = make()
            got = run(inputs, **kw)
            torch.cuda.synchronize()
            ms = None
            if case.split()[0] in cs.TIMED:
                sets = cs.cold_sets(inputs)
                ms = cs.time_ms(torch, {"k": lambda *a: run(a, **kw)}, sets)["k"]
                del sets
            quant = name == "decode_attention_int8"
            record(f"{case} {dt + '-int8' if quant and dt == 'bf16' else dt}", got, ms)
            del inputs, got
    inputs = cs._shard_decode_inputs(torch, cs.SHARD_DECODE, True, cs.SEED + 14)
    for n in cs.SHARD_CUTS:
        starts = cs.block_starts(inputs[1].shape[2], n)
        a, e = starts[0], starts[1]  # block 1: the most valid rows of granite's lengths
        q, k, v, lens, ks, vs = inputs
        blk = (q, *(t[:, :, a:e].contiguous() for t in (k, v)), (lens - a).clamp(0, e - a).int(),
               *(t[:, :, a:e].contiguous() for t in (ks, vs)))
        got = run(blk, return_lse=True)
        ms = cs.time_ms(torch, {"k": lambda *x: run(x, return_lse=True)}, cs.cold_sets(blk))["k"]
        record(f"int8 lse block 1 of {n} bf16-int8", got, ms)
        del blk, got
    return out


if __name__ == "__main__":
    sys.exit(ab.main(worker=worker, script=__file__))
