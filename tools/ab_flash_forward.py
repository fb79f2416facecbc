#!/usr/bin/env python3
"""Hold this checkout's flash_attention forward against another checkout's on one card.

    python3 tools/ab_flash_forward.py OTHER_ROOT [--rounds 2] [--bit-equal bf16|f32|both] [--json FILE]

OTHER_ROOT is the root of another checkout, for example a parent commit
unpacked with ``git archive <commit> | tar -x -C <dir>``.  Each side runs in
a process of its own, in turns (other, this, this, other for two rounds), on
the flash cases of chip_smoke.py's phase 2 (the serving prefill, ragged and
non-causal shapes, every family's shapes, the train microbatch), bf16 and
f32, as serving calls the kernel: without the log-sum-exp.  It reports
whether the outputs are bit-equal across the two checkouts, and each run's
mean device ms of phase 2's timed flash cases (``chip_smoke.time_ms``, cold
where phase 2 times cold).  ``--bit-equal`` names the dtypes whose outputs
must be bit-equal (default both); the cases of the other dtype report the
largest absolute difference between the two checkouts' outputs instead (a
redesigned kernel of that dtype sums in another order).  Exits non-zero if
an output that must be bit-equal differs.  Needs a CUDA device; builds each
side's kernels in that side's ``build/``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def worker(root: Path, save: Path | None = None) -> dict:
    """Run the flash cases with ``root``'s kernels: {case: [sha256 of the
    output's bytes, ms or None]}; with ``save``, also each output as
    ``save/<case index>.pt``."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # inputs and timing from this checkout, the same for both sides

    sys.path.insert(0, str(root / "src"))  # ahead of the checkout that chip_smoke put first
    import torch

    from repro_torch.kernels import flash_attention as fk

    if not fk.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {fk.__file__}, not {root}'s kernels")
    out = {}
    for dt in ("bf16", "f32"):
        for name, case, make, kw in cs.kernel_cases(torch, dt):
            inputs = make()
            if name != "flash_attention":
                continue
            o = fk.flash_attention(*inputs, **kw)
            torch.cuda.synchronize()
            digest = hashlib.sha256(o.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            ms = None
            if case.split()[0] in cs.TIMED:
                nbytes, _ = cs.work(name, inputs, kw, dt)
                sets = cs.cold_sets(inputs) if nbytes > cs.L2_BYTES / 2 else [inputs]
                ms = cs.time_ms(torch, {"k": lambda *a: fk.flash_attention(*a, **kw)}, sets)["k"]
                del sets
            if save is not None:
                torch.save(o.cpu(), save / f"{len(out)}.pt")
            out[f"{case} {dt}"] = [digest, ms]
            del inputs, o
    return out


def main(argv: list[str] | None = None, worker=worker, script: str = __file__) -> int:
    """The A/B of ``worker``'s cases (``tools/ab_flash_backward.py`` passes
    its own worker and script)."""
    ap = argparse.ArgumentParser(description=sys.modules[worker.__module__].__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--bit-equal", choices=("bf16", "f32", "both"), default="both",
                    help="the dtypes whose outputs must be bit-equal across the checkouts")
    ap.add_argument("--json", type=Path, default=None, help="also write every run here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:  # one side: print its results as the last line
        print(json.dumps(worker(args.other.resolve(), args.save)))
        return 0

    sides = {"other": args.other.resolve(), "this": HERE}
    order = [s for r in range(args.rounds) for s in (("other", "this") if r % 2 == 0 else ("this", "other"))]
    exact = ("bf16", "f32") if args.bit_equal == "both" else (args.bit_equal,)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        saved = {}  # side -> the directory of its first run's outputs
        for side in order:
            cmd = [sys.executable, script, "--worker", str(sides[side])]
            if side not in saved and len(exact) < 2:
                saved[side] = Path(tmp) / side
                saved[side].mkdir()
                cmd += ["--save", str(saved[side])]
            p = subprocess.run(cmd, capture_output=True, text=True)
            if p.returncode:
                raise RuntimeError(f"{side} worker exited {p.returncode}:\n{p.stderr[-4000:]}")
            runs.append((side, json.loads(p.stdout.strip().splitlines()[-1])))
        cases = list(runs[0][1])
        differ = [c for c in cases if len({r[c][0] for _, r in runs}) != 1]
        must = [c for c in differ if c.rsplit(" ", 1)[1] in exact]
        diff = {}  # the other dtype's cases: max |this - other| of the first runs' outputs
        if len(exact) < 2:
            import torch

            for i, c in enumerate(cases):
                if c.rsplit(" ", 1)[1] not in exact:
                    a, b = (torch.load(saved[side] / f"{i}.pt") for side in ("other", "this"))
                    diff[c] = float((a.float() - b.float()).abs().max())
    report = {"order": order, "cases": len(cases), "bit_equal": list(exact),
              "outputs_bit_equal": not must, "differ": must, "max_abs_diff": diff,
              "ms": {c: {side: [r[c][1] for s, r in runs if s == side] for side in sides}
                     for c in cases if runs[0][1][c][1] is not None}}
    for c, t in report["ms"].items():
        print(f"{c}: other {t['other']} this {t['this']}")
    print(json.dumps({k: v for k, v in report.items() if k != "ms"}))
    if args.json is not None:
        args.json.write_text(json.dumps({"report": report, "runs": runs}, indent=1))
    return 1 if must else 0


if __name__ == "__main__":
    sys.exit(main())
