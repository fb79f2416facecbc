"""Run one cell of the port's benchmark once.

  python3 blitzbench/run.py --workload granite-8b.long32k --seed 7 --seconds 51 --trace 0

From the root of a checkout of the repository (it puts ``src/`` on the path
itself).  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer ones, read from spans around the program's calls and from a
profiled slice of the window.  Every run checks the served tokens against
the plain reference and prints each number compared beside its limit, as
the last lines of standard error and under ``checks`` in the result, which
is the last line of standard output.  It exits non-zero without a result
where CUDA is missing or the cell needs more cards than there are, and
where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from blitzbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    outcome = harness.driver(cell).run(cell, seed=args.seed, seconds=args.seconds,
                                       trace=bool(args.trace), device="cuda", t_start=T_START)
    line = harness.result_line(cell, outcome, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark runs the port alone", file=sys.stderr)
        return 3
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
