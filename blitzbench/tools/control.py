"""The readings a cell's limit is set from, several seeds in one process.

  python3 blitzbench/tools/control.py --workload granite-8b.long32k --seeds 11,12,13 --seconds 10

For each seed, a run of the cell as ``run.py`` makes it (a shorter window
at the cell's own load, long enough for every session to serve the
``head_tokens`` the check compares), and on the same served tokens both the
program's numbers (``check._numbers``: a sound run's readings) and each of
the cell's ``controls``: the reference one precision below the
configuration's in the program's place (e4m3 products for the bf16 model,
an int4 cache for the int8 one), the gap of the token it puts first at each
position.  One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()

    from blitzbench import harness
    from blitzbench.drivers import common as C

    cell = harness.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = harness.driver(cell).run(cell, seed=seed, seconds=args.seconds, trace=False,
                                       device="cuda", t_start=t0,
                                       controls=cell.settings["controls"])
        print(json.dumps({"seed": seed, "program": out.reading, "control": out.control,
                          "checks": {k: v for k, (v, _) in out.checks.items()},
                          "metrics": out.metrics, "wall_s": time.perf_counter() - t0}),
              flush=True)
        del out
        C.free("cuda")


if __name__ == "__main__":
    main()
