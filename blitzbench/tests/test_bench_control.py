"""The control comes out as not correct.

Each control is the plain reference in the program's place, computed one
precision below the configuration's: e4m3 products for the bf16 model, an
int4 cache for its int8 one.  On the card (``cuda``), at each cell's own
size and load with a short window, each control fails one of the cell's
limits and the program passes them all.  On the CPU, at a small width, each
control reads wider than the program at the same positions.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from blitzbench import harness

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_bench_faults as small  # noqa: E402

CELLS = tuple(small.CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_wider_than_the_program_at_small_width(name):
    cell = small._cell(name)
    mod = harness.driver(cell)
    out = mod.run(cell, seed=2**31 + 11, seconds=small.CELLS[name], trace=False, device="cpu",
                  t_start=time.perf_counter(), controls=cell.settings["controls"])
    assert set(out.control) == set(cell.settings["controls"])
    for low in out.control.values():
        assert low["tokens"] == out.reading["tokens"] > 0
        assert low["mean_gap"] > 3 * out.reading["mean_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limit_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell at its own size")
    p = subprocess.run([sys.executable, str(HERE / "tools" / "control.py"), "--workload", name,
                        "--seeds", "1234567891", "--seconds", "10"],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    limits = harness.load_cell(name).settings["limits"]
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row
    for low in row["control"].values():
        assert any(low[k] > lim for k, lim in limits.items()), row
