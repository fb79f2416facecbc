"""The port's dry-run against the reference's, cell by cell: dot FLOPs a
device on the single-pod (16, 16) mesh for every serving cell (each
arch's ``prefill_32k`` and ``decode_32k``, and the SSM and hybrid archs'
``long_500k``), where the port's sharded layers must do the work a device
that the reference's GSPMD program does.

The reference's figures are those of ``python -m repro.launch.dryrun
--arch <arch> --shape <shape> --mesh single`` (the JAX package's dry-run,
its loop-corrected ``dot_flops_per_dev``), written here as constants: the
JAX dry-run compiles each cell for 256 placeholder devices, which these
tests do not repeat.  The port's cells run as the CLI runs them, on fake
tensors over a fake process group of 256 ranks: 6 worker processes, each
taking the next cell not yet taken (the slow ones first).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORKERS = 6

# (arch, shape) -> (the reference's dot FLOPs a device, the most the port may
# do as a multiple of it); the slowest port cells first
CELLS = {
    ("zamba2-2.7b", "prefill_32k"): (3.86004e13, 1.02),
    ("mamba2-370m", "prefill_32k"): (3.105e12, 1.02),  # 3.49x while every rank scanned all heads
    # 12.2x while the down projection gathered, 1.09x while wk, wv and the
    # router ran whole on every "model" rank
    ("grok-1-314b", "decode_32k"): (1.329e11, 1.02),
    # 1.18x while wk and wv ran whole on every "model" rank
    ("nemotron-4-340b", "decode_32k"): (4.523e11, 1.02),
    ("grok-1-314b", "prefill_32k"): (1.28029e15, 1.02),
    ("nemotron-4-340b", "prefill_32k"): (4.33428e15, 1.02),
    ("minicpm3-4b", "decode_32k"): (6.08528e10, 1.02),
    ("minicpm3-4b", "prefill_32k"): (1.59648e14, 1.02),
    ("whisper-large-v3", "prefill_32k"): (3.24289e13, 1.02),
    ("zamba2-2.7b", "decode_32k"): (4.70719e9, 1.02),
    ("zamba2-2.7b", "long_500k"): (3.41955e9, 1.02),
    ("mamba2-370m", "decode_32k"): (3.81075e8, 1.02),
    ("mamba2-370m", "long_500k"): (4.76344e7, 1.02),
    ("granite-8b", "decode_32k"): (2.22466e10, 1.02),
    ("granite-8b", "prefill_32k"): (1.80595e14, 1.02),
    ("qwen1.5-4b", "decode_32k"): (2.60008e10, 1.02),
    ("qwen1.5-4b", "prefill_32k"): (8.09602e13, 1.02),
    ("pixtral-12b", "decode_32k"): (2.86052e10, 1.02),
    ("pixtral-12b", "prefill_32k"): (2.28836e14, 1.02),
    ("olmoe-1b-7b", "decode_32k"): (1.87122e10, 1.02),
    ("olmoe-1b-7b", "prefill_32k"): (5.013e13, 1.02),  # 4.32x while the combine gathered out_buf
    ("whisper-large-v3", "decode_32k"): (1.01699e10, 1.02),
}
# (arch, shape) -> dot FLOPs a device of the reference's that compute
# nothing: ``chunked_attention`` (src/repro/models/layers.py:118-127) pads
# whisper's 1500 frames of keys to 2048, two kv chunks of 1024, and scores
# and weighs the padded keys masked.  Per device, QK^T and PV, 32 layers:
# the encoder's self-attention 2 x 2 x (2 rows x 20 heads x 1500 queries x
# 64) x 548 x 32 = 2.69353e11, the decoder's cross-attention (its 2048
# queries a rank) 2 x 2 x (2 x 20 x 2048 x 64) x 548 x 32 = 3.67757e11.
# The port's attention reads the 1500 keys: it does the reference's work
# less these, 0.9804 of its figure.
MASKED_PADDING = {("whisper-large-v3", "prefill_32k"): 2.69353e11 + 3.67757e11}
# (arch, shape) -> why the port's counted peak is over 80 GB: the dry-run
# runs the plain path, whose attention holds each rank's (B, H, S, S) f32
# scores, which the flash kernel never allocates
OVER_80GB = {
    ("nemotron-4-340b", "prefill_32k"):
        "(2, 6, 32768, 32768) f32 scores a rank: 51.5 GB (117 GB counted; XLA's temp 25.3 GB)",
}

WORKER = textwrap.dedent("""
    import json, os, sys

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import fake_process_group

    out, cells = sys.argv[1], json.loads(sys.argv[2])
    with fake_process_group(256):
        for arch, shape in cells:
            try:  # the first worker to create the claim runs the cell
                os.close(os.open(os.path.join(out, f"claim-{arch}-{shape}"),
                                 os.O_CREAT | os.O_EXCL))
            except FileExistsError:
                continue
            rec = run_cell(arch, shape, False, out, force=True)
            print(arch, shape, rec.get("ok"), round(rec["run_s"], 1), flush=True)
""")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_parity")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    cells = json.dumps(list(CELLS))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(tmp), cells], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(WORKERS)]
    for p in procs:
        log = p.communicate(timeout=600)[0].decode()
        assert p.returncode == 0, log[-3000:]
    return {(arch, shape): json.loads((tmp / f"{arch}__{shape}__single.json").read_text())
            for arch, shape in CELLS}


@pytest.mark.parametrize("cell", list(CELLS), ids=lambda c: f"{c[0]}-{c[1]}")
def test_dot_flops_a_device_match_the_reference(records, cell):
    """The cell is ok, fits in 80 GB (but where ``OVER_80GB`` says why the
    plain path's count is over), and its dot FLOPs a device are at most the
    bound's multiple of the reference's, less the reference's masked
    padding, and at least 0.98 of that: no work is lost."""
    rec = records[cell]
    ref, most = CELLS[cell]
    ref -= MASKED_PADDING.get(cell, 0.0)
    assert rec["ok"], rec.get("error")
    assert rec["fits_80gb"] or cell in OVER_80GB, (rec["argument_bytes_per_dev"],
                                                   rec["temp_bytes_per_dev"])
    assert 0.98 * ref <= rec["dot_flops_per_dev"] <= most * ref, rec["dot_flops_per_dev"]
