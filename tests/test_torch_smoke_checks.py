"""The launch-record check of ``chip_smoke.py`` (pure Python, no card): a
profiled window's kernel count may fall short only by device records the
profiler lost in that same window."""

import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _ev(cat, name, corr):
    return {"ph": "X", "cat": cat, "name": name, "args": {"correlation": corr}}


def _graph_window(per_replay, drop=None):
    """3 replays of one graph whose records are ``per_replay``; ``drop`` =
    (replay, index) loses one record."""
    events = [{"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1}]
    for r in range(3):
        events.append(_ev("cuda_runtime", "cudaGraphLaunch_v10000", 100 + r))
        events += [_ev("kernel", n, 100 + r) for i, n in enumerate(per_replay) if (r, i) != drop]
    return {"traceEvents": events}


def _eager_window(drop_record=False, no_launch=False):
    """4 kernel launches, two of them attention; a copy beside them."""
    events = [_ev("cuda_runtime", "cudaMemcpyAsync", 99), _ev("gpu_memcpy", "Memcpy DtoH", 99)]
    for i, name in enumerate(["gemm", "attn_kernel<128>", "add", "attn_kernel<128>"]):
        if no_launch and i == 3:
            continue
        api = "cudaLaunchKernelExC_v11060" if "attn" in name else "cudaLaunchKernel"
        events.append(_ev("cuda_runtime", api, i))
        if not (drop_record and i == 3):
            events.append(_ev("kernel", name, i))
    return {"traceEvents": events}


STEP = ["gemm", "attn_kernel<128>", "add", "attn_kernel<128>", "copy"]


@pytest.mark.parametrize("trace,units,want_lost", [
    (_graph_window(STEP), 3, 0),
    (_graph_window(STEP, drop=(1, 1)), 3, 1),  # the replay short one record: an attention one
    (_graph_window(STEP, drop=(2, 0)), 3, 1),  # a lost record that is not attention
    (_eager_window(), 1, 0),
    (_eager_window(drop_record=True), 1, 1),  # a launch call with no record
], ids=["graph", "graph-lost-attention", "graph-lost-other", "eager", "eager-lost"])
def test_check_launched_passes_a_full_or_lossy_window(trace, units, want_lost):
    got = cs.check_launched(cs._launch_record(trace), "attn_kernel", 2, units, "window")
    assert got["records_lost"] == want_lost
    assert got["launched"] == 2 * units


@pytest.mark.parametrize("trace,units", [
    (_graph_window(["gemm", "attn_kernel<128>", "add", "copy"]), 3),  # every replay one short
    (_graph_window(STEP + ["attn_kernel<128>"]), 3),  # one too many
    (_graph_window(STEP), 2),  # more replays than steps
    (_eager_window(no_launch=True), 1),  # never launched: no call, no record
], ids=["graph-short", "graph-excess", "graph-replays", "eager-short"])
def test_check_launched_fails_a_real_shortfall(trace, units):
    with pytest.raises(cs.SmokeFailure):
        cs.check_launched(cs._launch_record(trace), "attn_kernel", 2, units, "window")
