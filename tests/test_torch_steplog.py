"""The serving engine's step log (``repro_torch.obs.steplog``): one record a
decode step, its stamps inside the step, ``device_ms`` only from a replayed
graph's CUDA events, a bounded ring that outlives the engine; and the
arithmetic of ``tools/graph_gaps.py``, which reads the log, on hand-built
records.  The ``cuda`` test maps a captured engine's stamps onto the
profiler's timeline."""

import ast
import gc
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's package, beside src/
    sys.path.insert(0, str(ROOT))

from blitzbench.trace import Slice  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.obs.steplog import STEP_LOG, StepLog, StepRecord  # noqa: E402
from repro_torch.serving.engine import InstanceEngine, ServeRequest  # noqa: E402

CFG = get_config("granite-8b", reduced=True).replace(dtype=torch.float32)


@pytest.fixture(autouse=True)
def empty_log():
    STEP_LOG.clear()
    yield
    STEP_LOG.clear()


@pytest.fixture(scope="module")
def params():
    return TF.init_params(CFG, 0, device="cpu")


def _load_tool(name):
    """``tools/<name>.py`` as a module (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location(f"tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _engine(params, n_slots, new_tokens):
    eng = InstanceEngine(CFG, params, n_slots=n_slots, max_seq=48)
    for i, n in enumerate(new_tokens):
        eng.submit(ServeRequest(i, np.arange(3, 9 + i % 2, dtype=np.int32), n))
    return eng


CASES = [(2, [3]), (2, [4, 2, 3]), (3, [2, 5, 3, 4, 2])]  # (slots, each request's tokens)


@pytest.mark.parametrize("n_slots,new_tokens", CASES)
def test_each_decoding_step_writes_one_record(params, n_slots, new_tokens):
    eng = _engine(params, n_slots, new_tokens)
    assert len(eng.run_until_done()) == len(new_tokens)
    assert len(STEP_LOG) == eng.steps > 0 and STEP_LOG.evicted == 0


@pytest.mark.parametrize("n_slots,new_tokens", CASES)
def test_live_matches_the_engines_slots(params, n_slots, new_tokens):
    eng = _engine(params, n_slots, new_tokens)
    while eng.active or eng.queue:
        live = len(eng.active) + min(len(eng.queue), len(eng.free_slots))
        eng.step()
        assert STEP_LOG.records()[-1].live == live
    assert sum(r.live for r in STEP_LOG.records()) == sum(new_tokens) - len(new_tokens)


def test_stamps_are_ordered_inside_the_callers_bracket(params):
    eng = _engine(params, 2, [4, 3, 3])
    brackets = []
    while eng.active or eng.queue:
        t0 = time.perf_counter()
        eng.step()
        brackets.append((t0, time.perf_counter()))
    assert len(brackets) == len(STEP_LOG)
    for (t0, t1), r in zip(brackets, STEP_LOG.records()):
        assert t0 <= r.t_begin <= r.t_launch <= r.t_launched <= r.t_synced <= r.t_end <= t1


def test_device_ms_is_none_on_the_cpu(params):
    eng = _engine(params, 2, [3, 3])
    eng.run_until_done()
    assert eng._graph is None
    assert len(STEP_LOG) and all(r.device_ms is None for r in STEP_LOG.records())
    assert STEP_LOG.totals()["device_s"] is None


def test_a_step_with_nothing_live_writes_nothing(params):
    eng = InstanceEngine(CFG, params, n_slots=2, max_seq=48)
    assert eng.step() == [] and len(STEP_LOG) == 0
    eng.submit(ServeRequest(0, np.arange(3, 9, dtype=np.int32), 2))
    eng.run_until_done()
    n = len(STEP_LOG)
    assert n == eng.steps and not eng.active
    eng.step()
    assert len(STEP_LOG) == n


def _rec(i, device_ms=None):
    t = float(i)
    return StepRecord(t, t + 0.1, t + 0.2, t + 0.5, t + 0.6, 2, device_ms)


def test_the_ring_keeps_its_last_8192_records_and_counts_evictions():
    log = StepLog()
    for i in range(8192 + 100):
        log.add(_rec(i))
    recs = log.records()
    assert len(log) == 8192 and log.evicted == 100
    assert recs[0] == _rec(100) and recs[-1] == _rec(8291)
    log.clear()
    assert len(log) == 0 and log.evicted == 0


def test_records_survive_del_engine(params):
    eng = _engine(params, 2, [3, 2])
    eng.run_until_done()
    steps, recs = eng.steps, STEP_LOG.records()
    del eng
    gc.collect()
    assert len(STEP_LOG) == steps and STEP_LOG.records() == recs


def test_totals_add_up_to_the_records():
    log = StepLog()
    recs = [_rec(0, 3.0), _rec(1), _rec(2, 4.5)]
    for r in recs:
        log.add(r)
    got = log.totals()
    assert got["steps"] == 3 and got["tokens"] == 6
    assert got["device_s"] == pytest.approx(7.5e-3)
    want = {"admit_s": 0.1, "launch_s": 0.1, "wait_s": 0.3, "bookkeep_s": 0.1}
    for k, v in want.items():
        assert got[k] == pytest.approx(3 * v), k
    assert got["step_s"] == pytest.approx(sum(got[k] for k in want))


# ---------------------------------------------------------------------------
# tools/graph_gaps.py's arithmetic
# ---------------------------------------------------------------------------

GAPS = _load_tool("graph_gaps")


def test_graph_gaps_imports_no_jax():
    """The tool runs on the card, where JAX is not installed."""
    roots = {n.split(".")[0] for node in ast.walk(ast.parse((ROOT / "tools" / "graph_gaps.py").read_text()))
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for n in ([a.name for a in node.names] if isinstance(node, ast.Import)
                       else [node.module or ""])}
    assert not roots & {"jax", "jaxlib", "repro", "flax"}, roots
    assert {"repro_torch", "blitzbench", "torch"} <= roots


@pytest.mark.parametrize("recs,want", [
    ([], 0),
    ([(0, 10, "a")], 10),
    ([(0, 10, "a"), (5, 12, "b"), (20, 25, "c")], 17),  # an overlap, then a gap
    ([(20, 25, "c"), (0, 10, "a"), (2, 4, "b")], 15),  # unsorted; one inside another
    ([(0, 10), (10, 20)], 20),  # back to back
])
def test_merged_ns_is_the_union(recs, want):
    assert GAPS.merged_ns(recs) == want


def test_steps_of_reads_the_step_log():
    recs = [StepRecord(t, t + 0.001, t + 0.002, t + 0.024, t + 0.025, 16, d)
            for t, d in ((1.0, 23.0), (1.025, 24.0), (1.055, 25.0))]
    got = GAPS.steps_of(recs)
    assert got["n"] == 3 and got["device_ms"] == pytest.approx(24.0)
    assert got["cycle_ms"] == pytest.approx(27.5) and got["launch_ms"] == pytest.approx(1.0)
    assert got["wait_ms"] == pytest.approx(22.0)
    assert got["idle_pct"] == pytest.approx(100 * (1 - 47 / 55))  # the last step's cycle is open


def test_profiled_steps_keeps_whole_steps_without_the_token_copy():
    k = "void decode_int8_mma_kernel<128>"
    device = [(100, 110, k), (105, 130, "gemm"), (140, 150, k), (160, 170, "Memcpy DtoH"),
              (300, 310, k), (320, 330, "gemm"),  # one int8 record short
              (500, 510, k), (520, 540, k)]
    got = GAPS.profiled_steps(device, [(100, 200), (300, 400), (500, 600)], n_layers=2)
    assert got == [{"records": 3, "merged_ms": 40e-6}, {"records": 2, "merged_ms": 30e-6}]


def test_calibration_splits_own_spans_gaps_and_records():
    """Two replays of three kernels: own spans 2 us, 1 us apart; the records
    start 0.2 us early and end 0.3 us late, so they add 0.5 us a kernel."""
    stamps = [[(1000 + 3000 * i + off, 3000 + 3000 * i + off) for i in range(3)]
              for off in (0, 50_000)]
    records = [[(s - 200, e + 300) for s, e in rep] for rep in stamps]
    got = GAPS.calibration([0.0105, 0.0105], stamps, records)
    assert got["replays"] == 2 and got["kernels"] == 3
    assert got["own_us"]["mean"] == pytest.approx(2.0) and got["own_us"]["p95"] == pytest.approx(2.0)
    assert got["own_gap_us"]["mean"] == pytest.approx(1.0)
    assert got["not_own_us_per_kernel"] == pytest.approx((10.5 - 6) / 3)
    assert got["record_less_own_us"]["mean"] == pytest.approx(0.5)
    assert got["record_gap_us"]["mean"] == pytest.approx(0.5)
    assert got["not_recorded_us_per_kernel"] == pytest.approx((10.5 - 7.5) / 3)
    assert got["stamp_grain_ns"] == 1000  # every reading a whole us
    assert GAPS.grain([[(32, 96), (128, 4000)]]) == 32
    assert "record_less_own_us" not in GAPS.calibration([0.0105], stamps[:1])


@pytest.mark.parametrize("added_p95,want_upper", [(0.25, 0.5 + 0.25e-3 * 2800), (-0.1, 0.5)])
def test_bound_adds_what_the_profiler_may_add_to_each_record(added_p95, want_upper):
    calib = {"record_less_own_us": {"p95": added_p95}}
    got = GAPS.bound({"device_ms": 24.5}, {"merged_ms": 24.0, "records": 2800}, calib)
    assert got["estimate_ms"] == pytest.approx(0.5) and got["upper_ms"] == pytest.approx(want_upper)
    assert got["per_boundary_us"] == pytest.approx(500 / 2800)


# ---------------------------------------------------------------------------
# on the card: the step's stamps against the profiler's timeline
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step replays only on the card")
    return torch.device("cuda")


def _profiled_steps(eng, n=20, settle=0.1):
    """``n`` steps 2 ms of host idle apart (so that no device record could
    belong to two steps) under the benchmark's profiler, after ``settle``
    seconds of steps that are not held: its summary less the device records
    of those, its paired ``perf_counter`` reading, the held steps' records."""
    prof = Slice(0.0, 1e9)
    prof.poll(0.0)
    t_end = time.perf_counter() + settle
    while time.perf_counter() < t_end:
        time.sleep(0.002)
        eng.step()
    STEP_LOG.clear()
    for _ in range(n):
        time.sleep(0.002)
        eng.step()
    prof.stop()
    summary, host0, recs = prof.read(), prof.host[0], STEP_LOG.records()
    first = summary.t0_ns + round((recs[0].t_begin - host0) * 1e9)
    summary.device = [d for d in summary.device if d[0] >= first]
    return summary, host0, recs


@pytest.mark.cuda
def test_replay_events_and_stamps_hold_the_steps_device_records(cuda):
    """A captured engine's profiled steps, in three profiles: each record's
    ``device_ms`` is positive and no longer than ``t_synced - t_launch``,
    and every device record, mapped through the slice's paired readings of
    ``perf_counter`` and the trace's clock, lies inside ``[t_launch,
    t_synced]`` of a step, to within 50 us, and every step holds one.  The
    trace's device timestamps (CUPTI's, converted to the host's clock) ran
    up to 0.7 ms early for the first ~50 ms of 2 profiles in 17 on an H100,
    while the host stamps stayed put, so each profile's first 100 ms of
    steps are not held."""
    cfg = get_config("granite-8b", reduced=True)
    eng = InstanceEngine(cfg, TF.init_params(cfg, 0, device=cuda), n_slots=2, max_seq=512)
    for i in range(2):
        eng.submit(ServeRequest(i, np.arange(3, 12, dtype=np.int32), 480))
    for _ in range(4):  # the admission (the prefills and the capture), then warm steps
        eng.step()
    Slice.warm()
    slack = 50_000
    for profile in range(3):
        summary, host0, recs = _profiled_steps(eng)
        assert len(recs) == 20 and eng.active and len(summary.device) >= 20
        for r in recs:
            assert 0 < r.device_ms <= (r.t_synced - r.t_launch) * 1e3

        def ns(t):  # whole ns: a float near 1.8e18 ns is 256 ns coarse
            return summary.t0_ns + round((t - host0) * 1e9)

        windows = [(ns(r.t_launch) - slack, ns(r.t_synced) + slack) for r in recs]
        held, outside = [0] * len(recs), []
        for s, e, name in summary.device:
            inside = [k for k, (lo, hi) in enumerate(windows) if lo <= s and e <= hi]
            if inside:
                held[inside[0]] += 1
            else:
                outside.append((name[:60], [(s - lo - slack, e - hi + slack) for lo, hi in windows
                                            if lo - 1_000_000 < e and s < hi + 1_000_000]))
        assert not outside and min(held) > 0, (profile, held, outside[:3])
