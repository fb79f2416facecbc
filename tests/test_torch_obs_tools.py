"""The port's observability tools (repro_torch.obs.{export, critical_path,
flightrec, report}) against the JAX package's and its golden files.

Both sides are the same host arithmetic, so every comparison is ``==``: the
Chrome trace and the critical-path report of the seeded traced simulator run
against tests/golden, each request's TTFT attribution, both CLI gates, the
incident bundle's bytes, and the scale-op partition
of the disaggregated runtime on torch engines against the JAX runtime's.  The
golden files are read, never written.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.simulator as j_sim  # noqa: E402
import repro.obs as j_obs  # noqa: E402
from repro.obs import report as j_report  # noqa: E402
from repro.workloads import traces as j_traces  # noqa: E402
import repro_torch.core.simulator as sim  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.workloads import traces  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "tests" / "golden"


@pytest.fixture(scope="module")
def traced():
    """tests/test_obs.py's and tests/test_critical_path.py's ``traced_run``."""
    return report.run_traced_sim(duration=10.0, rate=4.0, seed=0)


@pytest.fixture(scope="module")
def j_traced():
    return j_report.run_traced_sim(duration=10.0, rate=4.0, seed=0)


def _asdicts(items):
    return [dataclasses.asdict(x) for x in items]


PORT_ONLY = {"STEP_LOG", "StepLog", "StepRecord"}  # the serving engine's step log


def test_packages_export_what_the_reference_exports():
    import repro.core as j_core
    import repro_torch.core as core

    assert set(core.__all__) == set(j_core.__all__)
    assert set(obs.__all__) == set(j_obs.__all__) | PORT_ONLY
    assert obs.SCALE_SEGMENTS == j_obs.SCALE_SEGMENTS


# ---------------------------------------------------------------------------
# export + critical path: the goldens and the reference's reports
# ---------------------------------------------------------------------------


def test_chrome_trace_matches_golden(traced):
    tracer, _ = traced
    got = obs.chrome_trace(list(tracer.spans))
    assert got == (GOLDEN_DIR / "chrome_trace.json").read_text().rstrip("\n")


def test_text_trace_equals_jax(traced, j_traced):
    assert obs.text_trace(list(traced[0].spans)) == j_obs.text_trace(list(j_traced[0].spans))


def test_critical_path_report_matches_golden(traced):
    tracer, _ = traced
    got = obs.format_scale_report(obs.analyze_scale_ops(list(tracer.spans)))
    assert got == (GOLDEN_DIR / "critical_path.txt").read_text().rstrip("\n")


def test_scale_op_partition_equals_jax(traced, j_traced):
    got = obs.analyze_scale_ops(list(traced[0].spans))
    want = j_obs.analyze_scale_ops(list(j_traced[0].spans))
    assert got and _asdicts(got) == _asdicts(want)
    for r in got:
        assert r.conserved() and list(r.segments_exact) == list(obs.SCALE_SEGMENTS)
    assert obs.summarize_scale_ops(got) == j_obs.summarize_scale_ops(want)


def test_scale_ops_roundtrip_through_chrome(traced):
    tracer, _ = traced
    spans = list(tracer.spans)
    loaded = obs.load_chrome(obs.chrome_trace(spans))
    direct, again = obs.analyze_scale_ops(spans), obs.analyze_scale_ops(loaded)
    assert [r.sid for r in again] == [r.sid for r in direct]
    assert obs.format_scale_report(again) == obs.format_scale_report(direct)


def test_attribution_equals_jax_request_by_request(traced, j_traced):
    got = report.attribute_requests(list(traced[0].spans))
    want = j_report.attribute_requests(list(j_traced[0].spans))
    finished = [r for r in traced[1].requests if r.ttft is not None]
    assert len(got) == len(finished) > 0
    assert _asdicts(got) == _asdicts(want)
    assert report.summarize(got) == j_report.summarize(want)
    assert report.format_report(report.summarize(got)) == j_report.format_report(j_report.summarize(want))


# ---------------------------------------------------------------------------
# the report CLI's gates, through main(argv)
# ---------------------------------------------------------------------------

GATES = {
    "ttft": ["--sim", "--duration", "8", "--rate", "3", "--min-attribution", "0.95"],
    "scale-ops": ["--sim", "--duration", "8", "--rate", "3", "--scale-ops",
                  "--min-makespan-attribution", "0.95"],
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_report_gate_passes_and_equals_jax(gate, capsys):
    got = report.main(GATES[gate])
    got_out = capsys.readouterr().out
    want = j_report.main(GATES[gate])
    want_out = capsys.readouterr().out
    assert got == want
    assert got_out == want_out
    assert "gate OK" in got_out
    assert got.get("n_requests", got.get("n_ops")) > 0


def test_report_cli_writes_and_reads_a_chrome_trace(tmp_path, capsys):
    chrome = tmp_path / "sim.json"
    summary = report.main(["--sim", "--duration", "6", "--rate", "3", "--chrome-out", str(chrome)])
    from_file = report.main([str(chrome)])
    j_from_file = j_report.main([str(chrome)])
    capsys.readouterr()
    assert from_file == j_from_file
    assert from_file["n_requests"] == summary["n_requests"] > 0


def test_report_cli_runs_without_jax_or_cuda():
    """``python -m repro_torch.obs.report`` as a user runs it: exit 0, nothing
    of JAX or the JAX package in the process, CUDA never initialised."""
    code = ("import runpy, sys, torch\n"
            "sys.argv = ['report', '--sim', '--duration', '4', '--rate', '2',"
            " '--min-attribution', '0.95']\n"
            "runpy.run_module('repro_torch.obs.report', run_name='__main__')\n"
            "import repro_torch.obs, repro_torch.core\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "attribution gate OK" in out.stdout


def test_host_modules_import_no_torch():
    """The tools and the engine's step log are host arithmetic: stdlib and
    numpy, no tensor."""
    for rel in ("core/simulator.py", "core/zigzag.py", "obs/export.py", "obs/critical_path.py",
                "obs/flightrec.py", "obs/report.py", "obs/steplog.py"):
        text = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert not re.search(r"(?<!\w)torch\b", text), rel


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def _failure_run(sim_mod, obs_mod, traces_mod, out_dir):
    """tests/test_flightrec.py:29-36."""
    tracer = obs_mod.Tracer()
    rec = obs_mod.FlightRecorder(tracer, out_dir=str(out_dir), ring=1024)
    s = sim_mod.Simulator(sim_mod.BLITZ, sim_mod.profile_for("8b"), seed=0,
                          tracer=tracer, flight_recorder=rec)
    s.schedule(6.0, lambda sm: sm.flowsim.fail_device(3, sm.now))
    s.run(traces_mod.burstgpt(duration=12.0, base_rate=4.0, seed=11))
    return rec


def test_device_failure_bundle_is_byte_identical_to_jax(tmp_path):
    rec = _failure_run(sim, obs, traces, tmp_path / "port")
    j_rec = _failure_run(j_sim, j_obs, j_traces, tmp_path / "jax")
    assert len(rec.dumps) == len(j_rec.dumps) == 1
    got = pathlib.Path(rec.dumps[0]).read_bytes()
    assert got == pathlib.Path(j_rec.dumps[0]).read_bytes()
    assert pathlib.Path(rec.dumps[0]).name == pathlib.Path(j_rec.dumps[0]).name
    doc = json.loads(got)
    inc = doc["incident"]
    assert inc["trigger"] == "net:device_failed" and inc["context"]["device"] == 3
    assert inc["critical_path"]["n_ops"] >= 1
    assert doc["displayTimeUnit"] == "ms" and doc["traceEvents"]


def _paging_monitor(slo_mod):
    """tests/test_flightrec.py:_paging_monitor."""
    mon = slo_mod.SLOMonitor(ttft_slo_s=0.1, windows_s=(5.0,))
    for i in range(40):
        mon.observe_ttft("m", 1.0 + i * 0.1, 5.0)
    return mon


def test_slo_page_bundle_is_byte_identical_to_jax(tmp_path):
    bundles = []
    for name, obs_mod in (("port", obs), ("jax", j_obs)):
        rec = obs_mod.FlightRecorder(obs_mod.Tracer(), slo_monitor=_paging_monitor(obs_mod),
                                     out_dir=str(tmp_path / name))
        rec.poll(5.0)
        rec.poll(5.5)  # edge-triggered: still paging, no second dump
        assert len(rec.dumps) == 1
        bundles.append(pathlib.Path(rec.dumps[0]).read_bytes())
    assert bundles[0] == bundles[1]
    assert json.loads(bundles[0])["incident"]["trigger"] == "slo:page"


def test_fleet_scheduler_polls_the_recorder(tmp_path):
    """tests/test_flightrec.py:141 on the port's FleetScheduler."""
    from repro_torch.core import topology as tp
    from repro_torch.serving.maas import FleetScheduler

    mon = _paging_monitor(obs)
    rec = obs.FlightRecorder(obs.Tracer(), slo_monitor=mon, out_dir=str(tmp_path))
    fleet = FleetScheduler(tp.add_host_sources(tp.make_cluster(2, 4, bw_gbps=100.0)),
                           slo_monitor=mon, flight_recorder=rec)
    fleet.tick(5.0)
    assert len(rec.dumps) == 1
    assert json.loads(pathlib.Path(rec.dumps[0]).read_text())["incident"]["trigger"] == "slo:page"


# ---------------------------------------------------------------------------
# the disaggregated runtime's scale ops: torch engines against JAX engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sides():
    """granite-8b REDUCED in f32 on both sides, the JAX weights carried over
    by the bridge (tests/test_torch_disagg.py)."""
    import repro.core.autoscaler as j_autoscaler
    import repro.core.topology as j_tp
    import repro.serving.disagg as j_disagg
    import repro.serving.disagg.pools as j_pools
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as JTF
    import repro_torch.core.autoscaler as t_autoscaler
    import repro_torch.core.topology as t_tp
    import repro_torch.serving.disagg as t_disagg
    import repro_torch.serving.disagg.pools as t_pools
    from repro_torch.configs import get_config
    from repro_torch.models import bridge

    jcfg = jax_get_config("granite-8b", reduced=True).replace(dtype=jnp.float32)
    cfg = get_config("granite-8b", reduced=True).replace(dtype=torch.float32)
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (types.SimpleNamespace(cfg=jcfg, params=jparams, tp=j_tp, auto=j_autoscaler,
                                  disagg=j_disagg, P=j_pools, obs=j_obs),
            types.SimpleNamespace(cfg=cfg, params=params, tp=t_tp, auto=t_autoscaler,
                                  disagg=t_disagg, P=t_pools, obs=obs))


def _traced_runtime(s, out_dir, **kw):
    """tests/test_torch_disagg.py's runtime, traced, with a flight recorder
    on its FlowSim."""
    tracer = s.obs.Tracer()
    kw.setdefault("topo", s.tp.add_host_sources(s.tp.make_cluster(2, 4, bw_gbps=100.0)))
    rt = s.disagg.ClusterRuntime(
        s.cfg, s.params,
        policy=s.auto.PolicyConfig(max_instances=4, kv_upper=0.5, scale_down_timeout_s=0.4),
        n_prefill=2, n_decode=1, n_slots=2, max_seq=48, prefill_capacity_tps=200.0,
        decode_capacity_tps=50.0, tracer=tracer, **kw)
    rec = s.obs.FlightRecorder(tracer, out_dir=str(out_dir)).attach(rt.net)
    return rt, tracer, rec


def _burst(s, out_dir):
    """tests/test_torch_disagg.py's decode_pressure_mutates_prefill: 8
    requests at t = 0, ticks of 10 ms on a simulated clock."""
    rt, tracer, rec = _traced_runtime(s, out_dir, model_bytes=int(50e6))
    rng = np.random.default_rng(2)
    for _ in range(8):
        rt.submit(rng.integers(0, s.cfg.vocab_size, size=16).astype(np.int32), 6, 0.0)
    t = 0.0
    for _ in range(800):
        if rt.n_outstanding == 0:
            break
        t += 0.01
        rt.tick(t)
    assert rt.n_outstanding == 0
    assert rt.stats.live_scaled_prefill >= 1
    return tracer, rec.render("test:end", t), t


def _failed_nic(s, out_dir):
    """tests/test_torch_disagg.py's failed_nic_replans_elsewhere: the NIC of
    a loading target dies; its scale op closes aborted, the re-plan opens
    another, and the recorder dumps on the failure."""
    rt, tracer, rec = _traced_runtime(
        s, out_dir, topo=s.tp.add_host_sources(s.tp.make_cluster(5, 1, bw_gbps=100.0)),
        model_bytes=int(500e6))
    t = 0.01
    rt.tick(t)
    pe = rt._live_scale(s.P.PREFILL, t)
    rt.net.fail_device(pe.device_id, t + 0.01)
    for i in range(2, 40):
        rt.tick(t + 0.01 * i)
    assert len(rec.dumps) == 1
    return tracer, pathlib.Path(rec.dumps[0]).read_text(), t + 0.39


RUNS = {"burst": _burst, "failed_nic": _failed_nic}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runtime_scale_ops_equal_jax(sides, name, tmp_path):
    jax_side, port_side = sides
    j_tracer, j_bundle, _ = RUNS[name](jax_side, tmp_path / "jax")
    tracer, bundle, t_end = RUNS[name](port_side, tmp_path / "port")
    spans, j_spans = list(tracer.spans), list(j_tracer.spans)
    got, want = obs.analyze_scale_ops(spans), j_obs.analyze_scale_ops(j_spans)
    assert got, "the runtime closed no scale_op span"
    assert _asdicts(got) == _asdicts(want)  # the Fraction segments included
    assert all(r.conserved() for r in got)
    assert obs.format_scale_report(got) == j_obs.format_scale_report(want)
    assert obs.text_trace(spans) == j_obs.text_trace(j_spans)
    assert bundle == j_bundle
    doc = json.loads(bundle)
    assert doc["incident"]["critical_path"]["n_ops"] >= 1 and doc["traceEvents"]
    again = obs.analyze_scale_ops(obs.load_chrome(obs.chrome_trace(spans)))
    assert obs.format_scale_report(again) == obs.format_scale_report(got)
    assert all(r.t1 <= t_end for r in got)
