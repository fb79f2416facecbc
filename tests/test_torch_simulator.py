"""The port's cluster simulator (repro_torch.core.simulator, the paper's Fig. 3
method) against the JAX package's: the same host arithmetic on the same seeded
trace, so every request's timings, the GPU-time ledger, the host caches and
the flow-event log are compared with ``==``.  The seconds are modelled
seconds on the paper's A800 cluster."""

import dataclasses
import functools
import pathlib

import pytest

from repro import net as j_net
from repro.core import simulator as j_sim
from repro.workloads import traces as j_traces
from repro_torch.core import simulator as sim
from repro_torch.net import FlowEventLog, LinkProfile
from repro_torch.obs.ledger import DEVICE_STATES
from repro_torch.workloads import traces

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
SYSTEMS = {
    "blitz": lambda m: m.BLITZ,
    "blitz-nolive": lambda m: m.BLITZ_NOLIVE,
    "blitz-naive": lambda m: m.BLITZ_NAIVE,
    "sllm": lambda m: m.SLLM,
    "allcache": lambda m: m.ALLCACHE,
    "fixed": lambda m: m.fixed_system("fixed", 2, 2),
    "ssd": lambda m: m.SSD_ONLY,
    "delay-2s": lambda m: m.delay_system(2.0),
}


def _trace(mod, duration=30.0, rate=4.0, seed=0):
    return mod.burstgpt(duration=duration, base_rate=rate, seed=seed)


def _record(s, res):
    """Everything a run reports, in plain Python values."""
    return {
        "requests": [dataclasses.asdict(r) for r in res.requests],
        "ttfts": res.ttfts().tolist(),
        "tbts": res.tbts().tolist(),
        "gpu_time_s": res.gpu_time_s,
        "ledger_total": s.ledger.total(),
        "device_seconds": res.device_seconds,
        "host_cache_peak_bytes": res.host_cache_peak_bytes,
        "host_cache_total": res.host_cache_total(),
        "scale_events": res.scale_events,
        "scale_seconds": res.scale_seconds,
        "net_scale_bytes": res.net_scale_bytes,
        "kv_stream_bytes": res.kv_stream_bytes,
        "kv_re_prefills": res.kv_re_prefills,
        "timeline": res.timeline,
        "p99_ttft": res.p99_ttft(),
        "slo_attainment": res.slo_attainment(s.prof),
    }


@functools.lru_cache(maxsize=None)
def _run(side: str, system: str):
    mod, tr = (sim, traces) if side == "port" else (j_sim, j_traces)
    s = mod.Simulator(SYSTEMS[system](mod), mod.profile_for("8b"), seed=0)
    res = s.run(_trace(tr))
    return s, res, _record(s, res)


def test_traces_equal_jax():
    assert _trace(traces) == _trace(j_traces)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_simulator_equals_jax(system):
    got, want = _run("port", system)[2], _run("jax", system)[2]
    assert got["requests"], "the trace served no request"
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_gpu_time_is_conserved_by_the_ledger(system):
    """gpu_time_s is the ledger's total(); the states, added in
    DEVICE_STATES order, give it bit for bit (never the built-in sum(),
    which compensates under Python 3.12)."""
    s, res, _ = _run("port", system)
    assert res.gpu_time_s == s.ledger.total() > 0.0
    t = 0.0
    for state in DEVICE_STATES:
        t += res.device_seconds[state]
    assert t == res.gpu_time_s
    assert list(res.device_seconds) == list(DEVICE_STATES)


def test_every_request_completes():
    """tests/test_simulator.py:16 on the port."""
    _, res, _ = _run("port", "blitz")
    for req in res.requests:
        assert req.prefill_done is not None and req.decoded >= req.output


def test_o1_host_cache_against_sllm():
    """Fig. 19: BLITZSCALE keeps at most one host copy, ServerlessLLM more."""
    prof = sim.profile_for("8b")
    assert _run("port", "blitz")[1].host_cache_total() <= prof.param_bytes
    assert _run("port", "sllm")[1].host_cache_total() >= prof.param_bytes


@pytest.mark.parametrize("size", ["8b", "24b", "72b"])
def test_profiles_equal_jax(size):
    got, want = sim.profile_for(size), j_sim.profile_for(size)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("prefill_tps", "weight_pass_s", "kv_capacity_tokens"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.kv_read_s(1024) == want.kv_read_s(1024)


def test_device_failure_run_equals_jax():
    """tests/test_simulator.py:135: the KV source dies, the request pays a
    re-prefill; the port does the same, event for event."""

    def run(mod, tr_mod, log):
        s = mod.Simulator(mod.BLITZ, mod.profile_for("8b"), seed=0)
        s.flowsim.subscribe(log)

        def kill_first_prefill(s_):
            pres = s_._active_instances("prefill")
            if pres:
                s_.flowsim.fail_device(pres[0].device_ids[0], s_.now)

        for t in (6.0, 8.0, 10.0):
            s.schedule(t, kill_first_prefill)
        res = s.run(_trace(tr_mod, 40.0, 4.0, seed=2))
        return _record(s, res), log.lines()

    got, got_lines = run(sim, traces, FlowEventLog())
    want, want_lines = run(j_sim, j_traces, j_net.FlowEventLog())
    assert got["kv_re_prefills"] > 0
    assert got == want
    assert got_lines == want_lines


# ---------------------------------------------------------------------------
# the flow-event goldens, with tests/test_golden_trace.py's settings
# ---------------------------------------------------------------------------


def _golden_run(**kw):
    log = FlowEventLog()
    s = sim.Simulator(sim.BLITZ, sim.profile_for("8b"), seed=0, **kw)
    s.flowsim.subscribe(log)
    res = s.run(traces.burstgpt(duration=40.0, base_rate=5.0, seed=11))
    return log.lines(), res


def _golden(name: str) -> list[str]:
    return (GOLDEN_DIR / name).read_text().splitlines()


def test_flow_event_log_matches_golden_legacy():
    lines, res = _golden_run(per_request_kv=False)
    assert res.kv_stream_bytes == 0.0
    assert lines == _golden("flow_events_legacy.txt")


def test_flow_event_log_matches_golden_realistic():
    lines, res = _golden_run(link_latency_s=2e-5, switch_latency_s=5e-6)
    assert res.kv_stream_bytes > 0.0
    assert lines == _golden("flow_events_realistic.txt")


def test_uniform_link_profiles_match_golden_realistic():
    probe = sim.Simulator(sim.BLITZ, sim.profile_for("8b"), seed=0)
    profiles = {key: LinkProfile(latency_s=2e-5, switch_latency_s=5e-6)
                for key in probe.flowsim.net.links}
    lines, _ = _golden_run(link_profiles=profiles)
    assert lines == _golden("flow_events_realistic.txt")

