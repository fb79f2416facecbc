"""The port's ZigZag scheduler (repro_torch.core.zigzag) against the JAX
package's: the exact pipeline DP and both event-driven schedules are the same
host arithmetic, so plans, latencies and schedules are compared with ``==``."""

import dataclasses

import pytest

from repro.core import zigzag as j_zz
from repro_torch.core import zigzag as zz

GRID = [(n, layers, time_l)
        for n in (1, 3, 7)
        for layers in (2, 7, 12)
        for time_l in (0.5, 1.0, 2.5, 6.0, 12.0)]


def _ids(case):
    return "N{}-L{}-Tl{}".format(*case)


@pytest.mark.parametrize("case", GRID, ids=[_ids(c) for c in GRID])
def test_pipeline_plan_equals_jax(case):
    got, want = zz.solve_pipeline_ilp(*case), j_zz.solve_pipeline_ilp(*case)
    assert got.configs == want.configs
    assert got.avg_latency == want.avg_latency
    assert zz.avg_latency_of(got.configs) == j_zz.avg_latency_of(want.configs)


@pytest.mark.parametrize("case", GRID, ids=[_ids(c) for c in GRID])
def test_schedules_equal_jax(case):
    for name in ("simulate_zigzag", "simulate_best_effort"):
        got = getattr(zz, name)(*case)
        want = getattr(j_zz, name)(*case)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def test_paper_fig15b_example_equals_jax():
    """Fig. 15b: a 7-layer model, Time_l = 6, 7 requests (tests/test_zigzag.py:40)."""
    n, layers, time_l = 7, 7, 6.0
    plan, want = zz.solve_pipeline_ilp(n, layers, time_l), j_zz.solve_pipeline_ilp(n, layers, time_l)
    assert plan.configs == want.configs and plan.avg_latency == want.avg_latency
    be, zg = zz.simulate_best_effort(n, layers, time_l), zz.simulate_zigzag(n, layers, time_l)
    assert dataclasses.asdict(be) == dataclasses.asdict(j_zz.simulate_best_effort(n, layers, time_l))
    assert dataclasses.asdict(zg) == dataclasses.asdict(j_zz.simulate_zigzag(n, layers, time_l))
    assert zg.avg_latency <= be.avg_latency and zg.makespan <= be.makespan
    assert plan.avg_latency <= be.avg_latency


def test_paper_sized_plan_equals_jax():
    """Llama3-8B's 32 layers and 12 batches (tests/test_zigzag.py:82)."""
    got, want = zz.solve_pipeline_ilp(12, 32, 6.0), j_zz.solve_pipeline_ilp(12, 32, 6.0)
    assert got.configs == want.configs and got.avg_latency == want.avg_latency


@pytest.mark.parametrize("exec_time", [(1.0, 2.0, 0.5, 1.5), (0.25, 0.25, 3.0, 1.0)])
def test_schedules_with_exec_time_equal_jax(exec_time):
    """Per-batch execute times (the §5.4 regulation parameter)."""
    for name in ("simulate_zigzag", "simulate_best_effort"):
        for time_l in (0.0, 1.5, 6.0):
            got = getattr(zz, name)(4, 9, time_l, exec_time=exec_time)
            want = getattr(j_zz, name)(4, 9, time_l, exec_time=exec_time)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (name, time_l)


def test_empty_plan_equals_jax():
    got, want = zz.solve_pipeline_ilp(0, 8, 2.0), j_zz.solve_pipeline_ilp(0, 8, 2.0)
    assert got.configs == want.configs == [] and got.avg_latency == want.avg_latency


def test_core_exports_the_scheduler():
    import repro_torch.core as core

    assert core.solve_pipeline_ilp is zz.solve_pipeline_ilp
    assert core.simulate_zigzag is zz.simulate_zigzag
    assert core.simulate_best_effort is zz.simulate_best_effort
