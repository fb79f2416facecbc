"""ZigZag live-autoscaling scheduling (paper §5.2, Figs. 15-16): the port's
copy of ``repro.core.zigzag``, host arithmetic only (stdlib and numpy).

During live scaling, each request batch is executed as a 2-stage pipeline:
the scaling *target* instance runs the first ``T_i`` layers (those already
loaded), the overloaded *source* instance runs the remaining ``S_i = L-T_i``.
Choosing ``(T_i, S_i)`` per batch is the paper's ILP:

    min  Latency_avg = (sum_req sum_{i<=req} S_i) / N
    s.t. C1  S_i + T_i = L
         C2  sum_{j<=i} T_j <= sum_{j<=i-1} S_j          (pipeline dependency)
         C3  Time_l * (T_i-1) <= sum_{j<i} T_j + (N-i+1)(T_i-1)   (load limit)

where ``Time_l`` is the per-layer load time normalized to per-layer execute
time.  NOTE: the paper prints C3's LHS as ``Time_l * T_i``, but its own
worked example (Fig. 15b, config (2,5) for request 2 with Time_l=6) violates
that form; since the time origin is "first layer loaded", layer ``T_i``
finishes loading at ``Time_l * (T_i - 1)``, which matches the example — we
use that reading.  The objective is equivalent to maximizing
``sum_i (N-i+1) * T_i``, so an exact dynamic program over the prefix sum of
T solves it in ``O(N^2 L^2)`` — milliseconds for the paper's sizes (the paper reports
<40 ms for Llama3-8B with an off-the-shelf ILP solver).

For many-layer models the paper's ILP-free rule (Fig. 16) is implemented in
:func:`simulate_zigzag`: a shared priority queue ordered by (FCFS, next
layer loaded), the target executes one layer at a time and re-queues, the
source pulls the earliest request only when it has no pending work.
``simulate_best_effort`` is the strawman of Fig. 15(a).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Exact ILP solver (dynamic program)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelinePlan:
    configs: list[tuple[int, int]]  # (T_i, S_i) per request batch
    avg_latency: float  # in layer-execution-time units
    solve_ms: float


def avg_latency_of(configs: Sequence[tuple[int, int]]) -> float:
    """The paper's objective: each request's latency is the source-side
    completion = sum of S_j for j <= i (FIFO queueing + own execution)."""
    n = len(configs)
    tot, pref = 0.0, 0.0
    for _, s in configs:
        pref += s
        tot += pref
    return tot / max(n, 1)


def solve_pipeline_ilp(
    n_requests: int, n_layers: int, time_l: float
) -> PipelinePlan:
    """Exact DP over (request index, prefix sum of T)."""
    import time as _time

    t0 = _time.perf_counter()
    N, L = n_requests, n_layers
    if N == 0:
        return PipelinePlan([], 0.0, 0.0)

    NEG = -1 << 60
    max_pref = N * L
    # dp[p] = best sum of w_i*T_i achievable with prefix sum p after request i
    dp = np.full(max_pref + 1, NEG, dtype=np.int64)
    choice: list[np.ndarray] = []

    # request 1: C2/C3 do not apply (time origin = first layer loaded).
    # T_1 >= 1 must hold only if we want the target involved at all; allow 0.
    # Extra layers beyond the first must have loaded while later requests
    # execute: Time_l*(T_1-1) <= N*(T_1-1) handles the degenerate cases.
    w1 = N
    c1 = np.full(max_pref + 1, -1, dtype=np.int64)
    for t in range(0, min(L, max_pref) + 1):
        if t >= 2 and time_l > N:
            break
        val = w1 * t
        if val > dp[t]:
            dp[t] = val
            c1[t] = t
    choice.append(c1)

    for i in range(2, N + 1):
        w = N - i + 1
        ndp = np.full(max_pref + 1, NEG, dtype=np.int64)
        ci = np.full(max_pref + 1, -1, dtype=np.int64)
        for p in range(max_pref + 1):
            if dp[p] == NEG:
                continue
            # C2: prefT_{i-1} + T_i <= (i-1)L - prefT_{i-1}
            hi = (i - 1) * L - 2 * p
            hi = min(hi, L)
            if hi < 0:
                continue
            for t in range(0, hi + 1):
                # C3: time_l*(T_i-1) <= prefT_{i-1} + (N-i+1)*(T_i-1)
                if t > 0 and time_l * (t - 1) > p + w * (t - 1) + 1e-9:
                    continue
                np_ = p + t
                val = dp[p] + w * t
                if val > ndp[np_]:
                    ndp[np_] = val
                    ci[np_] = t
        dp = ndp
        choice.append(ci)

    best_p = int(np.argmax(dp))
    if dp[best_p] == NEG:
        # infeasible beyond request 1 — degenerate all-source plan
        cfgs = [(0, L)] * N
        return PipelinePlan(cfgs, avg_latency_of(cfgs), (_time.perf_counter() - t0) * 1e3)

    # backtrack
    ts: list[int] = []
    p = best_p
    for i in range(N, 0, -1):
        t = int(choice[i - 1][p])
        ts.append(t)
        p -= t
    ts.reverse()
    cfgs = [(t, L - t) for t in ts]
    return PipelinePlan(cfgs, avg_latency_of(cfgs), (_time.perf_counter() - t0) * 1e3)


# ---------------------------------------------------------------------------
# ILP-free ZigZag scheduler (Fig. 16) — event-driven co-simulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScheduleResult:
    completion: list[float]  # per-request completion time (exec-time units)
    avg_latency: float
    makespan: float
    target_layers: list[int]  # layers executed on the target per request


def simulate_zigzag(
    n_requests: int,
    n_layers: int,
    time_l: float,
    *,
    exec_time: Sequence[float] | None = None,
) -> ScheduleResult:
    """The ILP-free rule.  Time unit = one layer execution (per-batch
    ``exec_time`` scales it — the §5.4 LLM regulation parameter).

    Target: repeatedly take the highest-priority request whose
    next-to-execute layer is loaded; execute ONE layer; requeue.
    Source: when idle, pull the earliest request not running on the target
    and finish ALL its remaining layers.
    """
    N, L = n_requests, n_layers
    et = list(exec_time) if exec_time is not None else [1.0] * N
    layers_done = [0] * N  # layers executed so far (on either side)
    on_target = [True] * N  # still eligible for target execution
    done = [False] * N
    completion = [0.0] * N
    tgt_layers = [0] * N

    t_target = 0.0  # target instance free-at time
    t_source = 0.0  # source instance free-at time
    # layer k (0-based) is loaded at time k*time_l, layer 0 at t=0; the
    # epsilon guards against float truncation (t == k*time_l must count
    # layer k as loaded, else the event loop can livelock at that instant)
    loaded = lambda t: min(L, 1 + int((max(t, 0.0) + 1e-9) / time_l)) if time_l > 0 else L

    def next_target_req(now: float) -> int | None:
        nl = loaded(now)
        for i in range(N):
            if done[i] or not on_target[i]:
                continue
            if layers_done[i] < nl and layers_done[i] < L:
                return i  # FCFS among those with next layer loaded
        return None

    def next_source_req() -> int | None:
        for i in range(N):
            if not done[i] and not running_on_target[i]:
                return i
        return None

    running_on_target = [False] * N
    # event loop: advance whichever instance frees first
    guard = 0
    while not all(done) and guard < 100 * N * L + 1000:
        guard += 1
        progressed = False
        # source: pull earliest pending request and run it to completion
        i = next_source_req()
        if i is not None and t_source <= t_target + 1e-12:
            rem = L - layers_done[i]
            if rem > 0:
                on_target[i] = False  # source takes over: finish all layers
                start = max(t_source, 0.0)
                t_source = start + rem * et[i]
                layers_done[i] = L
                done[i] = True
                completion[i] = t_source
                progressed = True
            else:
                done[i] = True
                completion[i] = max(t_source, t_target)
                progressed = True
        if not progressed:
            # target: one layer of the best request
            i = next_target_req(t_target)
            if i is not None:
                running_on_target[i] = True
                t_target = max(t_target, layers_done[i] * time_l) + et[i]
                layers_done[i] += 1
                tgt_layers[i] += 1
                running_on_target[i] = False
                if layers_done[i] >= L:
                    done[i] = True
                    completion[i] = t_target
                progressed = True
        if not progressed:
            # both stalled: advance target clock to the next layer-load event
            nl = loaded(t_target)
            if nl < L:
                t_target = nl * time_l
            else:
                # nothing left for the target; let the source catch up
                t_source = max(t_source, t_target)
                i = next_source_req()
                if i is None:
                    break
    avg = float(np.mean(completion)) if completion else 0.0
    return ScheduleResult(completion, avg, max(completion, default=0.0), tgt_layers)


def simulate_best_effort(
    n_requests: int,
    n_layers: int,
    time_l: float,
    *,
    exec_time: Sequence[float] | None = None,
) -> ScheduleResult:
    """Strawman (Fig. 15a): each batch greedily uses as many loaded layers as
    possible on the target (<= L/2), the rest on the source, strictly FCFS
    with no delaying."""
    N, L = n_requests, n_layers
    et = list(exec_time) if exec_time is not None else [1.0] * N
    t_target, t_source = 0.0, 0.0
    completion = [0.0] * N
    tgt_layers = [0] * N
    loaded = lambda t: min(L, 1 + int((max(t, 0.0) + 1e-9) / time_l)) if time_l > 0 else L
    for i in range(N):
        k = min(loaded(t_target), L // 2)
        # target stage: wait for layer availability as it executes
        start = t_target
        tt = start
        for layer in range(k):
            tt = max(tt, layer * time_l) + et[i]
        t_target = tt
        tgt_layers[i] = k
        # source stage: starts when both the activation arrives and source free
        s = L - k
        t_source = max(t_source, tt) + s * et[i]
        completion[i] = t_source if s > 0 else tt
    avg = float(np.mean(completion)) if completion else 0.0
    return ScheduleResult(completion, avg, max(completion, default=0.0), tgt_layers)


# ---------------------------------------------------------------------------
# Throughput model during live scaling (§4 example)
# ---------------------------------------------------------------------------


def live_throughput_multiplier(k_loaded: int, n_layers: int) -> float:
    """Relative serving throughput of the (source + scaling target) pair vs a
    single instance.  With k layers loaded the scheduler assigns the target
    t = min(k, L//2) layers (never more — over-assigning would make the
    target the bottleneck), so the pipeline rate is 1/max(t, L-t):
    monotone ramp from 1 to 2, reaching 2.0 at k = L/2 (§4)."""
    L = n_layers
    k = max(0, min(k_loaded, L))
    if k == 0:
        return 1.0
    if k >= L:
        return 2.0
    t = min(k, L // 2)
    return L / max(t, L - t, 1)
