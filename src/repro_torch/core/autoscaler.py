"""Load monitoring + scaling policy (paper §5.3-5.4).

The paper's policy (kept deliberately simple — mechanism, not policy, is the
contribution):

  * monitor per-model serving load: tokens/s against profiled per-instance
    capacity, and KVCache occupancy against instance memory;
  * scale UP when the monitored load exceeds an upper bound — allocate
    enough instances to absorb the surplus;
  * scale DOWN with a (sub-second, thanks to fast scaling) timeout when the
    load stays under a lower bound;
  * PD-disaggregation special case (§5.4): *decode pre-scaling* — a surge in
    prefill demand forecasts a decode surge one generation later, so decode
    instances scale simultaneously with prefill at effectively zero extra
    latency cost (applied to all baselines in the evaluation, like the
    paper does);
  * live-scaling a decode instance directly would incast-collide with
    KVCache migration, so decode scale-ups prefer *mutating* a prefill
    instance (same parameters!) into a decode instance while live-scaling a
    replacement prefill.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable


@dataclasses.dataclass
class PolicyConfig:
    upper_util: float = 0.85  # scale up when load/capacity exceeds this
    lower_util: float = 0.30  # scale down below this ...
    scale_down_timeout_s: float = 0.8  # ... for this long (sub-second, §5.3)
    monitor_window_s: float = 1.0
    kv_upper: float = 0.90  # decode KV occupancy scale-up bound
    decode_prescale: bool = True  # §5.4 optimized policy
    max_instances: int = 64


@dataclasses.dataclass
class LoadSample:
    t: float
    tokens_per_s: float
    kv_used_frac: float
    queue_depth: int


class LoadMonitor:
    """Sliding-window load tracker for one model service + phase."""

    def __init__(self, window_s: float = 1.0):
        self.window_s = window_s
        self.samples: deque[LoadSample] = deque()

    def record(self, s: LoadSample) -> None:
        self.samples.append(s)
        while self.samples and self.samples[0].t < s.t - self.window_s:
            self.samples.popleft()

    def avg_tokens_per_s(self) -> float:
        if not self.samples:
            return 0.0
        return sum(s.tokens_per_s for s in self.samples) / len(self.samples)

    def avg_kv_frac(self) -> float:
        if not self.samples:
            return 0.0
        return sum(s.kv_used_frac for s in self.samples) / len(self.samples)

    def max_queue(self) -> int:
        return max((s.queue_depth for s in self.samples), default=0)


@dataclasses.dataclass
class ScaleDecision:
    prefill_delta: int = 0  # +n scale up, -n scale down
    decode_delta: int = 0
    prescaled: bool = False  # decode_delta came from the §5.4 forecast
    reason: str = ""


class Autoscaler:
    """Upper/lower-bound policy with decode pre-scaling."""

    def __init__(
        self,
        policy: PolicyConfig,
        *,
        prefill_capacity_tps: float,  # profiled per-instance tokens/s
        decode_capacity_tps: float,
    ):
        self.policy = policy
        self.pre_cap = prefill_capacity_tps
        self.dec_cap = decode_capacity_tps
        self.prefill_mon = LoadMonitor(policy.monitor_window_s)
        self.decode_mon = LoadMonitor(policy.monitor_window_s)
        self._below_since: dict[str, float | None] = {"prefill": None, "decode": None}

    # ------------------------------------------------------------------
    def phase_pressures(self, n_prefill: int, n_decode: int) -> tuple[float, float]:
        """Per-phase SLO pressure given the current instance counts.

        Dimensionless: 1.0 means the phase's monitored load (tokens/s, or KV
        occupancy for decode) sits exactly at its scale-up bound; >1 means
        under-provisioned *right now*; inf means offered load with zero
        capacity (the fleet treats that as a cold-start request)."""
        p = self.policy
        pre_cap = n_prefill * self.pre_cap * p.upper_util
        dec_cap = n_decode * self.dec_cap * p.upper_util
        pre_load = self.prefill_mon.avg_tokens_per_s()
        dec_load = self.decode_mon.avg_tokens_per_s()
        pre = pre_load / pre_cap if pre_cap > 0 else (float("inf") if pre_load > 0 else 0.0)
        dec = dec_load / dec_cap if dec_cap > 0 else (float("inf") if dec_load > 0 else 0.0)
        kv = self.decode_mon.avg_kv_frac() / p.kv_upper
        return pre, max(dec, kv)

    def slo_pressure(self, n_prefill: int, n_decode: int) -> float:
        """How close this model is to violating its SLO — the fleet
        arbitration signal (MaaS control plane): max over phase pressures."""
        return max(self.phase_pressures(n_prefill, n_decode))

    # ------------------------------------------------------------------
    def decide(
        self, now: float, n_prefill: int, n_decode: int
    ) -> ScaleDecision:
        p = self.policy
        d = ScaleDecision()

        # ---- prefill scale-up: load-based
        load = self.prefill_mon.avg_tokens_per_s()
        cap = max(n_prefill, 1) * self.pre_cap
        if load > p.upper_util * cap and n_prefill < p.max_instances:
            need = int(-(-load // (p.upper_util * self.pre_cap)))  # ceil
            d.prefill_delta = min(need - n_prefill, p.max_instances - n_prefill)
            d.prefill_delta = max(d.prefill_delta, 1)
            d.reason = f"prefill load {load:.0f} > {p.upper_util:.0%} of {cap:.0f}"
            # §5.4 decode pre-scaling: prefill surge forecasts decode surge
            if p.decode_prescale and n_decode < p.max_instances:
                dec_load = self.decode_mon.avg_tokens_per_s()
                dec_need = int(-(-(dec_load + load) // (p.upper_util * self.dec_cap)))
                if dec_need > n_decode:
                    d.decode_delta = min(dec_need - n_decode, p.max_instances - n_decode)
                    d.prescaled = True

        # ---- decode scale-up: load- or KV-pressure based
        kv = self.decode_mon.avg_kv_frac()
        dec_load = self.decode_mon.avg_tokens_per_s()
        dec_cap = max(n_decode, 1) * self.dec_cap
        if d.decode_delta == 0 and n_decode < p.max_instances:
            if dec_load > p.upper_util * dec_cap:
                dec_need = int(-(-dec_load // (p.upper_util * self.dec_cap)))  # ceil
                d.decode_delta = min(
                    max(dec_need - n_decode, 1), p.max_instances - n_decode
                )
                d.reason = d.reason or (
                    f"decode load {dec_load:.0f} > {p.upper_util:.0%} of {dec_cap:.0f}"
                )
            elif kv > p.kv_upper:
                d.decode_delta = 1
                d.reason = d.reason or f"decode KV {kv:.0%} > {p.kv_upper:.0%}"

        # ---- scale-down: timeout below lower bound
        for phase, mon, n_cur, cap_one in (
            ("prefill", self.prefill_mon, n_prefill, self.pre_cap),
            ("decode", self.decode_mon, n_decode, self.dec_cap),
        ):
            if n_cur <= 1:
                self._below_since[phase] = None
                continue
            low = mon.avg_tokens_per_s() < p.lower_util * n_cur * cap_one
            kv_ok = phase != "decode" or mon.avg_kv_frac() < p.lower_util
            if low and kv_ok:
                if self._below_since[phase] is None:
                    self._below_since[phase] = now
                elif now - self._below_since[phase] >= p.scale_down_timeout_s:
                    delta = -1
                    if phase == "prefill" and d.prefill_delta == 0:
                        d.prefill_delta = delta
                    elif phase == "decode" and d.decode_delta == 0:
                        d.decode_delta = delta
                    self._below_since[phase] = now
            else:
                self._below_since[phase] = None
        return d
