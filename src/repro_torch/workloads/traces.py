"""Synthetic trace generators shaped after the paper's three workloads.

The paper evaluates BurstGPT [71], AzureCode and AzureConv [14], scaled with
TraceUpscaler so the average request rate is half the cluster's max serving
capacity (§6).  We reproduce the *shapes* (first column of Fig. 17):

  * **BurstGPT** — sharp 5x bursts within ~2 s on a modest baseline rate,
    recurring every ~100 s;
  * **AzureCode** — two isolated bursts separated by minutes of quiet (the
    gap defeats TTL host caching — §6.1's S-LLM analysis);
  * **AzureConv** — continuously arriving bursts (S-LLM always cache-hits).

Token-length distributions follow the published Azure traces: conversation
prompts ~1024 tokens / outputs ~256; code prompts ~2048 / outputs ~64;
BurstGPT ~512/128 (lognormal).
"""

from __future__ import annotations

import numpy as np


def _lognormal_tokens(rng, mean: float, n: int, lo: int = 16, hi: int = 8192) -> np.ndarray:
    sigma = 0.6
    mu = np.log(mean) - sigma**2 / 2
    return np.clip(rng.lognormal(mu, sigma, n).astype(int), lo, hi)


def _emit(rng, rate_fn, duration: float, prompt_mean: int, output_mean: int,
          ) -> list[tuple[float, int, int]]:
    """Inhomogeneous Poisson arrivals by thinning."""
    peak = max(rate_fn(t) for t in np.linspace(0, duration, 2048))
    t = 0.0
    times = []
    while t < duration:
        t += rng.exponential(1.0 / peak)
        if t < duration and rng.random() < rate_fn(t) / peak:
            times.append(t)
    n = len(times)
    prompts = _lognormal_tokens(rng, prompt_mean, n)
    outputs = _lognormal_tokens(rng, output_mean, n, lo=8, hi=2048)
    return [(float(t), int(p), int(o)) for t, p, o in zip(times, prompts, outputs)]


def burstgpt(duration: float = 300.0, base_rate: float = 2.0, *,
             burst_mult: float = 5.0, burst_every: float = 100.0,
             burst_len: float = 8.0, seed: int = 0) -> list[tuple[float, int, int]]:
    rng = np.random.default_rng(seed)

    def rate(t):
        phase = t % burst_every
        return base_rate * (burst_mult if 5.0 <= phase < 5.0 + burst_len else 1.0)

    return _emit(rng, rate, duration, prompt_mean=512, output_mean=128)


def azure_code(duration: float = 300.0, base_rate: float = 1.5, *,
               seed: int = 1) -> list[tuple[float, int, int]]:
    rng = np.random.default_rng(seed)
    b1, b2 = 0.1 * duration, 0.75 * duration  # two isolated bursts

    def rate(t):
        if b1 <= t < b1 + 10 or b2 <= t < b2 + 10:
            return base_rate * 6.0
        return base_rate * 0.5

    return _emit(rng, rate, duration, prompt_mean=2048, output_mean=64)


def azure_conv(duration: float = 300.0, base_rate: float = 2.0, *,
               seed: int = 2) -> list[tuple[float, int, int]]:
    rng = np.random.default_rng(seed)

    def rate(t):
        # continuous bursts: sinusoidal surges every ~40 s
        import math
        return base_rate * (1.0 + 2.5 * max(0.0, math.sin(2 * math.pi * t / 40.0)) ** 4)

    return _emit(rng, rate, duration, prompt_mean=1024, output_mean=256)


TRACES = {"burstgpt": burstgpt, "azure_code": azure_code, "azure_conv": azure_conv}


# ---------------------------------------------------------------------------
# Multi-model MaaS traces (fleet arbitration / scale-to-zero workloads)
# ---------------------------------------------------------------------------


def zipf_weights(n: int, alpha: float = 1.2) -> np.ndarray:
    """Skewed model popularity: weight of the rank-k model ∝ 1/k^alpha —
    the MaaS regime the paper targets (a few hot models, a long cold tail
    that should spend most of its life scaled to zero)."""
    ranks = np.arange(1, n + 1, dtype=float)
    w = ranks**-alpha
    return w / w.sum()


def multi_model_mix(
    models: list[str],
    *,
    duration: float = 300.0,
    total_rate: float = 4.0,
    alpha: float = 1.2,
    kind: str | dict = "burstgpt",
    stagger: bool = True,
    seed: int = 0,
) -> list[tuple[float, str, int, int]]:
    """Merged fleet trace: each model draws arrivals from ``kind``'s shape
    at a Zipf share of ``total_rate``; returns (t, model, prompt_tokens,
    output_tokens) sorted by time.

    ``kind`` may be a dict mapping model -> trace kind, so per-tenant SLO
    classes get per-tenant shapes in ONE merged trace — e.g. a latency-tier
    chatbot on ``burstgpt`` bursts riding alongside a throughput-tier batch
    model on steady ``azure_conv`` surges (models not in the dict fall back
    to ``burstgpt``).

    ``stagger`` rotates each model's arrivals by a fraction of the horizon
    so bursts peak at *different* times — the premise of fleet sharing:
    aggregate demand is far smoother than any one model's, so a shared pool
    needs far fewer devices than per-model peak provisioning (Fig. 18)."""
    ws = zipf_weights(len(models), alpha)
    merged: list[tuple[float, str, int, int]] = []
    for k, (m, w) in enumerate(zip(models, ws)):
        k_kind = kind.get(m, "burstgpt") if isinstance(kind, dict) else kind
        tr = TRACES[k_kind](duration=duration, base_rate=total_rate * float(w), seed=seed + k)
        off = k * duration / len(models) if stagger else 0.0
        merged.extend(((t + off) % duration, m, p, o) for t, p, o in tr)
    merged.sort()
    return merged


def request_kv_bytes(prompt_tokens: int, kv_bytes_per_token: int) -> int:
    """KV-cache volume one request's prefill produces — the bytes its
    prefill→decode stream actually moves over the network (the simulator's
    per-request serving flows are sized with this, replacing the old
    persistent background streams)."""
    return max(1, int(prompt_tokens)) * int(kv_bytes_per_token)


def kv_volumes(trace: list[tuple[float, int, int]],
               kv_bytes_per_token: int) -> list[int]:
    """Per-request KV stream sizes for a whole trace, in arrival order."""
    return [request_kv_bytes(p, kv_bytes_per_token) for _, p, _ in trace]


def scale_to_capacity(trace: list[tuple[float, int, int]],
                      target_rate: float) -> list[tuple[float, int, int]]:
    """TraceUpscaler-style: rescale arrival times so the mean request rate
    matches ``target_rate`` while preserving the temporal pattern (§6)."""
    if not trace:
        return trace
    duration = trace[-1][0]
    cur = len(trace) / max(duration, 1e-9)
    k = cur / target_rate
    return [(t * k, p, o) for t, p, o in trace]
