"""The part of ``repro.core.zigzag`` that live scaling needs."""

from __future__ import annotations


def live_throughput_multiplier(k_loaded: int, n_layers: int) -> float:
    """Relative serving throughput of the (source + scaling target) pair vs a
    single instance.  With k layers loaded the target takes t = min(k, L//2)
    layers, so the pipeline rate is 1/max(t, L-t): a monotone ramp from 1 to
    2, reaching 2.0 at k = L/2 (paper §4)."""
    L = n_layers
    k = max(0, min(k_loaded, L))
    if k == 0:
        return 1.0
    if k >= L:
        return 2.0
    t = min(k, L // 2)
    return L / max(t, L - t, 1)
