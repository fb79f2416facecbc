"""Workload generators of the port (the copy of ``repro.workloads``).

Synthetic request traces (arrival processes and token-length
distributions), made with numpy from a seed: the same seed gives the JAX
package's mixes exactly.  The MaaS CLI (``launch/serve.py --maas``) replays
them.  This package imports nothing else of the port.

``repro_torch.serving.traces`` re-exports everything here, as
``repro.serving.traces`` does in the JAX package.
"""

from repro_torch.workloads.traces import (
    TRACES,
    azure_code,
    azure_conv,
    burstgpt,
    kv_volumes,
    multi_model_mix,
    request_kv_bytes,
    scale_to_capacity,
    zipf_weights,
)

__all__ = [
    "TRACES",
    "azure_code",
    "azure_conv",
    "burstgpt",
    "kv_volumes",
    "multi_model_mix",
    "request_kv_bytes",
    "scale_to_capacity",
    "zipf_weights",
]
