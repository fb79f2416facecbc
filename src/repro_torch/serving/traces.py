"""Re-export of :mod:`repro_torch.workloads.traces` under its historical
path, as ``repro.serving.traces`` is in the JAX package."""

from repro_torch.workloads.traces import (  # noqa: F401
    TRACES,
    _emit,
    _lognormal_tokens,
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
