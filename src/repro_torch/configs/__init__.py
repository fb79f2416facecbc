"""Architecture registry of the port.

``get_config(name, reduced=False)`` resolves an arch id (dash or underscore
form).  Only the archs whose model family the port runs (dense GQA with a
SwiGLU MLP) are registered; every other id raises ``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.configs import granite_8b, llama3_8b, mistral_24b, qwen1_5_4b, qwen2_5_72b
from repro_torch.models.config import ModelConfig

_PORTED = {
    "granite_8b": granite_8b,
    "llama3_8b": llama3_8b,
    "qwen1_5_4b": qwen1_5_4b,
    "mistral_24b": mistral_24b,
    "qwen2_5_72b": qwen2_5_72b,
}


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    mod = _PORTED.get(name.replace("-", "_").replace(".", "_"))
    if mod is None:
        raise NotImplementedError(f"{name}: not yet ported")
    return mod.REDUCED if reduced else mod.CONFIG
