"""Architecture registry of the port.

``get_config(name, reduced=False)`` resolves an arch id (dash or underscore
form).  Only the archs whose model family the port runs are registered: the
dense decoders with a SwiGLU MLP, with GQA attention or with MLA
(minicpm3-4b), the MoE olmoe-1b-7b, the SSM mamba2-370m and the hybrid
zamba2-2.7b.  Every other id (whisper's enc-dec, pixtral's VLM, the int8
cache) raises ``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.configs import (
    granite_8b,
    llama3_8b,
    mamba2_370m,
    minicpm3_4b,
    mistral_24b,
    olmoe_1b_7b,
    qwen1_5_4b,
    qwen2_5_72b,
    zamba2_2_7b,
)
from repro_torch.models.config import ModelConfig

_PORTED = {
    "granite_8b": granite_8b,
    "llama3_8b": llama3_8b,
    "qwen1_5_4b": qwen1_5_4b,
    "mistral_24b": mistral_24b,
    "qwen2_5_72b": qwen2_5_72b,
    "minicpm3_4b": minicpm3_4b,
    "olmoe_1b_7b": olmoe_1b_7b,
    "mamba2_370m": mamba2_370m,
    "zamba2_2_7b": zamba2_2_7b,
}


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    mod = _PORTED.get(name.replace("-", "_").replace(".", "_"))
    if mod is None:
        raise NotImplementedError(f"{name}: not yet ported")
    return mod.REDUCED if reduced else mod.CONFIG
