"""Architecture registry of the port.

``get_config(name, reduced=False)`` resolves an arch id (dash or underscore
form) to its config, full or REDUCED.  Every arch of the JAX package's
registry is registered: the dense GQA decoders, minicpm3-4b (MLA),
nemotron-4-340b (squared-ReLU MLP), the MoE olmoe-1b-7b and grok-1-314b,
the SSM mamba2-370m, the hybrid zamba2-2.7b, the enc-dec whisper-large-v3
and the VLM pixtral-12b.  An unknown id raises ``KeyError``.  No config sets
the int8 KV cache; ``cfg.replace(kv_quant=True)`` turns it on, as the JAX
package's ``cfg_overrides`` does.  ``SHAPES`` / ``cells()`` enumerate the
reference's (arch x input shape) dry-run grid, ``ARCH_IDS`` x ``SHAPES``
less the long-context cell of the archs without sub-quadratic mixing.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from repro_torch.configs import (
    granite_8b,
    grok_1_314b,
    llama3_8b,
    mamba2_370m,
    minicpm3_4b,
    mistral_24b,
    nemotron_4_340b,
    olmoe_1b_7b,
    pixtral_12b,
    qwen1_5_4b,
    qwen2_5_72b,
    whisper_large_v3,
    zamba2_2_7b,
)
from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "granite-8b",
    "nemotron-4-340b",
    "qwen1.5-4b",
    "minicpm3-4b",
    "mamba2-370m",
    "pixtral-12b",
    "grok-1-314b",
    "olmoe-1b-7b",
    "whisper-large-v3",
    "zamba2-2.7b",
]

# the paper's own evaluation models
PAPER_IDS = ["llama3-8b", "mistral-24b", "qwen2.5-72b"]

ARCHS = {
    "granite_8b": granite_8b,
    "llama3_8b": llama3_8b,
    "qwen1_5_4b": qwen1_5_4b,
    "mistral_24b": mistral_24b,
    "qwen2_5_72b": qwen2_5_72b,
    "minicpm3_4b": minicpm3_4b,
    "olmoe_1b_7b": olmoe_1b_7b,
    "mamba2_370m": mamba2_370m,
    "zamba2_2_7b": zamba2_2_7b,
    "grok_1_314b": grok_1_314b,
    "nemotron_4_340b": nemotron_4_340b,
    "whisper_large_v3": whisper_large_v3,
    "pixtral_12b": pixtral_12b,
}


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    mod = ARCHS.get(name.replace("-", "_").replace(".", "_"))
    if mod is None:
        raise KeyError(f"{name}: unknown arch (known: {sorted(ARCHS)})")
    return mod.REDUCED if reduced else mod.CONFIG


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode' | 'long_decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic sequence mixing (SSM / hybrid); every
    other cell runs."""
    if shape.kind == "long_decode":
        return cfg.supports_long_context
    return True


def cells(include_skipped: bool = False) -> Iterator[tuple[str, str, bool]]:
    """Yield (arch, shape, applicable) over ``ARCH_IDS`` x ``SHAPES``."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, sp in SHAPES.items():
            ok = shape_applicable(cfg, sp)
            if ok or include_skipped:
                yield arch, sname, ok
