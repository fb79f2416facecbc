"""grok-1-314b — MoE, 8 experts top-2. [hf:xai-org/grok-1]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072; SwiGLU experts,
GShard dispatch in groups of 512 tokens.  Fields as the JAX package's
config, its sharding overrides included.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    mlp="swiglu",
    attn="gqa",
    n_experts=8,
    top_k=2,
    sharding_overrides={"experts": None, "d_model": ("data",)},
    # small dispatch groups keep the (G, S, E, C) one-hot tensors small
    moe_group_size=512,
    microbatches=32,
)

REDUCED = CONFIG.replace(
    name="grok-1-314b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    top_k=2,
    sharding_overrides=None,
    microbatches=1,
    max_seq=256,
)
