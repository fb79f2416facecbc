"""pixtral-12b — VLM: pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.

As in the JAX package the ViT frontend is a stub: the caller passes
precomputed patch embeddings (B, n_frontend_tokens, d_model) that overwrite
the first token positions.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    mlp="swiglu",
    attn="gqa",
    rope_theta=1_000_000_000.0,
    frontend="patch_stub",
    n_frontend_tokens=1024,
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="pixtral-12b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    n_frontend_tokens=8,
    max_seq=256,
)
