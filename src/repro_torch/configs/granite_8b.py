"""granite-8b — dense llama-arch code model. [arXiv:2405.04324; hf]

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    mlp="swiglu",
    attn="gqa",
    rope_theta=10_000_000.0,
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="granite-8b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    max_seq=256,
)
