"""llama3-8b — the paper's small evaluation model (Table 'models')."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    mlp="swiglu",
    attn="gqa",
    rope_theta=500_000.0,
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="llama3-8b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    max_seq=256,
)
