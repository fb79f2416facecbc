"""mistral-24b — the paper's medium evaluation model (Mistral-Small-24B)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-24b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    mlp="swiglu",
    attn="gqa",
    rope_theta=100_000_000.0,
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="mistral-24b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    max_seq=256,
)
