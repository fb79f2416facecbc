"""qwen2.5-72b — the paper's large evaluation model (TP=4 per instance)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mlp="swiglu",
    attn="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="qwen2.5-72b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    max_seq=256,
)
