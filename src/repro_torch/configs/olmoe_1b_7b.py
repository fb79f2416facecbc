"""olmoe-1b-7b — MoE, 64 experts top-8. [arXiv:2409.02060; hf]

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304.

64 experts shard 4-per-chip over the 16-way model axis (expert parallelism);
each expert's tiny d_ff=1024 stays unsharded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    mlp="swiglu",
    attn="gqa",
    n_experts=64,
    top_k=8,
    # kv=16 divides the 16-way model axis exactly -> head-sharded KV cache
    # beats the default seq-sharded cache (no softmax-stat combine needed)
    sharding_overrides={"cache_kv_heads": "model", "cache_seq": None},
    uniform_decode=True,  # cache seq unsharded -> scalar-DUS append is in-place (C2)
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="olmoe-1b-7b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    n_experts=8,
    top_k=2,
    max_seq=256,
)
