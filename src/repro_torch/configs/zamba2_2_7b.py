"""zamba2-2.7b — hybrid: Mamba2 backbone + one shared attention block.
[arXiv:2411.15242; hf]

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.

The shared attention+MLP block is a single parameter set invoked after every
``attn_every``-th Mamba2 layer (9 sites).  For BlitzScale this is the most
live-scaling-friendly arch: multicasting that one block unlocks 9 execution
sites at once.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    mlp="swiglu",
    attn="gqa",
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
    ssm_chunk=128,
    attn_every=6,
    # kv=32 divides the 16-way model axis -> head-sharded shared-attn cache
    sharding_overrides={"cache_kv_heads": "model", "cache_seq": None},
    uniform_decode=True,  # cache seq unsharded -> scalar-DUS append is in-place (C2)
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="zamba2-2.7b-reduced",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
    attn_every=2,
    max_seq=256,
)
