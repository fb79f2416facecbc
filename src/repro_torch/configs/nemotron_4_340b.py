"""nemotron-4-340b — dense GQA with squared-ReLU MLP. [arXiv:2402.16819]

96L d_model=18432 96H (GQA kv=8, head dim 192, n_rep 12) d_ff=73728
vocab=256000.  Fields as the JAX package's config, its FSDP sharding
override included.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp="relu2",  # squared-ReLU, non-gated
    attn="gqa",
    sharding_overrides={"d_model": ("data",)},
    microbatches=32,
)

REDUCED = CONFIG.replace(
    name="nemotron-4-340b-reduced",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=256,
    max_seq=256,
    sharding_overrides=None,
    microbatches=1,
)
