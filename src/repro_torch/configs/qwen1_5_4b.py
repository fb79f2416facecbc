"""qwen1.5-4b — dense with QKV bias. [hf:Qwen/Qwen1.5-4B]

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.

20 heads is not divisible by the 16-way model axis; head/kv dims rely on
GSPMD uneven (padded) sharding — verified by the dry-run.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    mlp="swiglu",
    attn="gqa",
    qkv_bias=True,
    microbatches=16,
    # 20 heads don't divide the 16-way model axis -> sequence parallelism,
    # as in the JAX package (the port's meshes: launch/mesh.py; a serving
    # prefill keeps q's sequence shard: kernels/ops.py)
    sharding_overrides={"seq": "model"},
)

REDUCED = CONFIG.replace(
    microbatches=1,
    sharding_overrides=None,
    name="qwen1.5-4b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    max_seq=256,
)
