"""minicpm3-4b — dense with MLA (multi-head latent attention).
[hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA ranks per the HF config: q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32,
v_head 64.  The decode path uses the absorbed form so the per-token cache is
(kv_lora_rank + rope_dim) = 288 values — ~18x smaller than GQA at the same
width, which is why decode scaling pressure is low for this arch (§6.1 of the
paper applies more strongly).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    mlp="swiglu",
    attn="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    microbatches=16,
    # 40 heads don't divide the 16-way model axis -> sequence parallelism,
    # as in the JAX package (the port's meshes: launch/mesh.py; a serving
    # prefill keeps q's sequence shard: kernels/ops.py)
    sharding_overrides={"seq": "model"},
)

REDUCED = CONFIG.replace(
    sharding_overrides=None,
    microbatches=1,
    name="minicpm3-4b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    max_seq=256,
)
