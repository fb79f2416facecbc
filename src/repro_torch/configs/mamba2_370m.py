"""mamba2-370m — attention-free SSM (SSD). [arXiv:2405.21060]

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128, headdim=64, expand=2
(d_inner=2048, 32 SSM heads).  O(1) decode state makes this arch (with
zamba2) the long_500k-eligible family.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn="none",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
    ssm_chunk=128,
    tie_embeddings=True,
    microbatches=16,
)

REDUCED = CONFIG.replace(
    microbatches=1,
    name="mamba2-370m-reduced",
    n_layers=2,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
    max_seq=256,
)
