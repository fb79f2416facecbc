"""whisper-large-v3 — encoder-decoder audio backbone. [arXiv:2212.04356]

32L (decoder; +32 encoder) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.

As in the JAX package the conv/audio frontend is a stub: the caller passes
1500 precomputed frame embeddings (30 s at 50 fps), which the encoder stack
consumes; decoder layers cross-attend to the encoder output.  Positions use
RoPE rather than whisper's learned absolute embeddings, as in the JAX
package.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp="gelu",
    attn="gqa",
    frontend="audio_stub",
    n_frontend_tokens=1500,
    microbatches=16,
    sharding_overrides={"seq": "model"},
)

REDUCED = CONFIG.replace(
    microbatches=1,
    sharding_overrides=None,
    name="whisper-large-v3-reduced",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    n_frontend_tokens=8,
    max_seq=256,
)
