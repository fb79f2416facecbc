"""Unified model configuration (the port's copy of ``repro.models.config``).

Same fields, defaults and derived properties as the JAX dataclass; only
``dtype`` is a torch dtype.  The parity tests check that the per-arch
configs agree field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None
    mlp: str = "swiglu"  # 'swiglu' | 'relu2' | 'gelu'
    attn: str = "gqa"  # 'gqa' | 'mla' | 'none'
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group_size: int = 4096

    # --- MLA -----------------------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 128

    # --- hybrid (zamba2) ----------------------------------------------------
    attn_every: int = 0

    # --- enc-dec (whisper) --------------------------------------------------
    n_enc_layers: int = 0

    # --- modality frontend --------------------------------------------------
    frontend: str = "none"  # 'none' | 'audio_stub' | 'patch_stub'
    n_frontend_tokens: int = 0

    max_seq: int = 131_072
    dtype: Any = torch.bfloat16
    # lockstep cache appends (one write at the batch's max length): a layout
    # choice of the TPU mesh; a direct decode_step honours it, the engine
    # clears it and appends per row.
    uniform_decode: bool = False
    # int8 KV cache with per-token f32 scales (kvcache.init_kv_cache)
    kv_quant: bool = False

    sharding_overrides: Mapping[str, Any] | None = None
    remat: bool = True
    microbatches: int = 1

    # ------------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 512; the tail is masked in argmax."""
        return -(-self.vocab_size // 512) * 512

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def gated_mlp(self) -> bool:
        return self.mlp == "swiglu"

    @property
    def mla_qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def approx_params(self) -> int:
        """Parameter count from the port's own template."""
        from repro_torch.models.layers import param_count
        from repro_torch.models.transformer import param_template

        return param_count(param_template(self))

    def approx_active_params(self) -> int:
        """Parameters active per token: a MoE counts its experts' leaves at
        top_k / n_experts (the reference's roofline MODEL_FLOPS count)."""
        total = self.approx_params()
        if self.n_experts and self.top_k:
            from repro_torch.models.layers import param_count
            from repro_torch.models.transformer import param_template

            expert = param_template(self)["layers"].get("moe")
            if expert is not None:
                e_count = param_count(expert)
                total = total - e_count + (e_count * self.top_k) // self.n_experts
        return total
