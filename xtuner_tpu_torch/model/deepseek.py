"""DeepSeek-V3 preset: MLA, the noaux router, shared experts (counterpart:
`xtuner_tpu/model/deepseek.py`).

`DeepSeekV3Config`, the public geometry (`deepseek_v3`), its test-scale
twin (`deepseek_v3_tiny`) and `deepseek_config_from_hf`, which takes any
object with a transformers `DeepseekV3Config`'s attributes, field for field
as in JAX: MLA attention with 128 heads (q_lora 1536, kv_lora 512, q/k
dim 128 + 64, v dim 128) and yarn rope (factor 40 over 4096 positions).

Both build as MoE models: MLA in the dense and MoE layers, the noaux
router with 8 groups (top-4 kept) and routed scaling 2.5, a shared expert
and one MTP layer; `deepseek_v3_tiny` is held to JAX on the CPU. One
DeepSeek-V3 MoE layer (11.3 B params) does not fit one card beside its
optimizer state ([parallelism]); the three dense head layers train on
their own through a `DenseConfig` built from `deepseek_v3()`'s fields
(`recipes/sft_deepseek_v3_mla_head.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..module.mla import MLAConfig
from ..module.rope import RopeScalingConfig
from ..module.router import NoAuxRouterConfig
from .moe import MoEConfig


@dataclass
class DeepSeekV3Config(MoEConfig):
    model_type: Optional[str] = "deepseek_v3"


def deepseek_v3() -> DeepSeekV3Config:
    return DeepSeekV3Config(
        vocab_size=129280,
        max_position_embeddings=163840,
        eos_token_id=1,
        num_hidden_layers=61,
        first_k_dense_replace=3,
        hidden_size=7168,
        intermediate_size=18432,  # dense-layer MLP width
        moe_intermediate_size=2048,
        n_routed_experts=256,
        num_experts_per_tok=8,
        n_shared_experts=1,
        rms_norm_eps=1e-6,
        hidden_act="silu",
        rope_theta=10000.0,
        rope_scaling_cfg=RopeScalingConfig(
            rope_type="yarn", factor=40.0, beta_fast=32.0, beta_slow=1.0,
            mscale=1.0, mscale_all_dim=1.0, original_max_position_embeddings=4096,
        ),
        mtp_num_layers=1,
        router=NoAuxRouterConfig(
            scoring_func="sigmoid", norm_topk_prob=True, routed_scaling_factor=2.5,
            n_group=8, topk_group=4,
        ),
        attention=MLAConfig(
            num_attention_heads=128,
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
    )


def deepseek_config_from_hf(hf_cfg) -> DeepSeekV3Config:
    """Build from a transformers DeepseekV3Config, or any object with its
    attributes (JAX `deepseek_config_from_hf`)."""
    rope_scaling = None
    rs = getattr(hf_cfg, "rope_scaling", None)
    if rs:
        rope_scaling = RopeScalingConfig(
            rope_type=rs.get("rope_type", rs.get("type", "yarn")),
            factor=rs.get("factor", 1.0),
            beta_fast=rs.get("beta_fast", 32.0),
            beta_slow=rs.get("beta_slow", 1.0),
            mscale=rs.get("mscale", 1.0),
            mscale_all_dim=rs.get("mscale_all_dim", 0.0),
            original_max_position_embeddings=rs.get("original_max_position_embeddings", 4096),
        )
    return DeepSeekV3Config(
        vocab_size=hf_cfg.vocab_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        eos_token_id=hf_cfg.eos_token_id or 1,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        first_k_dense_replace=hf_cfg.first_k_dense_replace,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        moe_intermediate_size=hf_cfg.moe_intermediate_size,
        n_routed_experts=hf_cfg.n_routed_experts,
        num_experts_per_tok=hf_cfg.num_experts_per_tok,
        n_shared_experts=hf_cfg.n_shared_experts,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        hidden_act=hf_cfg.hidden_act,
        rope_theta=hf_cfg.rope_theta,
        rope_scaling_cfg=rope_scaling,
        tie_word_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        router=NoAuxRouterConfig(
            scoring_func="sigmoid",
            norm_topk_prob=hf_cfg.norm_topk_prob,
            routed_scaling_factor=hf_cfg.routed_scaling_factor,
            n_group=hf_cfg.n_group,
            topk_group=hf_cfg.topk_group,
        ),
        attention=MLAConfig(
            num_attention_heads=hf_cfg.num_attention_heads,
            q_lora_rank=hf_cfg.q_lora_rank,
            kv_lora_rank=hf_cfg.kv_lora_rank,
            qk_nope_head_dim=hf_cfg.qk_nope_head_dim,
            qk_rope_head_dim=hf_cfg.qk_rope_head_dim,
            v_head_dim=hf_cfg.v_head_dim,
            rms_norm_eps=hf_cfg.rms_norm_eps,
        ),
    )


def deepseek_v3_tiny(**kw) -> DeepSeekV3Config:
    """Test-scale variant preserving every structural feature."""
    defaults = dict(
        vocab_size=128,
        max_position_embeddings=512,
        eos_token_id=1,
        num_hidden_layers=3,
        first_k_dense_replace=1,
        hidden_size=32,
        intermediate_size=64,
        moe_intermediate_size=16,
        n_routed_experts=8,
        num_experts_per_tok=2,
        n_shared_experts=1,
        router=NoAuxRouterConfig(scoring_func="sigmoid", n_group=2, topk_group=1,
                                 routed_scaling_factor=2.5),
        attention=MLAConfig(
            num_attention_heads=2,
            q_lora_rank=16,
            kv_lora_rank=8,
            qk_nope_head_dim=8,
            qk_rope_head_dim=4,
            v_head_dim=8,
        ),
    )
    defaults.update(kw)
    return DeepSeekV3Config(**defaults)
