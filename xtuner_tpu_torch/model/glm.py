"""GLM-4.5 / GLM-5.2 MoE presets (counterpart: `xtuner_tpu/model/glm.py`).

The public geometries, field for field as in JAX: first-k dense layers, a
shared expert, the sigmoid noaux router with routed scaling, an MTP head;
GLM-5.2 with DSA sparse-MLA attention (`module/dsa.py`), the JAX default
`select_granularity` "token" kept.

Both build as MoE models (the noaux router, MTP; GLM-5.2's DSA in the
dense and MoE layers). GLM-4.5-Air's dense layer and first MoE layer train
at full width through `recipes/sft_glm45_air_head.py`; a GLM-5.2 MoE
layer (9.7 B params) waits for [parallelism], and its three dense head
layers train on their own through a `DenseConfig` built from `glm_52()`'s
fields (`recipes/sft_glm52_dsa_head.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..module.attention import MHAConfig
from ..module.dsa import DSAConfig
from ..module.router import NoAuxRouterConfig
from .moe import MoEConfig


@dataclass
class GLMConfig(MoEConfig):
    model_type: Optional[str] = "glm_moe"


def glm_45_air() -> GLMConfig:
    return GLMConfig(
        vocab_size=151552,
        max_position_embeddings=131072,
        eos_token_id=151329,
        num_hidden_layers=46,
        first_k_dense_replace=1,
        hidden_size=4096,
        intermediate_size=10944,
        moe_intermediate_size=1408,
        n_routed_experts=128,
        num_experts_per_tok=8,
        n_shared_experts=1,
        rms_norm_eps=1e-5,
        hidden_act="silu",
        rope_theta=1000000.0,
        mtp_num_layers=1,
        router=NoAuxRouterConfig(scoring_func="sigmoid", norm_topk_prob=True,
                                 routed_scaling_factor=1.0, n_group=1, topk_group=1),
        attention=MHAConfig(
            num_attention_heads=96,
            num_key_value_heads=8,
            head_dim=128,
            qkv_bias=True,
            qk_norm=False,
        ),
    )


def glm_52() -> GLMConfig:
    """GLM-5.2: DSA sparse-MLA attention (lightning indexer, top-k 2048),
    noaux sigmoid router with 2.5x routed scaling, 3 dense head layers, 256
    experts top-8 plus a shared expert, MTP."""
    return GLMConfig(
        model_type="glm_moe_dsa",
        vocab_size=154880,
        max_position_embeddings=1048576,
        pad_token_id=154820,
        eos_token_id=154820,
        num_hidden_layers=78,
        first_k_dense_replace=3,
        hidden_size=6144,
        intermediate_size=12288,
        moe_intermediate_size=2048,
        n_routed_experts=256,
        num_experts_per_tok=8,
        n_shared_experts=1,
        rms_norm_eps=1e-5,
        hidden_act="silu",
        rope_theta=8000000.0,
        mtp_num_layers=1,
        router=NoAuxRouterConfig(scoring_func="sigmoid", norm_topk_prob=True,
                                 routed_scaling_factor=2.5, n_group=1, topk_group=1),
        attention=DSAConfig(
            num_attention_heads=64,
            q_lora_rank=2048,
            kv_lora_rank=512,
            qk_nope_head_dim=192,
            qk_rope_head_dim=64,
            v_head_dim=256,
            index_n_heads=32,
            index_head_dim=128,
            index_top_k=2048,
        ),
    )
