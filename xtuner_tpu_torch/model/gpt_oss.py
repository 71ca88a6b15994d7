"""GPT-OSS presets (counterpart: `xtuner_tpu/model/gpt_oss.py`).

MoE with per-head attention sinks, qkv and o biases, head dim 64, clipped
swiglu experts (`ops/act_fn.py::swiglu_clipped`) and a window pattern that
alternates a sliding window of 128 (even layers) with full attention (odd
layers). The values are JAX's, field for field.

gpt-oss-20b is served whole on one card (`model/paged_generate.py`: the
flash forward and the paged decode with the window and the sinks, with
`record_routing`). It trains on one card at full width, cut to its first
two layers (`recipes/sft_gpt_oss_20b_head.py`: the flash forward and the
split backward kernels at head dim 64 with the window, the sinks'
gradient, the clipped experts on the grouped GEMMs), and it trains on a
recorded routing (`SequenceContext.rollout_routed_experts`, replayed
under the window pattern, which JAX drops: `model/moe.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from ..module.attention import MHAConfig
from ..module.router import GreedyRouterConfig
from .moe import MoEConfig


@dataclass
class GptOssConfig(MoEConfig):
    model_type: Optional[str] = "gpt_oss"


def gpt_oss_20b() -> GptOssConfig:
    return GptOssConfig(
        vocab_size=201088,
        max_position_embeddings=131072,
        eos_token_id=200002,
        num_hidden_layers=24,
        hidden_size=2880,
        intermediate_size=2880,
        moe_intermediate_size=2880,
        n_routed_experts=32,
        num_experts_per_tok=4,
        hidden_act="swiglu_clipped",
        rms_norm_eps=1e-5,
        rope_theta=150000.0,
        layer_window_pattern=[128, None],  # even layers sliding-128, odd full
        router=GreedyRouterConfig(scoring_func="softmax", norm_topk_prob=True),
        attention=MHAConfig(
            num_attention_heads=64,
            num_key_value_heads=8,
            head_dim=64,
            with_sinks=True,
            qkv_bias=True,
            o_bias=True,
        ),
    )


def gpt_oss_120b() -> GptOssConfig:
    return dataclasses.replace(gpt_oss_20b(), num_hidden_layers=36, n_routed_experts=128)


def gpt_oss_tiny(**kw) -> GptOssConfig:
    defaults = dict(
        vocab_size=128,
        eos_token_id=1,
        num_hidden_layers=4,
        hidden_size=32,
        intermediate_size=32,
        moe_intermediate_size=16,
        n_routed_experts=4,
        num_experts_per_tok=2,
        hidden_act="swiglu_clipped",
        layer_window_pattern=[8, None],
        attention=MHAConfig(num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                            with_sinks=True, qkv_bias=True, o_bias=True),
    )
    defaults.update(kw)
    return GptOssConfig(**defaults)
