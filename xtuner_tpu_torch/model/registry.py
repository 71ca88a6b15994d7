"""Model registry: name -> config factory (counterpart:
`xtuner_tpu/model/registry.py`).

The Qwen3 dense and Qwen3-MoE names, and "glm-5.2" (its MoE model raises
[moe] when built; `recipes/sft_glm52_dsa_head.py` trains its dense head).
Qwen2, the other MoE families, VLM and hybrid presets and loading an HF
checkpoint directory are not ported yet (ROADMAP items [moe], [serve-rest]).
"""

from __future__ import annotations

from typing import Callable

from .. import not_ported
from . import glm, moe, qwen

model_mapping: dict[str, Callable] = {
    "qwen3-0-6b": qwen.qwen3_0_6b,
    "qwen3-4b": qwen.qwen3_4b,
    "qwen3-8b": qwen.qwen3_8b,
    "qwen3-moe-30b-a3": moe.qwen3_moe_30b_a3,
    "qwen3-moe-235b-a22": moe.qwen3_moe_235b_a22,
    "glm-5.2": glm.glm_52,
}


def get_model_config(name: str):
    """Resolve a registry name to a model config."""
    if name in model_mapping:
        return model_mapping[name]()
    raise not_ported(f"model {name!r} (known: {sorted(model_mapping)})", "serve-rest")
