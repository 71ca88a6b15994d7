"""Model registry: name -> config factory (counterpart:
`xtuner_tpu/model/registry.py`).

The Qwen3 dense and Qwen3-MoE names, "glm-4.5-air", "glm-5.2",
"deepseek-v3", "gpt-oss-20b", "gpt-oss-120b", the hybrid
"qwen3.5-moe-35b-a3b" and the four Qwen3-VL presets
(`recipes/sft_glm45_air_head.py` trains GLM-4.5-Air's dense layer and
first MoE layer; `recipes/sft_glm52_dsa_head.py` and
`recipes/sft_deepseek_v3_mla_head.py` the other two's dense heads;
`PagedGenerator` serves gpt-oss-20b and Qwen3.5-35B-A3B whole;
`recipes/sft_qwen3_vl_4b.py` trains "qwen3-vl-4b" whole). Qwen2, the
other MoE families, InternVL and loading an HF checkpoint directory are
not ported yet (ROADMAP items [moe], [vlm], [serve-rest]).
"""

from __future__ import annotations

from typing import Callable

from .. import not_ported
from . import deepseek, glm, gpt_oss, hybrid, moe, qwen, qwen3_vl

model_mapping: dict[str, Callable] = {
    "qwen3-0-6b": qwen.qwen3_0_6b,
    "qwen3-4b": qwen.qwen3_4b,
    "qwen3-8b": qwen.qwen3_8b,
    "qwen3-moe-30b-a3": moe.qwen3_moe_30b_a3,
    "qwen3-moe-235b-a22": moe.qwen3_moe_235b_a22,
    "glm-4.5-air": glm.glm_45_air,
    "glm-5.2": glm.glm_52,
    "deepseek-v3": deepseek.deepseek_v3,
    "gpt-oss-20b": gpt_oss.gpt_oss_20b,
    "gpt-oss-120b": gpt_oss.gpt_oss_120b,
    "qwen3.5-moe-35b-a3b": hybrid.qwen3_5_moe_35b_a3b,
    "qwen3-vl-4b": qwen3_vl.qwen3_vl_4b,
    "qwen3-vl-8b": qwen3_vl.qwen3_vl_8b,
    "qwen3-vl-moe-30b-a3": qwen3_vl.qwen3_vl_moe_30b_a3,
    "qwen3.5-vl-35b-a3b": qwen3_vl.qwen3_5_vl_35b_a3b,
}


def get_model_config(name: str):
    """Resolve a registry name to a model config."""
    if name in model_mapping:
        return model_mapping[name]()
    raise not_ported(f"model {name!r} (known: {sorted(model_mapping)})", "serve-rest")
