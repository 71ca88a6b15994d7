"""MoE expert MLP and its dispatch pipeline (counterpart:
`xtuner_tpu/module/moe_layer.py`).

`moe_mlp_forward` follows the JAX package's grouped-GEMM branch
(`moe_layer.py:95-129`): route, permute rows by expert, one grouped GEMM on
gate|up concatenated into (E, H, 2F), silu(gate) * up in f32, one grouped
GEMM on down, weighted combine. The grouped GEMMs are
`ops/bf16_grouped.py::bf16_grouped_linear`: the Hopper kernels on a card,
their plain versions on the CPU.

With `fp8_cfg` enabled it follows JAX's fp8 branch (`moe_layer.py:130-154`):
gate, up and down are three `ops/fp8_grouped.py::fp8_grouped_linear` calls
(TPU kernels #12 and #13). gate and up stay two calls, not one on the
fused (E, H, 2F) weight: the wgrad quantises g with one scale per 128-row
tile over all its columns, so a fused (M, 2F) gradient would get other
scales than two (M, F) ones.

Not ported yet: the a2a and agrs dispatchers and expert parallelism
(Queue 1, parallelism), the fused MoE-MLP kernel (`XTUNER_FUSED_MLP`, TPU
kernel #16) and `swiglu_clipped` ([leaf-ops]).
"""

from __future__ import annotations

import os

import torch

from .. import not_ported
from ..ops.act_fn import get_act_fn
from ..ops.bf16_grouped import bf16_grouped_linear
from ..ops.float8 import fp8_enabled
from ..ops.fp8_grouped import fp8_grouped_linear
from ..ops.moe import permute, unpermute
from .params import ParamSpec
from .router import RouterConfig, RouterOutput, route


def expert_mlp_param_specs(hidden_size: int, moe_intermediate_size: int,
                           num_experts: int, init_scale: float = 0.02) -> dict:
    e, h, f = num_experts, hidden_size, moe_intermediate_size
    return {
        "gate_proj": ParamSpec((e, h, f), scale=init_scale),
        "up_proj": ParamSpec((e, h, f), scale=init_scale),
        "down_proj": ParamSpec((e, f, h), scale=init_scale),
    }


def moe_mlp_forward(p: dict, router_p: dict, router_cfg: RouterConfig, x: torch.Tensor,
                    *, num_experts: int, top_k: int, act: str = "silu",
                    compute_dtype=torch.bfloat16, dispatcher: str = "gspmd",
                    forced_topk_idx=None, fp8_cfg=None):
    """x: (B, L, H) -> (out (B, L, H), RouterOutput, expert_load (E,) int32).
    Dropless: every routed token is computed."""
    if dispatcher != "gspmd":
        raise not_ported(f"the {dispatcher!r} MoE dispatcher", "parallelism")
    if os.environ.get("XTUNER_FUSED_MLP", "0") != "0":
        raise not_ported("the fused MoE-MLP kernel (XTUNER_FUSED_MLP, TPU kernel #16)",
                         "train-slice")
    if act == "swiglu_clipped":
        raise not_ported("swiglu_clipped experts", "leaf-ops")
    b, l, h = x.shape
    x2d = x.reshape(b * l, h)
    r: RouterOutput = route(router_p, router_cfg, x2d, top_k, forced_idx=forced_topk_idx)
    info = permute(x2d.to(compute_dtype), r.topk_idx, num_experts,
                   topk_weights=r.topk_weights)
    if fp8_enabled(fp8_cfg):
        e5m2 = getattr(fp8_cfg, "e5m2_grads", False)

        def gg(x_, w_):
            return fp8_grouped_linear(x_, w_.to(compute_dtype), info.group_sizes, e5m2)

        gate = gg(info.sorted_tokens, p["gate_proj"]).float()
        up = gg(info.sorted_tokens, p["up_proj"]).float()
        hidden = (get_act_fn(act)(gate) * up).to(compute_dtype)
        out = gg(hidden, p["down_proj"])
        combined = unpermute(out, info, b * l)
        return combined.reshape(b, l, h).to(compute_dtype), r, info.group_sizes
    f = p["gate_proj"].shape[2]
    w_cat = torch.cat([p["gate_proj"].to(compute_dtype), p["up_proj"].to(compute_dtype)],
                      dim=2)
    gu = bf16_grouped_linear(info.sorted_tokens, w_cat, info.group_sizes)
    gate, up = gu[:, :f].float(), gu[:, f:].float()
    hidden = (get_act_fn(act)(gate) * up).to(compute_dtype)
    out = bf16_grouped_linear(hidden, p["down_proj"].to(compute_dtype), info.group_sizes)
    combined = unpermute(out, info, b * l)
    return combined.reshape(b, l, h).to(compute_dtype), r, info.group_sizes
