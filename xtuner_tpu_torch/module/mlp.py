"""Gated MLP (SwiGLU) (counterpart: `xtuner_tpu/module/mlp.py`)."""

from __future__ import annotations

import torch

from ..ops.act_fn import get_act_fn
from ..ops.float8 import fp8_enabled, fp8_matmul
from .params import ParamSpec


def linear(x: torch.Tensor, p: dict, fp8_cfg=None) -> torch.Tensor:
    """`x @ w (+ b)` with w in the JAX (in, out) layout: the non-LoRA
    branches of `xtuner_tpu/module/lora.py::lora_linear`, the product in
    fp8 (`ops/float8.py::fp8_matmul`) when `fp8_cfg` is enabled."""
    if fp8_enabled(fp8_cfg):
        y = fp8_matmul(x, p["w"], fp8_cfg.scaling_granularity, fp8_cfg.tile,
                       getattr(fp8_cfg, "e5m2_grads", False))
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_param_specs(hidden_size: int, intermediate_size: int,
                    init_scale: float = 0.02, bias: bool = False) -> dict:
    specs = {
        "gate_proj": {"w": ParamSpec((hidden_size, intermediate_size), scale=init_scale)},
        "up_proj": {"w": ParamSpec((hidden_size, intermediate_size), scale=init_scale)},
        "down_proj": {"w": ParamSpec((intermediate_size, hidden_size), scale=init_scale)},
    }
    if bias:
        specs["gate_proj"]["b"] = ParamSpec((intermediate_size,), init="zeros")
        specs["up_proj"]["b"] = ParamSpec((intermediate_size,), init="zeros")
        specs["down_proj"]["b"] = ParamSpec((hidden_size,), init="zeros")
    return specs


def mlp_forward(p: dict, x: torch.Tensor, act: str = "silu", fp8_cfg=None) -> torch.Tensor:
    gate = linear(x, p["gate_proj"], fp8_cfg)
    up = linear(x, p["up_proj"], fp8_cfg)
    return linear(get_act_fn(act)(gate) * up, p["down_proj"], fp8_cfg)
