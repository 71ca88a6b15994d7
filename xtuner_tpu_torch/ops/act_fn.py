"""Activation functions (counterpart: `xtuner_tpu/ops/act_fn.py`).

`silu` is the activation of every dense and MoE preset ported so far, and
`swiglu_clipped` gpt-oss's experts' gated activation. The other names of
the JAX registry raise and name their ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import not_ported

_ACT2FN = {"silu": F.silu}


def get_act_fn(name: str):
    if name not in _ACT2FN:
        raise not_ported(f"activation {name!r}", "leaf-ops")
    return _ACT2FN[name]


def swiglu_clipped(gate: torch.Tensor, up: torch.Tensor, alpha: float = 1.702,
                   limit: float = 7.0) -> torch.Tensor:
    """GPT-OSS's clipped swiglu (JAX `swiglu_clipped`): gate clipped above
    at `limit`, up to [-limit, limit], (up + 1) * gate * sigmoid(alpha *
    gate). The callers pass f32."""
    gate = gate.clamp(max=limit)
    up = up.clamp(min=-limit, max=limit)
    return (up + 1) * (gate * torch.sigmoid(gate * alpha))


def gated_act(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """The expert MLP's hidden from gate and up: `swiglu_clipped` for
    "swiglu_clipped", else act(gate) * up."""
    if act == "swiglu_clipped":
        return swiglu_clipped(gate, up)
    return get_act_fn(act)(gate) * up
