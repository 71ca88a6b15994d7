"""Activation functions (counterpart: `xtuner_tpu/ops/act_fn.py`).

`silu` is the activation of every dense and MoE preset ported so far,
`swiglu_clipped` gpt-oss's experts' gated activation, and
`gelu_pytorch_tanh` Qwen3-VL's vision MLP's. `gelu` is JAX's registry
entry, `jax.nn.gelu` with its default `approximate=True`: the tanh form,
not HF's exact erf one (ROADMAP.md, known faults in the reference).
Qwen3-VL's mergers call the exact form themselves (`gelu_exact`), as
JAX's `_merger_forward` does. "relu" and "quick_gelu" raise and name
their ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import not_ported



def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True), HF's gelu_pytorch_tanh."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=False): x Phi(x) with erf."""
    return F.gelu(x)


# JAX's "gelu" is jax.nn.gelu's default, the tanh form
_ACT2FN = {"silu": F.silu, "gelu": gelu_tanh, "gelu_pytorch_tanh": gelu_tanh}


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
