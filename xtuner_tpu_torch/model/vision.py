"""Vision-tower helpers (counterpart: `xtuner_tpu/model/vision.py`).

`layer_norm`, the LayerNorm of Qwen3-VL's vision blocks and mergers
(`model/qwen3_vl.py`). InternVL's ViT (`vit_forward`) and its projector
are not ported yet ([vlm]).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim as JAX's: f32 mean and population
    variance, times rsqrt(var + eps), then the affine in f32, cast back to
    x's dtype (`F.layer_norm` on f32: the same function in one pass)."""
    return F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(), eps).to(x.dtype)
