"""Multi-token prediction (counterpart: `xtuner_tpu/module/mtp.py`).

An MTP depth is one more decoder layer whose input fuses the trunk's
hidden state with the embedding of the next token,
`x_k = [RMSNorm(h); RMSNorm(E(t + k))] @ W_proj` (DeepSeek-V3, GLM-4.5),
and whose output predicts the token one further on through the shared
final norm and head. `model/moe.py::MoE._mtp_loss` runs the depths.
"""

from __future__ import annotations

import torch

from ..ops.rms_norm import rms_norm
from .params import ParamSpec


def mtp_extra_param_specs(hidden_size: int, init_scale: float = 0.02) -> dict:
    """Per-depth extras beside the decoder layer's params."""
    return {
        "proj": {"w": ParamSpec((2 * hidden_size, hidden_size), scale=init_scale)},
        "hidden_norm": ParamSpec((hidden_size,), init="ones"),
        "embed_norm": ParamSpec((hidden_size,), init="ones"),
    }


def mtp_fuse(extra: dict, h: torch.Tensor, next_embed: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """h, next_embed: (B, L, H) -> the fused (B, L, H) input of the MTP layer."""
    fused = torch.cat([rms_norm(h, extra["hidden_norm"], eps),
                       rms_norm(next_embed, extra["embed_norm"], eps)], dim=-1)
    return fused @ extra["proj"]["w"]


def shift_for_mtp(x: torch.Tensor, segment_ids: torch.Tensor, fill) -> torch.Tensor:
    """Shift (B, L) ids, labels or weights left by one position within
    documents: out[t] = x[t + 1] where segment[t + 1] == segment[t] != 0,
    else `fill`."""
    shifted = torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)
    seg_next = torch.cat([segment_ids[:, 1:], torch.zeros_like(segment_ids[:, :1])], dim=1)
    same_doc = (seg_next == segment_ids) & (segment_ids != 0)
    return torch.where(same_doc, shifted, torch.full_like(shifted, fill))
