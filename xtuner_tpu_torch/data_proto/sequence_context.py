"""SequenceContext, the batch protocol passed into models (counterpart:
`xtuner_tpu/data_proto/sequence_context.py`).

The text fields of a packed batch: `(B, L)` rows where `segment_ids`
numbers each token's document (0 = padding) and `position_ids` restart at
every document, the rollout-routing replay field,
`rollout_routed_experts`, and the VLM fields of the JAX class: Qwen3-VL's
(B, 3, L) `mrope_positions`, which a qwen3_vl rope reads
(`module/rope.py::model_rope_cos_sin`), the patch rows and the ViT
geometry the collator computes on the host (`vision_*`), and what
`model/qwen3_vl.py` hands the text model (`inputs_embeds`,
`deepstack_embeds`). `replace` returns a copy with some fields changed,
as `dataclasses.replace` (JAX's `seq_ctx.replace`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class SequenceContext:
    input_ids: torch.Tensor  # (B, L) packed token ids
    segment_ids: torch.Tensor  # (B, L) int32, 0 = padding, docs numbered from 1
    position_ids: torch.Tensor  # (B, L) restart per document
    # R3 replay: (B, L, nL_moe, K) expert ids per MoE layer; entries < 0
    # (prompt and padding positions) keep fresh routing
    rollout_routed_experts: Optional[torch.Tensor] = None
    # Qwen3-VL: (B, 3, L) int (t, h, w) positions; None for text-only batches
    mrope_positions: Optional[torch.Tensor] = None
    # --- VLM (None for text-only batches) ---
    pixel_values: Optional[torch.Tensor] = None  # (P, patch_dim) patch rows
    image_grid_thw: Optional[torch.Tensor] = None  # (n_images, 3)
    image_token_mask: Optional[torch.Tensor] = None  # (B, L) bool: positions given vision embeds
    inputs_embeds: Optional[torch.Tensor] = None  # (B, L, H): replaces the embedding lookup
    deepstack_embeds: Optional[torch.Tensor] = None  # (n_ds, B, L, H): added after layer i < n_ds
    vision_segment_ids: Optional[torch.Tensor] = None  # (P,) int32 per frame, 0 = pad patch
    vision_rot_pos: Optional[torch.Tensor] = None  # (P, 2) int32 (row, col) per patch
    vision_pos_interp_idx: Optional[torch.Tensor] = None  # (P, 4) int32 into pos_embed
    vision_pos_interp_w: Optional[torch.Tensor] = None  # (P, 4) f32 bilinear weights

    def replace(self, **changes) -> "SequenceContext":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_input_ids(cls, input_ids, pad_token_id: Optional[int] = None) -> "SequenceContext":
        """One document per row; padding inferred from pad_token_id (or none)."""
        input_ids = torch.as_tensor(input_ids, dtype=torch.int32)
        if input_ids.dim() == 1:
            input_ids = input_ids[None, :]
        if pad_token_id is None:
            segment_ids = torch.ones_like(input_ids)
        else:
            segment_ids = (input_ids != pad_token_id).to(torch.int32)
        position_ids = (torch.cumsum(segment_ids != 0, dim=-1) - 1).clamp(min=0).to(torch.int32)
        return cls(input_ids=input_ids, segment_ids=segment_ids, position_ids=position_ids)
