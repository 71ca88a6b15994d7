"""SequenceContext, the batch protocol passed into models (counterpart:
`xtuner_tpu/data_proto/sequence_context.py`).

The text fields of a packed batch: `(B, L)` rows where `segment_ids`
numbers each token's document (0 = padding) and `position_ids` restart at
every document, and the rollout-routing replay field,
`rollout_routed_experts`. The VLM and deepstack fields of the JAX class
are not ported yet ([moe], Queue 1 VLM).
"""

from __future__ import annotations

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
