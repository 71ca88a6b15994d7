"""Base model config and outputs (counterpart: `xtuner_tpu/model/base.py`).

The config fields the serving and training slices read, with the JAX
package's names and defaults, as a dataclass (the machine with the card has
no pydantic). `attention` is an `MHAConfig` or an `MLAConfig` (DSA's
`module/dsa.py::DSAConfig` is one); `float8_cfg` takes an
`ops/float8.py::Float8Config`; `lora_cfg` exists so configs translate, and a model built with it raises
([lora]).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..loss.ce_loss import CELossConfig
from ..module.attention import MHAConfig
from ..module.mla import MLAConfig


@dataclass
class ModelOutputs:
    """What `loss()` returns; the engine sums every `*loss*` field, in
    JAX's field order. JAX's `hidden_states` field comes with the feature
    that reads it."""

    loss: Optional[torch.Tensor] = None
    sum_ce: Optional[torch.Tensor] = None
    num_tokens: Optional[torch.Tensor] = None
    balancing_loss: Optional[torch.Tensor] = None
    z_loss: Optional[torch.Tensor] = None
    # multi-token prediction: mtp_loss_coef x the mean CE over the depths
    mtp_loss: Optional[torch.Tensor] = None
    # DSA lightning-indexer distillation (the indexer's only gradient path),
    # summed into total_loss by name
    dsa_index_loss: Optional[torch.Tensor] = None
    # per-layer expert token counts (L_moe, E): read by the engine's noaux
    # bias update and maxvio metric; NOT a loss field
    expert_load: Optional[torch.Tensor] = None
    # the MTP layers' expert token counts (mtp depths, E), kept apart so the
    # engine can update the mtp_layers router stack (summing the depths
    # when they share one layer)
    mtp_expert_load: Optional[torch.Tensor] = None

    def total_loss(self):
        total = 0.0
        for f in dataclasses.fields(self):
            if "loss" in f.name:
                v = getattr(self, f.name)
                if v is not None:
                    total = total + v
        return total


@dataclass
class TransformerConfig:
    vocab_size: int
    num_hidden_layers: int
    hidden_size: int
    intermediate_size: int
    attention: MHAConfig | MLAConfig
    max_position_embeddings: int = 32768
    eos_token_id: int = 0
    pad_token_id: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rms_norm_type: str = "default"  # default | zero_centered
    hidden_act: str = "silu"
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    model_type: Optional[str] = None
    use_sliding_window: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling_cfg: Optional[Any] = None
    lm_loss_cfg: CELossConfig = field(default_factory=CELossConfig)
    init_scale: float = 0.02
    lora_cfg: Optional[Any] = None
    float8_cfg: Optional[Any] = None
    # DSA lightning-indexer distillation weight (read only when attention is
    # a DSAConfig)
    dsa_index_loss_coef: float = 1.0

    def build(self):
        raise NotImplementedError

    @property
    def head_dim(self) -> int:
        return self.attention.head_dim
