"""InternVL's compose model: vision tower + projector + language model
(counterpart: `xtuner_tpu/model/compose.py`).

One parameter tree {vision, projector, language}, JAX's. The forward
embeds the text tokens, runs the ViT over the micro-batch's tiles
(`model/vision.py::vit_forward`), projects them, and puts the k-th vision
token at the k-th image-context position, row-major over the batch (the
order `datasets/vlm.py::vlm_collator` stacks the tiles in); the language
model then takes `inputs_embeds` (`model/dense.py`, `model/moe.py`).

`param_labels` marks the parts the `freeze_*` flags name "freeze": the
engine gives those leaves no gradient and no update, and a frozen tower
on pixels records no autograd graph at all (`engine/train_engine.py`).
JAX gives the compose model no LoRA, so `merge_lora` is the identity.
`hf_key_map` is JAX's InternVL layout: `vision_tower.*`,
`multi_modal_projector.*` and `language_model.` before the text model's
keys; the patch embedding is a 2-D linear weight, and `cls_token` is absent
without `use_cls_token`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch

from ..checkpoint.spec import HFKey
from ..module.params import tree_map
from .dense import embed_tokens
from .vision import (ProjectorConfig, ViTConfig, projector_forward, projector_param_specs,
                     vit_forward, vit_param_specs)


@dataclass
class ComposeConfig:
    """JAX's ComposeConfig (InternVL / InternS1): a ViT, a text config and
    the id whose positions take the vision tokens."""

    text_cfg: Any
    image_context_token_id: int
    vision_cfg: ViTConfig = field(default_factory=ViTConfig)
    freeze_vision: bool = False
    freeze_language: bool = False
    freeze_projector: bool = False

    @property
    def projector_cfg(self) -> ProjectorConfig:
        s = int(1 / self.vision_cfg.downsample_ratio)
        return ProjectorConfig(in_dim=self.vision_cfg.hidden_size * s * s,
                               out_dim=self.text_cfg.hidden_size)

    @property
    def tokens_per_tile(self) -> int:
        return self.vision_cfg.tokens_per_tile

    # the engine's and trainer's view of a model config
    @property
    def lm_loss_cfg(self):
        return self.text_cfg.lm_loss_cfg

    @property
    def lora_cfg(self):
        return None

    @property
    def eos_token_id(self):
        return self.text_cfg.eos_token_id

    def build(self) -> "ComposeModel":
        return ComposeModel(self)


def _prefixed(tree, prefix: str):
    return tree_map(lambda k: dataclasses.replace(k, template=prefix + k.template), tree)


def vit_key_map(cfg: ViTConfig) -> dict:
    """The InternViT leaves' HF keys (JAX `ComposeModel.hf_key_map`)."""
    blk = "vision_tower.blocks.{layer}."

    def lin(name):
        return {"w": HFKey(blk + name + ".weight", "linear"), "b": HFKey(blk + name + ".bias")}

    def norm(name):
        return {"w": HFKey(blk + name + ".weight"), "b": HFKey(blk + name + ".bias")}

    vis = {
        "patch_embed": {"w": HFKey("vision_tower.patch_embed.weight", "linear"),
                        "b": HFKey("vision_tower.patch_embed.bias")},
        "pos_embed": HFKey("vision_tower.pos_embed"),
        "blocks": {"norm1": norm("norm1"), "attn": {"qkv": lin("attn.qkv"),
                                                    "proj": lin("attn.proj")},
                   "norm2": norm("norm2"), "mlp": {"fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
                   "ls1": HFKey(blk + "ls1"), "ls2": HFKey(blk + "ls2")},
    }
    if cfg.use_cls_token:
        vis["cls_token"] = HFKey("vision_tower.cls_token")
    return vis


class ComposeModel:
    def __init__(self, cfg: ComposeConfig):
        self.cfg = cfg
        self.language = cfg.text_cfg.build()

    def param_specs(self) -> dict:
        return {"vision": vit_param_specs(self.cfg.vision_cfg),
                "projector": projector_param_specs(self.cfg.projector_cfg),
                "language": self.language.param_specs()}

    def check_trainable(self) -> None:
        """The text model's refusals, and a tower whose heads split its width."""
        v = self.cfg.vision_cfg
        if v.head_dim * v.num_attention_heads != v.hidden_size:
            raise ValueError(f"vision hidden {v.hidden_size} is not {v.num_attention_heads} "
                             f"heads of {v.head_dim}")
        if hasattr(self.language, "check_trainable"):
            self.language.check_trainable()

    def vision_embeds(self, params, pixel_values: torch.Tensor, compute_dtype):
        """(T, 3, S, S) tiles -> (T tokens_per_tile, text hidden): the ViT,
        then the projector."""
        vis = vit_forward(params["vision"], self.cfg.vision_cfg, pixel_values, compute_dtype)
        vis = projector_forward(params["projector"], self.cfg.projector_cfg, vis, compute_dtype)
        return vis.reshape(-1, vis.shape[-1])

    def _fuse_vision(self, params, seq_ctx, compute_dtype) -> torch.Tensor:
        """The text embeddings with the vision tokens at the image-context
        positions: the k-th such position of the batch, row-major, takes the
        k-th vision token (JAX `_fuse_vision`; an index past the last
        vision token is clipped, as JAX's)."""
        embeds = embed_tokens(params["language"], seq_ctx.input_ids, compute_dtype)
        if seq_ctx.pixel_values is None:
            return embeds
        vis = self.vision_embeds(params, seq_ctx.pixel_values, compute_dtype)
        b, l = seq_ctx.input_ids.shape
        mask = (seq_ctx.input_ids == self.cfg.image_context_token_id).reshape(-1)
        dest = (torch.cumsum(mask.long(), 0) - 1).clamp(0, vis.shape[0] - 1)
        out = torch.where(mask[:, None], vis[dest], embeds.reshape(b * l, -1))
        return out.reshape(b, l, -1)

    def _language_ctx(self, params, seq_ctx, compute_dtype):
        self.check_trainable()
        embeds = self._fuse_vision(params, seq_ctx, compute_dtype)
        return seq_ctx.replace(inputs_embeds=embeds, pixel_values=None)

    def forward(self, params, seq_ctx, compute_dtype=torch.bfloat16, remat: str = "full"):
        lang_ctx = self._language_ctx(params, seq_ctx, compute_dtype)
        return self.language.forward(params["language"], lang_ctx, compute_dtype, remat)

    def lm_head_weight(self, params):
        return self.language.lm_head_weight(params["language"])

    def loss(self, params, seq_ctx, shifted_labels, loss_weights, global_denom,
             compute_dtype=torch.bfloat16, remat: str = "full"):
        lang_ctx = self._language_ctx(params, seq_ctx, compute_dtype)
        return self.language.loss(params["language"], lang_ctx, shifted_labels, loss_weights,
                                  global_denom, compute_dtype, remat)

    def param_labels(self, params_or_specs) -> dict:
        """"freeze" or "train" for every leaf, by part (JAX's labels)."""
        cfg = self.cfg
        frozen = {"vision": cfg.freeze_vision, "projector": cfg.freeze_projector,
                  "language": cfg.freeze_language}
        return {part: tree_map(lambda _, f=f: "freeze" if f else "train",
                               params_or_specs[part]) for part, f in frozen.items()}

    def merge_lora(self, params):
        return params

    def hf_key_map(self) -> dict:
        """InternVL's layout: the vision tower's and projector's keys, and
        the text model's under `language_model.`."""
        proj = {
            "norm": {"w": HFKey("multi_modal_projector.layer_norm.weight"),
                     "b": HFKey("multi_modal_projector.layer_norm.bias")},
            "fc1": {"w": HFKey("multi_modal_projector.linear_1.weight", "linear"),
                    "b": HFKey("multi_modal_projector.linear_1.bias")},
            "fc2": {"w": HFKey("multi_modal_projector.linear_2.weight", "linear"),
                    "b": HFKey("multi_modal_projector.linear_2.bias")},
        }
        return {"vision": vit_key_map(self.cfg.vision_cfg), "projector": proj,
                "language": _prefixed(self.language.hf_key_map(), "language_model.")}
